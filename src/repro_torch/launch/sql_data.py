"""Seeded data for the SQL fragments of ``sql_dryrun.py``, and the plain
global answers they are held to.

The data follow dbgen's column domains: dense customer keys, sparse order
keys (8 of every 32), 1–7 lines an order, order dates over 1992-01-01 ..
1998-08-02 and ``l_shipdate = o_orderdate + 1..121``, discounts 0.00–0.10,
taxes 0.00–0.08, quantities 1–50, five market segments.  Each shard's
rows sit contiguously in its ``cap`` rows, padded with ``valid = False``;
each order sits on its customer's shard (the fragment's semi join is
shard-local), as its lines do on its own.  A shard's lines past its
lineitem cap are not made.

The plain answers are computed over all shards at once, in float64 with
int64 keys, with hashes written out here again rather than taken from the
code under test: Q1's 9 x 6 sums; Q3's overflow (the rows past their
shuffle buckets, counted over every shard and stage), the Bloom filter's
pass fraction, and each shard's orders with their revenue.  ``hold_q1``
and ``hold_q3`` hold a fragment's result to them.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..relational.table import date_to_days
from .sql_dryrun import (
    Q1_CUTOFF, Q1_GROUPS, Q3_BLOOM_BITS, Q3_CUTOFF, Q3_SEGMENT, rows,
)

START_DATE = date_to_days("1992-01-01")
LAST_ORDER_DATE = date_to_days("1998-08-02")
CURRENT_DATE = date_to_days("1995-06-17")
SEGMENTS = 5
MIX64 = -7046029254386353131
BLOOM_MIX = (-7046029254386353131, -4417276706812531889)
BLOOM_HASHES = 7


def _split(total: int, n: int, device) -> torch.Tensor:
    """Rows of each of ``n`` shards when ``total`` rows are dealt out."""
    s = torch.arange(n, device=device)
    return total // n + (s < total % n).to(torch.int64)


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def _randint(g, lo: int, hi: int, shape, device) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g, device=device)


def _money(g, shape, device) -> torch.Tensor:
    """l_extendedprice: quantity 1–50 times a retail price 900.00–2098.99,
    in cents."""
    cents = (_randint(g, 1, 51, shape, device)
             * _randint(g, 90_000, 209_900, shape, device))
    return (cents.to(torch.float64) / 100.0).to(torch.float32)


def q3_data(extra: dict, sf: float, seed: int, compress: bool = False,
            device=None):
    """Inputs of ``build_q3_fragment`` (its ``extra``) at scale ``sf``:
    ``(lcols, lvalid, ocols, ovalid, ccols, cvalid)`` on ``device`` (the
    card when None), made from ``seed``."""
    device = torch.device("cuda" if device is None else device)
    g = torch.Generator(device=device).manual_seed(seed)
    n, caps = extra["n_shards"], extra["caps"]
    total = rows(sf)
    key_t = torch.int32 if compress else torch.int64
    code_t = torch.int8 if compress else torch.int32

    # customers: dense keys, each shard a block of them
    c_rows = _split(total["customer"], n, device)
    c_off = _offsets(c_rows)
    j = torch.arange(caps["customer"], device=device).expand(n, -1)
    cvalid = j < c_rows.unsqueeze(1)
    c_custkey = torch.where(cvalid, c_off.unsqueeze(1) + j + 1, 0)
    c_seg = _randint(g, 0, SEGMENTS, (n, caps["customer"]), device)
    ccols = {"c_custkey": c_custkey.to(key_t),
             "c_mktsegment": torch.where(cvalid, c_seg, -1).to(code_t)}

    # orders: dbgen's sparse keys, a customer of the same shard
    o_rows = _split(total["orders"], n, device)
    j = torch.arange(caps["orders"], device=device).expand(n, -1)
    ovalid = j < o_rows.unsqueeze(1)
    gidx = _offsets(o_rows).unsqueeze(1) + j
    o_orderkey = torch.where(ovalid, (gidx // 8) * 32 + gidx % 8 + 1, 0)
    pick = (torch.rand((n, caps["orders"]), generator=g, device=device,
                       dtype=torch.float64) * c_rows.unsqueeze(1)).long()
    o_custkey = torch.where(ovalid, c_off.unsqueeze(1) + pick + 1, 0)
    o_orderdate = torch.where(
        ovalid, _randint(g, START_DATE, LAST_ORDER_DATE + 1,
                         (n, caps["orders"]), device), 0).to(torch.int32)
    ocols = {"o_orderkey": o_orderkey.to(key_t),
             "o_custkey": o_custkey.to(key_t),
             "o_orderdate": o_orderdate,
             "o_shippriority": torch.zeros_like(o_orderdate, dtype=code_t)}

    # lines: 1–7 an order, on the order's shard, in order
    per_order = torch.where(ovalid, _randint(g, 1, 8, (n, caps["orders"]),
                                             device), 0)
    ends = torch.cumsum(per_order, 1)
    slot = torch.arange(caps["lineitem"], device=device).expand(n, -1)
    owner = torch.clamp(torch.searchsorted(ends, slot.contiguous(),
                                           right=True),
                        max=caps["orders"] - 1)
    lvalid = slot < ends[:, -1:]
    shape = (n, caps["lineitem"])
    ship = (torch.gather(o_orderdate, 1, owner)
            + _randint(g, 1, 122, shape, device).to(torch.int32))
    disc = _randint(g, 0, 11, shape, device)
    lcols = {
        "l_orderkey": torch.where(lvalid, torch.gather(o_orderkey, 1, owner),
                                  0).to(key_t),
        "l_extendedprice": torch.where(lvalid, _money(g, shape, device), 0.0),
        "l_discount": (torch.where(lvalid, disc, 0).to(torch.uint8)
                       if compress else
                       torch.where(lvalid, disc.to(torch.float32) * 0.01, 0.0)),
        "l_shipdate": torch.where(lvalid, ship, 0).to(torch.int32)}
    return lcols, lvalid, ocols, ovalid, ccols, cvalid


def q1_data(extra: dict, sf: float, seed: int, device=None):
    """Inputs of ``build_q1_fragment`` at scale ``sf``: ``(cols, valid)``."""
    device = torch.device("cuda" if device is None else device)
    g = torch.Generator(device=device).manual_seed(seed)
    n, cap = extra["n_shards"], extra["cap"]
    l_rows = _split(rows(sf)["lineitem"], n, device)
    shape = (n, cap)
    valid = torch.arange(cap, device=device).expand(n, -1) < l_rows.unsqueeze(1)
    order_date = _randint(g, START_DATE, LAST_ORDER_DATE + 1, shape, device)
    ship = order_date + _randint(g, 1, 122, shape, device)
    receipt = ship + _randint(g, 1, 31, shape, device)
    # dbgen: R or A once received by the current date, else N; O while
    # not shipped by it, else F (codes in dictionary order A N R, F O)
    flag = torch.where(receipt <= CURRENT_DATE,
                       2 * _randint(g, 0, 2, shape, device), 1)
    status = (ship > CURRENT_DATE).to(torch.int64)

    def real(t, dtype):
        return torch.where(valid, t, 0).to(dtype)

    cols = {"l_shipdate": real(ship, torch.int32),
            "l_returnflag": real(flag, torch.int32),
            "l_linestatus": real(status, torch.int32),
            "l_quantity": real(_randint(g, 1, 51, shape, device),
                               torch.float32),
            "l_extendedprice": real(_money(g, shape, device), torch.float32),
            "l_discount": real(_randint(g, 0, 11, shape, device) * 0.01,
                               torch.float32),
            "l_tax": real(_randint(g, 0, 9, shape, device) * 0.01,
                          torch.float32)}
    return cols, valid


# ---------------------------------------------------------------------------
# plain global answers
# ---------------------------------------------------------------------------


def plain_q1(cols: dict, valid: torch.Tensor) -> torch.Tensor:
    """Q1's ``(9, 6)`` sums over every shard's rows, in float64."""
    mask = (valid & (cols["l_shipdate"] <= Q1_CUTOFF)).reshape(-1)
    gid = (cols["l_returnflag"] * 3 + cols["l_linestatus"]).reshape(-1)[mask]

    def f64(name):
        return cols[name].reshape(-1)[mask].to(torch.float64)

    ext, disc = f64("l_extendedprice"), f64("l_discount")
    disc_price = ext * (1.0 - disc)
    vals = torch.stack([f64("l_quantity"), ext, disc_price,
                        disc_price * (1.0 + f64("l_tax")), disc,
                        torch.ones_like(ext)], 1)
    out = torch.zeros((Q1_GROUPS, 6), dtype=torch.float64, device=ext.device)
    return out.index_add_(0, gid.long(), vals)


def _dest(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The shard a key hashes to: ``h = key * MIX64`` (wrapping),
    ``h ^= h >> 33``, ``h mod n``."""
    h = keys.to(torch.int64) * MIX64
    return torch.remainder((h >> 33) ^ h, n)


def _ranks(group: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Each row's rank within its group, the rows taken in ``seq`` order."""
    order = torch.argsort(group * (int(seq.max()) + 1) + seq)
    g_sorted = group[order]
    rank = torch.empty_like(order)
    rank[order] = (torch.arange(order.numel(), device=order.device)
                   - torch.searchsorted(g_sorted, g_sorted))
    return rank


def _buckets(src: torch.Tensor, dest: torch.Tensor, n_dest: int, cap: int,
             seq: torch.Tensor):
    """Rows from shard ``src`` to ``dest`` (of ``n_dest``) into buckets of
    ``cap``: → (kept, rows past their buckets)."""
    group = src * n_dest + dest
    kept = _ranks(group, seq) < cap
    return kept, int(torch.clamp(torch.bincount(group) - cap, min=0).sum())


def _shuffle_plain(keys: torch.Tensor, src: torch.Tensor, pods: int,
                   data: int, caps) -> tuple:
    """The rows that reach their final shard, and the rows dropped, of a
    flat shuffle over ``data`` shards (``pods == 1``; ``caps = (out,)``)
    or a pod-aware one (``caps = (pod, out)``); rows given in row order."""
    n = pods * data
    final = _dest(keys, n)
    seq = torch.arange(keys.numel(), device=keys.device)
    if pods == 1:
        kept, over = _buckets(src, final, n, caps[-1], seq)
        return kept, over
    kept1, over1 = _buckets(src, final // data, pods, caps[0], seq)
    # rows arrive at (their pod, the sender's data index), ordered by the
    # sending pod, then by row
    at = (final // data) * data + src % data
    seq2 = (src // data) * keys.numel() + seq
    kept2, over2 = _buckets(at[kept1], final[kept1] % data, data, caps[1],
                            seq2[kept1])
    kept = kept1.clone()
    kept[kept1] = kept2
    return kept, over1 + over2


def _bloom_bits(keys: torch.Tensor) -> torch.Tensor:
    h1, h2 = ((lambda h: h ^ (h >> 31))(keys.to(torch.int64) * m)
              for m in BLOOM_MIX)
    h2 = h2 | 1
    return torch.stack([torch.remainder(h1 + i * h2, Q3_BLOOM_BITS)
                        for i in range(BLOOM_HASHES)])


def plain_q3(data, extra: dict, pods: int, predicate_transfer: bool) -> Dict:
    """Q3's plain answer over every shard of a ``pods`` x (n / pods) mesh:
    ``overflow`` (rows past their buckets, over both shuffles and every
    stage and shard), ``bloom_pass`` (the share of the date-filtered lines
    the Bloom filter lets through, with predicate transfer), and each
    order that joins with its revenue, date, priority and final shard
    (``orders``)."""
    lcols, lvalid, ocols, ovalid, ccols, cvalid = data
    n = extra["n_shards"]
    data_n = n // pods
    bucket = {t: (extra["shuffle_out_caps"][t],) if pods == 1 else
              (extra["pod_caps"][t], extra["shuffle_out_caps"][t])
              for t in ("orders", "lineitem")}
    dev = lvalid.device

    def flat(t):
        return t.reshape(-1)

    shard_of = {t: torch.arange(n, device=dev).repeat_interleave(c)
                for t, c in extra["caps"].items()}
    # customers of the segment (keys are dense from 1)
    ckey = flat(ccols["c_custkey"]).long()
    chosen = torch.zeros(int(ckey.max()) + 2, dtype=torch.bool, device=dev)
    chosen[ckey[flat(cvalid) & (flat(ccols["c_mktsegment"]) == Q3_SEGMENT)]] = True
    omask = (flat(ovalid) & (flat(ocols["o_orderdate"]) < Q3_CUTOFF)
             & chosen[flat(ocols["o_custkey"]).long()])
    okey = flat(ocols["o_orderkey"]).long()[omask]
    o_kept, o_over = _shuffle_plain(okey, shard_of["orders"][omask], pods,
                                    data_n, bucket["orders"])
    lmask = flat(lvalid) & (flat(lcols["l_shipdate"]) > Q3_CUTOFF)
    out = {"bloom_pass": None}
    if predicate_transfer:
        bits = torch.zeros(Q3_BLOOM_BITS, dtype=torch.bool, device=dev)
        bits[_bloom_bits(okey[o_kept]).reshape(-1)] = True
        hit = bits[_bloom_bits(flat(lcols["l_orderkey"]))].all(0)
        out["bloom_pass"] = float(hit[lmask].double().mean())
        lmask = lmask & hit
    lkey = flat(lcols["l_orderkey"]).long()[lmask]
    l_kept, l_over = _shuffle_plain(lkey, shard_of["lineitem"][lmask], pods,
                                    data_n, bucket["lineitem"])
    out["overflow"] = o_over + l_over
    # revenue of every order that joins (int64 keys, float64 sums)
    ext = flat(lcols["l_extendedprice"])[lmask].to(torch.float64)
    disc = flat(lcols["l_discount"])[lmask].to(torch.float64)
    if lcols["l_discount"].dtype == torch.uint8:
        disc = disc * 0.01
    sorted_keys, at = torch.sort(okey)
    pos = torch.clamp(torch.searchsorted(sorted_keys, lkey), max=okey.numel() - 1)
    joins = sorted_keys[pos] == lkey
    revenue = torch.zeros(okey.numel(), dtype=torch.float64, device=dev)
    revenue.index_add_(0, at[pos[joins]], (ext * (1.0 - disc))[joins])
    lines = torch.bincount(at[pos[joins]], minlength=okey.numel())
    has = lines > 0
    out["orders"] = {
        "key": okey[has], "revenue": revenue[has],
        "o_orderdate": flat(ocols["o_orderdate"])[omask][has],
        "o_shippriority": flat(ocols["o_shippriority"])[omask][has],
        "shard": _dest(okey[has], n)}
    return out



def hold_q1(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """Q1's float32 sums against the plain float64 ones, each within
    ``rtol`` of it → the largest relative error."""
    err = float(((got.double() - want).abs()
                 / want.abs().clamp(min=1e-300)).max())
    if not (got.shape == want.shape and err <= rtol):
        raise AssertionError(f"Q1 sums off by {err:.3e} (limit {rtol})")
    return err


def hold_q3(got, plain: Dict, n_shards: int, rtol: float) -> float:
    """Each shard's top-10 against the plain answer for the keys hashed to
    it: the revenues position by position within ``rtol``, every returned
    key the plain revenue it came with (so the keys are exact but for ties
    at the tenth revenue), dates and priorities exactly → the largest
    relative revenue error."""
    key, revenue, odate, prio, valid, _ = got
    orders = plain["orders"]
    by_key = torch.argsort(orders["key"])
    sorted_keys = orders["key"][by_key]
    worst = 0.0

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-300)).max()) \
            if a.numel() else 0.0

    for s in range(n_shards):
        mine = orders["shard"] == s
        want = torch.sort(orders["revenue"][mine], descending=True).values
        k = int(valid[s].sum())
        if k != min(10, int(mine.sum())) or not bool(valid[s, :k].all()):
            raise AssertionError(f"Q3 shard {s}: {k} rows, plain "
                                 f"{int(mine.sum())} orders")
        rev = revenue[s, :k].double()
        at = by_key[torch.clamp(torch.searchsorted(
            sorted_keys, key[s, :k].long()), max=sorted_keys.numel() - 1)]
        if not torch.equal(orders["key"][at], key[s, :k].long()):
            raise AssertionError(f"Q3 shard {s}: a key no order has")
        err = max(rel(rev, want[:k]), rel(rev, orders["revenue"][at]))
        if err > rtol:
            raise AssertionError(f"Q3 shard {s}: revenue off by {err:.3e} "
                                 f"(limit {rtol})")
        if not (torch.equal(orders["o_orderdate"][at], odate[s, :k])
                and torch.equal(orders["o_shippriority"][at].to(prio.dtype),
                                prio[s, :k])):
            raise AssertionError(f"Q3 shard {s}: dates or priorities differ")
        worst = max(worst, err)
    return worst
