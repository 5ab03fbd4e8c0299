"""TPC-H tables made on the device from a seed, in the engine's columnar
form: int64 keys and integers, float64 money, int32 days since 1970-01-01,
int32 codes into sorted string dictionaries.

A rewrite of the port's host generator (``repro_torch/data/tpch.py``, a
numpy copy of dbgen's shapes) that keeps its distributions, word lists,
foreign keys and date relations: 4 suppliers per part by the spec's
formula, orders only for customers with ``custkey % 3 != 0`` and keyed
sparsely as dbgen keys them, 1–7 lines an order, ship / commit / receipt dates off the order date, and the comment
patterns Q13 and Q16 probe.  The draws come from a ``torch.Generator`` on
the device, so one seed gives one database, and not the host generator's
values.  Departures from dbgen are listed under ``assumed`` in
``configs/tpch-sf10.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from .encode import Dataset, Draw, ascii_rows, days, digits, padded_render, \
    round2, words_render, words_tokens

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hunter", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
    "accounts", "packages", "requests", "instructions", "foxes", "pinto",
    "beans", "theodolites", "dependencies", "platelets", "ideas", "special",
    "regular", "express", "bold", "final", "pending", "ironic", "even",
    "silent", "unusual", "Customer", "Complaints", "sleep", "haggle", "nag",
    "wake", "cajole", "detect", "integrate", "engage", "above", "against",
]

START = days("1992-01-01")
END = days("1998-08-02")
CURRENTDATE = days("1995-06-17")

def _comments(ds: Dataset, draw: Draw, table: str, column: str, n: int,
              k: int) -> None:
    words = sorted(COMMENT_WORDS)
    ds.add_strings(table, column, words_tokens(draw, n, len(words), k),
                   words_render(words, k), ordered=True)


def _injected_comments(ds: Dataset, draw: Draw, table: str, column: str,
                       n: int, k: int, share_rows: int, prefix: str,
                       suffix: str) -> None:
    """``k``-word comments, ``share_rows`` of them (distinct rows) replaced
    by ``prefix <word> suffix``, the pattern a query probes."""
    words = sorted(COMMENT_WORDS)
    base = len(words) ** k
    tok = words_tokens(draw, n, len(words), k)
    idx = draw.sample(n, share_rows)
    tok[idx] = base + draw.integers(0, len(words), share_rows)
    plain = words_render(words, k)

    def render(t: np.ndarray):
        out = np.empty(len(t), dtype=object)
        low = t < base
        out[low] = plain(t[low])
        out[~low] = [f"{prefix} {words[int(x - base)]} {suffix}"
                     for x in t[~low]]
        return out.astype(str)
    ds.add_strings(table, column, tok, render, ordered=False)


def _phones(ds: Dataset, draw: Draw, table: str, column: str,
            nationkey: torch.Tensor) -> None:
    """``cc-ddd-ddd-dddd`` with ``cc = nationkey + 10``: fixed width, so the
    number ``cc ddd ddd dddd`` sorts as the string does."""
    n = nationkey.numel()
    a = draw.integers(100, 999, n)
    b = draw.integers(100, 999, n)
    c = draw.integers(1000, 9999, n)
    tok = (((nationkey + 10) * 1000 + a) * 1000 + b) * 10000 + c

    def render(t: np.ndarray):
        return ascii_rows([digits(t // 10**10, 2), b"-",
                           digits(t // 10**7 % 1000, 3), b"-",
                           digits(t // 10**4 % 1000, 3), b"-",
                           digits(t % 10**4, 4)])
    ds.add_strings(table, column, tok, render, ordered=True)


def _enum(ds: Dataset, draw: Draw, table: str, column: str, values, n: int,
          idx: torch.Tensor = None) -> None:
    """A column over a fixed value list; ``idx`` (ranks in the sorted list)
    or a uniform draw."""
    ordered = sorted(values)
    if idx is None:
        idx = draw.integers(0, len(ordered), n)
    ds.add_strings(table, column, idx,
                   lambda t: [ordered[int(x)] for x in t], ordered=True)


def _ranks(values) -> torch.Tensor:
    """Map indices into ``values`` to ranks in ``sorted(values)``."""
    srt = sorted(values)
    return torch.tensor([srt.index(v) for v in values], dtype=torch.int64)


def generate(scale_factor: float, seed: int, device) -> Dataset:
    draw = Draw(seed, device)
    dev = draw.device
    sf = scale_factor
    n_supp = max(int(10_000 * sf), 20)
    n_part = max(int(200_000 * sf), 50)
    n_cust = max(int(150_000 * sf), 30)
    n_ord = max(int(1_500_000 * sf), 150)
    ds = Dataset()
    i64 = dict(dtype=torch.int64, device=dev)

    # region / nation
    ds.add("region", "r_regionkey", torch.arange(5, **i64), "numeric")
    _enum(ds, draw, "region", "r_name", REGIONS, 5,
          _ranks(REGIONS).to(dev))
    _comments(ds, draw, "region", "r_comment", 5, 4)
    names = [n for n, _ in NATIONS]
    ds.add("nation", "n_nationkey", torch.arange(25, **i64), "numeric")
    _enum(ds, draw, "nation", "n_name", names, 25, _ranks(names).to(dev))
    ds.add("nation", "n_regionkey",
           torch.tensor([r for _, r in NATIONS], **i64), "numeric")
    _comments(ds, draw, "nation", "n_comment", 25, 4)

    # supplier; n_supp // 200 of them carry Q16's complaint
    sk = torch.arange(1, n_supp + 1, **i64)
    s_nk = draw.integers(0, 25, n_supp)
    ds.add("supplier", "s_suppkey", sk, "numeric")
    ds.add_strings("supplier", "s_name", sk, padded_render("Supplier#", 9),
                   ordered=True)
    _comments(ds, draw, "supplier", "s_address", n_supp, 2)
    ds.add("supplier", "s_nationkey", s_nk, "numeric")
    _phones(ds, draw, "supplier", "s_phone", s_nk)
    ds.add("supplier", "s_acctbal",
           round2(draw.uniform(-999.99, 9999.99, n_supp)), "numeric")
    _injected_comments(ds, draw, "supplier", "s_comment", n_supp, 4,
                       max(n_supp // 200, 2), "take Customer",
                       "Complaints against")

    # part
    pk = torch.arange(1, n_part + 1, **i64)
    ds.add("part", "p_partkey", pk, "numeric")
    pw = sorted(P_WORDS)
    ds.add_strings("part", "p_name", words_tokens(draw, n_part, len(pw), 5),
                   words_render(pw, 5), ordered=True)
    m = draw.integers(1, 6, n_part)
    nn = draw.integers(1, 6, n_part)
    ds.add_strings("part", "p_mfgr", m,
                   lambda t: [f"Manufacturer#{int(x)}" for x in t],
                   ordered=True)
    ds.add_strings("part", "p_brand", m * 10 + nn,
                   lambda t: [f"Brand#{int(x)}" for x in t], ordered=True)
    s1, s2, s3 = sorted(TYPE_S1), sorted(TYPE_S2), sorted(TYPE_S3)
    ttok = ((draw.integers(0, 6, n_part) * 5 + draw.integers(0, 5, n_part)) * 5
            + draw.integers(0, 5, n_part))
    ds.add_strings("part", "p_type", ttok,
                   lambda t: [f"{s1[x // 25]} {s2[x // 5 % 5]} {s3[x % 5]}"
                              for x in t.tolist()], ordered=True)
    ds.add("part", "p_size", draw.integers(1, 51, n_part), "numeric")
    c1, c2 = sorted(CONT_S1), sorted(CONT_S2)
    ctok = draw.integers(0, 5, n_part) * 8 + draw.integers(0, 8, n_part)
    ds.add_strings("part", "p_container", ctok,
                   lambda t: [f"{c1[x // 8]} {c2[x % 8]}" for x in t.tolist()],
                   ordered=True)
    retail = round2((90000 + (pk % 20001).double() / 10
                     + 100 * (pk % 1000).double()) / 100)
    ds.add("part", "p_retailprice", retail, "numeric")
    _comments(ds, draw, "part", "p_comment", n_part, 2)

    # partsupp: 4 distinct suppliers a part (the spec's formula), sorted
    i = torch.arange(4, **i64).repeat_interleave(n_part)
    ps_pk = pk.repeat(4)
    ps_sk = ((ps_pk - 1 + i * (n_supp // 4 + (ps_pk - 1) // n_supp))
             % n_supp) + 1
    order = torch.argsort(ps_pk * (n_supp + 1) + ps_sk)
    ps_pk, ps_sk = ps_pk[order], ps_sk[order]
    n_ps = ps_pk.numel()
    ds.add("partsupp", "ps_partkey", ps_pk, "numeric")
    ds.add("partsupp", "ps_suppkey", ps_sk, "numeric")
    ds.add("partsupp", "ps_availqty", draw.integers(1, 10_000, n_ps), "numeric")
    ds.add("partsupp", "ps_supplycost",
           round2(draw.uniform(1.0, 1000.0, n_ps)), "numeric")
    _comments(ds, draw, "partsupp", "ps_comment", n_ps, 3)
    del i, order

    # customer
    ck = torch.arange(1, n_cust + 1, **i64)
    c_nk = draw.integers(0, 25, n_cust)
    ds.add("customer", "c_custkey", ck, "numeric")
    ds.add_strings("customer", "c_name", ck, padded_render("Customer#", 9),
                   ordered=True)
    _comments(ds, draw, "customer", "c_address", n_cust, 2)
    ds.add("customer", "c_nationkey", c_nk, "numeric")
    _phones(ds, draw, "customer", "c_phone", c_nk)
    ds.add("customer", "c_acctbal",
           round2(draw.uniform(-999.99, 9999.99, n_cust)), "numeric")
    _enum(ds, draw, "customer", "c_mktsegment", SEGMENTS, n_cust)
    _comments(ds, draw, "customer", "c_comment", n_cust, 3)

    # orders: only customers with custkey % 3 != 0 order (the spec); keys
    # sparse as dbgen's mk_sparse makes them: 8 of every 32 (1..7, 32..39,
    # 64..71, ...), so SF10's keys span about 60 M
    i = torch.arange(1, n_ord + 1, **i64)
    ok = ((i >> 3) << 5) | (i & 7)
    del i
    eligible = ck[ck % 3 != 0]
    o_ck = eligible[draw.integers(0, eligible.numel(), n_ord)]
    span = END - START - 151
    o_date = (START + draw.integers(0, span, n_ord)).to(torch.int32)

    # lineitem: 1..7 lines an order
    lines_per = draw.integers(1, 8, n_ord)
    n_li = int(lines_per.sum())
    order_idx = torch.arange(n_ord, **i64).repeat_interleave(lines_per)
    starts = torch.cumsum(lines_per, 0) - lines_per
    l_ln = torch.arange(n_li, **i64) - starts[order_idx] + 1
    l_pk = draw.integers(1, n_part + 1, n_li)
    which = draw.integers(0, 4, n_li)
    l_sk = ((l_pk - 1 + which * (n_supp // 4 + (l_pk - 1) // n_supp))
            % n_supp) + 1
    del which
    qty = draw.integers(1, 51, n_li).double()
    ext = round2(qty * retail[l_pk - 1])
    disc = round2(draw.integers(0, 11, n_li).double() / 100.0)
    tax = round2(draw.integers(0, 9, n_li).double() / 100.0)
    od = o_date[order_idx]
    shipd = od + draw.integers(1, 122, n_li).to(torch.int32)
    commitd = od + draw.integers(30, 91, n_li).to(torch.int32)
    receiptd = shipd + draw.integers(1, 31, n_li).to(torch.int32)
    del od
    rf = sorted(["R", "A", "N"])
    coin = draw.random(n_li) < 0.5
    returnflag = torch.where(
        receiptd <= CURRENTDATE,
        torch.where(coin, rf.index("R"), rf.index("A")),
        rf.index("N")).to(torch.int64)
    del coin
    ls = sorted(["O", "F"])
    late = shipd > CURRENTDATE
    linestatus = torch.where(late, ls.index("O"), ls.index("F")).to(torch.int64)

    # o_totalprice: each order's lines summed in line order (deterministic)
    net = ext * (1 - disc) * (1 + tax)
    grid = torch.zeros(n_ord, 7, dtype=torch.float64, device=dev)
    grid[order_idx, l_ln - 1] = net
    totalprice = round2(grid.sum(1))
    del grid, net
    n_open = torch.zeros(n_ord, **i64).index_add_(0, order_idx, late.long())
    os_ = sorted(["F", "O", "P"])
    status = torch.where(n_open == 0, os_.index("F"),
                         torch.where(n_open == lines_per, os_.index("O"),
                                     os_.index("P"))).to(torch.int64)
    del late, n_open

    ds.add("orders", "o_orderkey", ok, "numeric")
    ds.add("orders", "o_custkey", o_ck, "numeric")
    _enum(ds, draw, "orders", "o_orderstatus", os_, n_ord, status)
    ds.add("orders", "o_totalprice", totalprice, "numeric")
    ds.add("orders", "o_orderdate", o_date, "date")
    _enum(ds, draw, "orders", "o_orderpriority", PRIORITIES, n_ord)
    clerk = draw.integers(1, max(int(1000 * sf), 10) + 1, n_ord)
    ds.add_strings("orders", "o_clerk", clerk, padded_render("Clerk#", 9),
                   ordered=True)
    ds.add("orders", "o_shippriority", torch.zeros(n_ord, **i64), "numeric")
    _injected_comments(ds, draw, "orders", "o_comment", n_ord, 3,
                       max(n_ord // 100, 3), "handle special",
                       "requests carefully")
    del status, clerk

    ds.add("lineitem", "l_orderkey", ok[order_idx], "numeric")
    del order_idx
    ds.add("lineitem", "l_partkey", l_pk, "numeric")
    ds.add("lineitem", "l_suppkey", l_sk, "numeric")
    ds.add("lineitem", "l_linenumber", l_ln, "numeric")
    ds.add("lineitem", "l_quantity", qty, "numeric")
    ds.add("lineitem", "l_extendedprice", ext, "numeric")
    ds.add("lineitem", "l_discount", disc, "numeric")
    ds.add("lineitem", "l_tax", tax, "numeric")
    _enum(ds, draw, "lineitem", "l_returnflag", rf, n_li, returnflag)
    _enum(ds, draw, "lineitem", "l_linestatus", ls, n_li, linestatus)
    del returnflag, linestatus
    ds.add("lineitem", "l_shipdate", shipd, "date")
    ds.add("lineitem", "l_commitdate", commitd, "date")
    ds.add("lineitem", "l_receiptdate", receiptd, "date")
    _enum(ds, draw, "lineitem", "l_shipinstruct", INSTRUCTS, n_li)
    _enum(ds, draw, "lineitem", "l_shipmode", SHIPMODES, n_li)
    _comments(ds, draw, "lineitem", "l_comment", n_li, 2)
    return ds
