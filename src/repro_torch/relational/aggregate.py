"""Group-by aggregation — counterpart of ``repro/relational/aggregate.py``.

Factorize the group keys on the device (a dense count over the key product
space when it is small, else a lexsort), then segment reductions.  No
column goes to the host; the syncs are the scalar key bounds and the group
count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.instrument import pull_scalar
from ..kernels.ops import compact
from .expressions import Expr, evaluate
from .sort import lexsort
from .table import NUMERIC, STRING, Column, Table


@dataclasses.dataclass
class AggSpec:
    """One output aggregate: fn in sum|avg|count|count_star|min|max|count_distinct."""

    fn: str
    expr: Optional[Expr]  # None for count_star
    name: str


def _factorize_core(arrs: Sequence[torch.Tensor]):
    """Lexsort-based exact factorization → (gids, rep rows, group count)."""
    n = arrs[0].shape[0]
    order = lexsort(arrs)
    # a group starts at the first row and wherever a key changes (built
    # by concatenation: a scalar store would copy from the host, which a
    # CUDA graph capture refuses)
    diff = torch.zeros(n - 1, dtype=torch.bool, device=arrs[0].device)
    for a in arrs:
        s = a[order]
        diff |= s[1:] != s[:-1]
    changed = torch.cat([torch.ones(1, dtype=torch.bool, device=diff.device),
                         diff])
    gid_sorted = torch.cumsum(changed.to(torch.int64), 0) - 1
    gids = torch.zeros(n, dtype=torch.int64, device=changed.device)
    gids[order] = gid_sorted
    # first row of each group in gid order; the tail beyond the group count
    # is filler and sliced off by the caller
    rep = order[compact(changed)[0]]
    return gids, rep, changed.sum()


# dense-domain factorization: count over the key product space instead of
# sorting.  The domain is capped relative to the row count: the accumulator
# arrays are domain-sized, so a domain far beyond n costs more than the sort
# it avoids.
_DENSE_DOMAIN_LIMIT = 1 << 21


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                segments=None) -> torch.Tensor:
    """Per-segment sums.  On the card, floating-point data are summed by
    ``fixed_point_segment_sum``, whose result does not depend on the order
    of addition: float atomics add in whatever order the card runs them,
    and two computations of one sum (Q15's revenue, and the maximum of it
    its scalar subquery takes) must agree to the bit, as they do on the
    reference's TPU and on the CPU.  Integers are exact in any order, and
    the CPU adds in row order, so both keep ``index_add_``.  ``segments``
    is ``sorted_segments(ids, n)`` where the caller has it."""
    if data.is_cuda and data.dtype.is_floating_point:
        return fixed_point_segment_sum(data, ids, n, segments)
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)


def sorted_segments(ids: torch.Tensor, n: int):
    """(row order sorted by segment id, start and end of each of the ``n``
    segments in that order), found by sort and binary search: no atomics."""
    sorted_ids, order = torch.sort(ids)
    g = torch.arange(n, device=ids.device, dtype=ids.dtype)
    return (order, torch.searchsorted(sorted_ids, g),
            torch.searchsorted(sorted_ids, g, right=True))


def _int_segment_sum(v: torch.Tensor, segments) -> torch.Tensor:
    """Exact per-segment sums of int64 ``v`` by a prefix sum over the rows
    in segment order (integer addition gives one answer in any order)."""
    order, starts, ends = segments
    c = torch.cumsum(v[order], 0)
    c = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device), c])
    return c[ends] - c[starts]


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e (float64, exact) for integer tensors e in [-1022, 1023]."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_point_segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                            segments=None) -> torch.Tensor:
    """Per-segment float sums (1-d ``data``) that do not depend on the order
    of addition.

    Each finite value is scaled by a power of two (chosen on the device
    from the largest magnitude and the row count, so that no sum can
    overflow) and split into an integer part and a fraction carried to
    62 - log2(rows) more bits; both are summed exactly as int64 and
    recombined in float64.  An integer-valued column sums exactly;
    otherwise the per-row error is far below float64's own.  NaNs and
    infinities are counted apart per segment and set the result as IEEE
    addition would (NaN, or +inf and -inf together, give NaN)."""
    device = data.device
    rows = data.shape[0]
    if rows == 0:
        return torch.zeros(n, dtype=data.dtype, device=device)
    if segments is None:
        segments = sorted_segments(ids, n)
    x = data.to(torch.float64)
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, 0.0)
    k = 62 - max(int(rows).bit_length(), 1)   # |scaled| < 2^k, rows < 2^(62-k)
    top = torch.frexp(xf.abs().max()).exponent   # max |x| < 2^top
    shift = torch.clamp(k - top, -1000, 1000)
    q = xf * _pow2(shift)
    whole = torch.floor(q)
    frac = torch.round((q - whole) * 2.0 ** k)
    total = ((_int_segment_sum(whole.to(torch.int64), segments).to(torch.float64)
              + _int_segment_sum(frac.to(torch.int64), segments).to(torch.float64)
              * 2.0 ** -k) * _pow2(-shift))
    nan_pinf = _int_segment_sum(torch.isnan(x).to(torch.int64)
                                + (torch.isposinf(x).to(torch.int64) << 32),
                                segments)
    ninf = _int_segment_sum(torch.isneginf(x).to(torch.int64), segments)
    nan, pinf = (nan_pinf & 0xFFFFFFFF) > 0, (nan_pinf >> 32) > 0
    ninf = ninf > 0
    total = torch.where(pinf, float("inf"), total)
    total = torch.where(ninf, float("-inf"), total)
    total = torch.where(nan | (pinf & ninf), float("nan"), total)
    return total.to(data.dtype)


def segment_reduce(fn: str, data: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """min or max per segment; every segment must be non-empty."""
    out = torch.zeros(n, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids, data, "amin" if fn == "min" else "amax",
                               include_self=False)


def _first_rows(packed: torch.Tensor, domain: int) -> torch.Tensor:
    """Smallest row index per packed value (n where the value is absent)."""
    n = packed.shape[0]
    rows = torch.arange(n, device=packed.device)
    first = torch.full((domain,), n, dtype=torch.int64, device=packed.device)
    return first.scatter_reduce_(0, packed, rows, "amin", include_self=True)


def _group_key_arrays(table: Table, keys: Sequence[str]):
    arrs = [table[k].data for k in keys]
    return [a if a.dtype.is_floating_point else a.to(torch.int64) for a in arrs]


def _dense_pack(arrs, n: int):
    """Pack int key columns into one dense id → (packed, domain) or None.

    One scalar pull pair per key decides eligibility."""
    if any(a.dtype.is_floating_point for a in arrs):
        return None
    limit = min(_DENSE_DOMAIN_LIMIT, max(1024, 4 * n))
    los = [pull_scalar(a.min()) for a in arrs]
    cards = [pull_scalar(a.max()) - lo + 1 for a, lo in zip(arrs, los)]
    domain = 1
    for card in cards:
        domain *= card
        if domain > limit:
            return None
    packed = arrs[0] - los[0]
    for a, lo, card in zip(arrs[1:], los[1:], cards[1:]):
        packed = packed * card + (a - lo)
    # on a plan-cache replay the bounds are the recorded ones: should the
    # data have moved under them, the replay's flags discard the result,
    # but the scatters below must stay in range meanwhile (an index out of
    # range is a device-side assert on the card)
    return torch.clamp(packed, 0, domain - 1), domain


def _dense_factorize(packed: torch.Tensor, domain: int):
    n = packed.shape[0]
    counts = segment_sum(torch.ones(n, dtype=torch.int32, device=packed.device),
                         packed, domain)
    present = counts > 0
    mapping = torch.cumsum(present.to(torch.int64), 0) - 1
    gids = mapping[packed]
    # representative row per present packed value, ascending (= lex) order
    rep = _first_rows(packed, domain)[compact(present)[0]]
    return gids, rep, present.sum()


def factorize_groups(table: Table, keys: Sequence[str]) -> Tuple[torch.Tensor, Table]:
    """→ (group id per row on device, unique-key Table in group-id order)."""
    n = table.num_rows
    device = table.device
    if not keys:
        return torch.zeros(n, dtype=torch.int64, device=device), Table({})
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, Table({k: table[k].take(empty) for k in keys})
    arrs = _group_key_arrays(table, keys)

    dense = _dense_pack(arrs, n)
    if dense is not None:
        gids, rep, n_groups = _dense_factorize(*dense)
    else:
        gids, rep, n_groups = _factorize_core(arrs)
    n_groups = pull_scalar(n_groups)       # the factorization's scalar pull
    uniq = Table({k: table[k].take(rep[:n_groups]) for k in keys})
    # in range even under a stale recording (see _dense_pack)
    return torch.clamp(gids, max=n_groups - 1), uniq


def _count_distinct(gids: torch.Tensor, vals: torch.Tensor, n_groups: int):
    """Sort (gid, value) pairs, count run starts per group."""
    n = gids.shape[0]
    order = lexsort([gids, vals])
    g_s, v_s = gids[order], vals[order]
    first = torch.ones(n, dtype=torch.bool, device=gids.device)
    if n > 1:
        first[1:] = (g_s[1:] != g_s[:-1]) | (v_s[1:] != v_s[:-1])
    return segment_sum(first.to(torch.int64), g_s, n_groups)


def _segment(fn: str, data: torch.Tensor, gids: torch.Tensor, n: int,
             segments=None) -> torch.Tensor:
    if fn == "sum":
        return segment_sum(data, gids, n, segments)
    if fn in ("min", "max"):
        return segment_reduce(fn, data, gids, n)
    raise ValueError(fn)


def _reduce_all(gids, datas, fns: Sequence[str], n_groups: int):
    """Every segment reduction of one group-by → (counts f64, outputs)."""
    ones = torch.ones(gids.shape[0], dtype=torch.float64, device=gids.device)
    # on the card one sort of the group ids serves every float sum
    segments = sorted_segments(gids, n_groups) if gids.is_cuda else None
    counts = segment_sum(ones, gids, n_groups, segments)
    outs = []
    for fn, data in zip(fns, datas):
        if fn == "avg":
            s = segment_sum(data.to(torch.float64), gids, n_groups, segments)
            outs.append(s / torch.clamp(counts, min=1.0))
        else:
            outs.append(_segment(fn, data, gids, n_groups, segments))
    return counts, outs


def group_aggregate(
    table: Table, keys: Sequence[str], aggs: Sequence[AggSpec]
) -> Table:
    """Eager hash aggregate (fully device-resident)."""
    n = table.num_rows
    device = table.device
    if n == 0 and keys:
        # empty input with keys: zero groups
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return Table({**{k: table[k].take(empty) for k in keys},
                      **{a.name: Column(torch.zeros(0, dtype=torch.float64,
                                                    device=device))
                         for a in aggs}})

    ones = torch.ones(n, dtype=torch.int64, device=device)
    fns: List[str] = []
    datas: List[torch.Tensor] = []
    meta: List[Optional[Tuple[str, str, Optional[np.ndarray]]]] = []
    distincts: List[Tuple[str, torch.Tensor]] = []
    for a in aggs:
        if a.fn == "count_star":
            fns.append("sum"); datas.append(ones)
            meta.append((a.name, NUMERIC, None))
            continue
        col = evaluate(a.expr, table)
        if a.fn == "count":
            fns.append("sum"); datas.append(ones)
            meta.append((a.name, NUMERIC, None))
        elif a.fn in ("sum", "min", "max"):
            data = col.data
            if a.fn == "sum" and data.dtype == torch.bool:
                data = data.to(torch.int64)
            if a.fn == "sum" and data.dtype == torch.float32:
                data = data.to(torch.float64)
            fns.append(a.fn); datas.append(data)
            kind = col.kind if a.fn in ("min", "max") else NUMERIC
            meta.append((a.name, kind,
                         col.dictionary if kind == STRING else None))
        elif a.fn == "avg":
            fns.append("avg"); datas.append(col.data)
            meta.append((a.name, NUMERIC, None))
        elif a.fn == "count_distinct":
            distincts.append((a.name, col.data))
            meta.append(None)
        else:
            raise ValueError(f"unknown aggregate {a.fn}")

    arrs = _group_key_arrays(table, keys) if keys and n else None
    dense = _dense_pack(arrs, n) if arrs is not None and not distincts else None
    if dense is not None:
        # dense keys: reduce straight over the packed domain, then keep the
        # present groups (ascending packed value = lexicographic order)
        packed, domain = dense
        counts, outs = _reduce_all(packed, datas, fns, domain)
        present = counts > 0
        k = pull_scalar(present.sum())
        sel = compact(present)[0][:k]
        rep_idx = _first_rows(packed, domain)[sel]
        uniq = Table({key: table[key].take(rep_idx) for key in keys})
        results = [r[sel] for r in outs]
        gids = None
        n_groups = k
    else:
        if arrs is not None:
            gids, rep, ng = _factorize_core(arrs)
            n_groups = pull_scalar(ng)
            # in range even under a stale recording (see _dense_pack)
            gids = torch.clamp(gids, max=n_groups - 1)
            uniq = Table({key: table[key].take(rep[:n_groups])
                          for key in keys})
        else:
            gids = torch.zeros(n, dtype=torch.int64, device=device)
            uniq = Table({})
            n_groups = 1
        _, results = _reduce_all(gids, datas, fns, n_groups)

    out: Dict[str, Column] = {}
    it = iter(results)
    for m in meta:
        if m is None:
            continue
        name, kind, dictionary = m
        out[name] = Column(next(it), kind, dictionary)
    for name, vals in distincts:
        out[name] = Column(_count_distinct(gids, vals, n_groups), NUMERIC)
    # preserve the requested output column order
    return Table({**uniq.columns, **{a.name: out[a.name] for a in aggs}})
