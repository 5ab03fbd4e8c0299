"""Pure-numpy host engine — counterpart of ``repro/core/fallback.py``.

Two roles, as in the reference:
  1. the **host fallback** of the paper (§3.2.2): the hybrid router
     (``substrait.router``) runs the plan fragments the device engine cannot
     own here, and ``run_sql`` runs SQL text on a host-format database;
  2. an **oracle** independent of the device engine: Python strings,
     ``datetime64`` dates, no dictionary encoding, no torch.

Tables are plain ``dict[str, np.ndarray]`` — the "host database format" that
the buffer manager deep-copies from (§3.2.3).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..relational.aggregate import AggSpec
from ..relational.expressions import (
    Between, BinOp, Case, Cast, Col, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp,
)
from ..relational.strings import like_to_regex
from ..relational.table import DATE
from .plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SetRel, SortRel, WindowRel,
)

_EPOCH = np.datetime64("1970-01-01", "D")
HostTable = Dict[str, np.ndarray]


def _num_rows(t: HostTable) -> int:
    return len(next(iter(t.values()))) if t else 0


def _take(t: HostTable, idx: np.ndarray) -> HostTable:
    return {k: v[idx] for k, v in t.items()}


# ---------------------------------------------------------------------------
# numpy expression evaluation
# ---------------------------------------------------------------------------

_ARITH = {"+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide}
_CMP = {"==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
        ">": np.greater, ">=": np.greater_equal}


def np_eval(expr: Expr, t: HostTable, engine: "FallbackEngine" = None) -> np.ndarray:
    if isinstance(expr, Col):
        return t[expr.name]
    if isinstance(expr, ScalarSubquery):
        sub = engine.execute(expr.plan)
        return np.full(_num_rows(t), sub[expr.column][0])
    if isinstance(expr, Lit):
        v = expr.value
        if expr.kind == DATE:
            v = _EPOCH + np.timedelta64(int(v), "D")
        return np.full(_num_rows(t), v)
    if isinstance(expr, BinOp):
        if expr.op in ("and", "or"):
            l = np_eval(expr.left, t, engine)
            r = np_eval(expr.right, t, engine)
            return np.logical_and(l, r) if expr.op == "and" else np.logical_or(l, r)
        l = np_eval(expr.left, t, engine)
        r = np_eval(expr.right, t, engine)
        if expr.op in _CMP:
            if l.dtype.kind in "UO" or (hasattr(r, "dtype") and
                                        getattr(r, "dtype", None) is not None
                                        and np.asarray(r).dtype.kind in "UO"):
                l = np.asarray(l, dtype="U")
                r = np.asarray(r, dtype="U")
            return _CMP[expr.op](l, r)
        if expr.op == "/":
            return np.divide(np.asarray(l, np.float64), np.asarray(r, np.float64))
        if l.dtype.kind == "M" and np.asarray(r).dtype.kind == "M":
            return (l - r).astype("timedelta64[D]").astype(np.int64)
        return _ARITH[expr.op](l, r)
    if isinstance(expr, UnOp):
        v = np_eval(expr.operand, t, engine)
        return np.logical_not(v) if expr.op == "not" else -v
    if isinstance(expr, Between):
        v = np_eval(expr.operand, t, engine)
        lo = np_eval(expr.lo, t, engine)
        hi = np_eval(expr.hi, t, engine)
        return (v >= lo) & (v <= hi)
    if isinstance(expr, InList):
        v = np_eval(expr.operand, t, engine)
        if v.dtype.kind in "UO":
            hit = np.isin(np.asarray(v, dtype="U"),
                          np.asarray(list(expr.values), dtype="U"))
        else:
            hit = np.isin(v, list(expr.values))
        return ~hit if expr.negate else hit
    if isinstance(expr, Like):
        v = np.asarray(np_eval(expr.operand, t, engine), dtype="U")
        rx = like_to_regex(expr.pattern)
        hit = np.fromiter((rx.match(s) is not None for s in v), bool, len(v))
        return ~hit if expr.negate else hit
    if isinstance(expr, StartsWith):
        v = np.asarray(np_eval(expr.operand, t, engine), dtype="U")
        hit = np.char.startswith(v, expr.prefix)
        return ~hit if expr.negate else hit
    if isinstance(expr, Case):
        default = np_eval(expr.default, t, engine)
        conds = [np_eval(c, t, engine) for c, _ in expr.whens]
        vals = [np_eval(v, t, engine) for _, v in expr.whens]
        return np.select(conds, vals, default)
    if isinstance(expr, ExtractYear):
        v = np_eval(expr.operand, t, engine)
        return v.astype("datetime64[Y]").astype(np.int64) + 1970
    if isinstance(expr, Substr):
        v = np.asarray(np_eval(expr.operand, t, engine), dtype="U")
        return np.asarray([s[expr.start - 1: expr.start - 1 + expr.length] for s in v])
    if isinstance(expr, Cast):
        return np_eval(expr.operand, t, engine).astype(expr.dtype)
    raise TypeError(f"np_eval: {type(expr)}")


# ---------------------------------------------------------------------------
# join / aggregate on host tables
# ---------------------------------------------------------------------------


def _factorize_pair(l: np.ndarray, r: np.ndarray):
    if l.dtype.kind in "UOM" or r.dtype.kind in "UOM":
        both = np.concatenate([np.asarray(l, "U"), np.asarray(r, "U")]) \
            if l.dtype.kind in "UO" else np.concatenate([l, r])
        uni, inv = np.unique(both, return_inverse=True)
        return inv[: len(l)].astype(np.int64), inv[len(l):].astype(np.int64)
    return l.astype(np.int64), r.astype(np.int64)


def _pack_keys(lcols: List[np.ndarray], rcols: List[np.ndarray]):
    lk, rk = _factorize_pair(lcols[0], rcols[0])
    for lc, rc in zip(lcols[1:], rcols[1:]):
        l2, r2 = _factorize_pair(lc, rc)
        m = min(l2.min(initial=0), r2.min(initial=0))
        l2, r2 = l2 - m, r2 - m
        card = int(max(l2.max(initial=0), r2.max(initial=0))) + 1
        both = np.concatenate([lk, rk])
        uni, inv = np.unique(both, return_inverse=True)
        lk, rk = inv[: len(lk)].astype(np.int64), inv[len(lk):].astype(np.int64)
        lk = lk * card + l2
        rk = rk * card + r2
    return lk, rk


def np_join(probe: HostTable, build: HostTable, pkeys, bkeys, how="inner",
            mark_name="__mark") -> HostTable:
    pk, bk = _pack_keys([probe[k] for k in pkeys], [build[k] for k in bkeys])
    order = np.argsort(bk, kind="stable")
    bks = bk[order]
    lo = np.searchsorted(bks, pk, "left")
    hi = np.searchsorted(bks, pk, "right")
    counts = hi - lo
    if how == "mark":
        out = dict(probe)
        out[mark_name] = counts > 0
        return out
    if how == "semi":
        return _take(probe, np.nonzero(counts > 0)[0])
    if how == "anti":
        return _take(probe, np.nonzero(counts == 0)[0])
    counts_out = np.maximum(counts, 1) if how == "left" else counts
    total = int(counts_out.sum())
    pidx = np.repeat(np.arange(len(pk)), counts_out)
    starts = np.zeros(len(pk), np.int64)
    np.cumsum(counts_out[:-1], out=starts[1:])
    intra = np.arange(total) - np.repeat(starts, counts_out)
    bpos = lo[pidx] + intra
    matched = counts[pidx] > 0
    bpos = np.where(matched, np.clip(bpos, 0, max(len(bk) - 1, 0)), 0)
    bidx = order[bpos] if len(bk) else np.zeros(total, np.int64)
    out = {k: v[pidx] for k, v in probe.items()}
    for k, v in build.items():
        if k not in out:
            out[k] = v[bidx] if len(bk) else np.zeros(total, v.dtype)
    if how == "left":
        out["__matched"] = matched
    return out


def np_group_aggregate(t: HostTable, keys: Sequence[str], aggs: Sequence[AggSpec],
                       engine=None) -> HostTable:
    n = _num_rows(t)
    if keys:
        cols = []
        for k in keys:
            v = t[k]
            if v.dtype.kind in "UOM":
                _, inv = np.unique(np.asarray(v, "U") if v.dtype.kind in "UO" else v,
                                   return_inverse=True)
                cols.append(inv.astype(np.int64))
            else:
                cols.append(v.astype(np.int64))
        packed = cols[0]
        for c in cols[1:]:
            c = c - c.min(initial=0)
            card = int(c.max(initial=0)) + 1
            _, packed = np.unique(packed, return_inverse=True)
            packed = packed.astype(np.int64) * card + c
        uniq, gids = np.unique(packed, return_inverse=True)
        ngroups = len(uniq)
        rep = np.zeros(ngroups, np.int64)
        rep[gids[::-1]] = np.arange(n)[::-1]  # first occurrence index
        out: HostTable = {k: t[k][rep] for k in keys}
    else:
        gids = np.zeros(n, np.int64)
        ngroups = 1
        out = {}
    counts = np.zeros(ngroups, np.int64)
    np.add.at(counts, gids, 1)
    for a in aggs:
        if a.fn == "count_star":
            out[a.name] = counts.copy()
            continue
        v = np_eval(a.expr, t, engine)
        if a.fn == "count":
            out[a.name] = counts.copy()
        elif a.fn == "sum":
            acc = np.zeros(ngroups, np.float64 if v.dtype.kind == "f" else np.int64)
            np.add.at(acc, gids, v.astype(acc.dtype))
            out[a.name] = acc
        elif a.fn == "avg":
            acc = np.zeros(ngroups, np.float64)
            np.add.at(acc, gids, v.astype(np.float64))
            out[a.name] = acc / np.maximum(counts, 1)
        elif a.fn in ("min", "max"):
            if v.dtype.kind in "UO":
                v = np.asarray(v, "U")
            ufunc = np.minimum if a.fn == "min" else np.maximum
            if v.dtype.kind in "UM":
                order = np.lexsort((v,)) if a.fn == "min" else np.lexsort((v,))[::-1]
                acc = np.empty(ngroups, v.dtype)
                acc[gids[order][::-1]] = v[order][::-1]
                out[a.name] = acc
            else:
                init = np.inf if a.fn == "min" else -np.inf
                acc = np.full(ngroups, init)
                ufunc.at(acc, gids, v.astype(np.float64))
                out[a.name] = acc if v.dtype.kind == "f" else acc.astype(v.dtype)
        elif a.fn == "count_distinct":
            pairs = np.unique(np.stack([gids, _factorize_pair(v, v[:0])[0]]), axis=1)
            cd = np.zeros(ngroups, np.int64)
            np.add.at(cd, pairs[0], 1)
            out[a.name] = cd
        else:
            raise ValueError(a.fn)
    return out


def _sortable(a: np.ndarray, ascending: bool = True) -> np.ndarray:
    """Lexsort-ready int/float view of a column (strings → ranks)."""
    if a.dtype.kind in "UO":
        _, inv = np.unique(np.asarray(a, "U"), return_inverse=True)
        a = inv.astype(np.int64)
    if a.dtype.kind == "M":
        a = a.astype(np.int64)
    if a.dtype.kind == "b":
        a = a.astype(np.int8)
    if not ascending:
        a = -a.astype(np.float64) if a.dtype.kind == "f" else -a.astype(np.int64)
    return a


def np_window(t: HostTable, partition_keys: Sequence[str],
              order_keys, func: str, arg, name: str) -> HostTable:
    """WindowRel semantics: rank rows / broadcast partition aggregates."""
    n = _num_rows(t)
    if partition_keys:
        packed = np.zeros(n, np.int64)
        for k in partition_keys:
            c = _sortable(t[k])
            c = c - c.min(initial=0)
            card = int(c.max(initial=0)) + 1
            _, packed = np.unique(packed, return_inverse=True)
            packed = packed.astype(np.int64) * card + c.astype(np.int64)
        _, gids = np.unique(packed, return_inverse=True)
    else:
        gids = np.zeros(n, np.int64)
    ngroups = int(gids.max(initial=0)) + 1 if n else 0
    out = dict(t)
    if func in ("row_number", "rank"):
        arrays = [_sortable(t[k.name], k.ascending) for k in order_keys]
        order = np.lexsort(tuple(reversed(arrays)) + (gids,))
        gsorted = gids[order]
        starts = np.r_[0, np.nonzero(np.diff(gsorted))[0] + 1] \
            if n else np.zeros(0, np.int64)
        group_start = np.zeros(ngroups, np.int64)
        if n:
            group_start[gsorted[starts]] = starts
        pos = np.arange(n) - group_start[gsorted]
        rn = np.empty(n, np.int64)
        rn[order] = pos + 1
        if func == "rank" and arrays:
            # rank: ties (equal order keys within a partition) share the
            # lowest row_number of their run
            key = np.stack([a[order] for a in arrays] + [gsorted])
            new_run = np.r_[True, (np.diff(key) != 0).any(axis=0)] if n \
                else np.zeros(0, bool)
            run_first = np.maximum.accumulate(
                np.where(new_run, np.arange(n), 0))
            rr = np.empty(n, np.int64)
            rr[order] = run_first - group_start[gsorted] + 1
            rn = rr
        out[name] = rn
        return out
    if func != "count" and arg is None:
        raise ValueError(f"window aggregate {func!r} requires an argument "
                         "column")
    v = t[arg].astype(np.float64) if func != "count" else None
    counts = np.zeros(ngroups, np.int64)
    np.add.at(counts, gids, 1)
    if func == "count":
        out[name] = counts[gids]
    elif func == "sum":
        acc = np.zeros(ngroups, np.float64)
        np.add.at(acc, gids, v)
        res = acc[gids]
        out[name] = res if t[arg].dtype.kind == "f" else res.astype(np.int64)
    elif func == "avg":
        acc = np.zeros(ngroups, np.float64)
        np.add.at(acc, gids, v)
        out[name] = (acc / np.maximum(counts, 1))[gids]
    elif func in ("min", "max"):
        ufunc = np.minimum if func == "min" else np.maximum
        acc = np.full(ngroups, np.inf if func == "min" else -np.inf)
        ufunc.at(acc, gids, v)
        res = acc[gids]
        out[name] = res if t[arg].dtype.kind == "f" else res.astype(np.int64)
    else:
        raise ValueError(f"unknown window function {func!r}")
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class FallbackEngine:
    def __init__(self, tables: Dict[str, HostTable]):
        self.tables = tables

    def execute(self, plan: Rel) -> HostTable:
        if isinstance(plan, ReadRel):
            t = dict(self.tables[plan.table])
            if plan.filter is not None:
                mask = np_eval(plan.filter, t, self)
                t = _take(t, np.nonzero(mask)[0])
            if plan.columns:
                t = {k: t[k] for k in plan.columns if k in t}
            return t
        if isinstance(plan, FilterRel):
            t = self.execute(plan.input)
            return _take(t, np.nonzero(np_eval(plan.condition, t, self))[0])
        if isinstance(plan, ProjectRel):
            t = self.execute(plan.input)
            out = dict(t) if plan.keep_input else {}
            for name, e in plan.exprs:
                out[name] = np_eval(e, t, self)
            return out
        if isinstance(plan, ExchangeRel):
            return self.execute(plan.input)
        if isinstance(plan, JoinRel):
            probe = self.execute(plan.probe)
            build = self.execute(plan.build)
            out = np_join(probe, build, plan.probe_keys, plan.build_keys,
                          plan.how, plan.mark_name)
            if plan.post_filter is not None:
                out = _take(out, np.nonzero(np_eval(plan.post_filter, out, self))[0])
            return out
        if isinstance(plan, AggregateRel):
            t = self.execute(plan.input)
            out = np_group_aggregate(t, plan.group_keys, plan.aggs, self)
            if plan.having is not None:
                out = _take(out, np.nonzero(np_eval(plan.having, out, self))[0])
            return out
        if isinstance(plan, SortRel):
            t = self.execute(plan.input)
            arrays = []
            for k in plan.keys:
                a = t[k.name]
                if a.dtype.kind in "UO":
                    a = np.asarray(a, "U")
                    uni, inv = np.unique(a, return_inverse=True)
                    a = inv.astype(np.int64)
                if a.dtype.kind == "M":
                    a = a.astype(np.int64)
                if a.dtype.kind == "b":
                    a = a.astype(np.int8)
                if not k.ascending:
                    a = -a.astype(np.float64) if a.dtype.kind == "f" else -a.astype(np.int64)
                arrays.append(a)
            order = np.lexsort(tuple(reversed(arrays)))
            if plan.limit is not None:
                order = order[: plan.limit]
            return _take(t, order)
        if isinstance(plan, FetchRel):
            t = self.execute(plan.input)
            return _take(t, np.arange(min(plan.count, _num_rows(t))))
        if isinstance(plan, SetRel):
            if plan.op != "union_all":
                raise ValueError(f"unsupported set op {plan.op!r}")
            if not plan.operands:
                raise ValueError("SetRel requires at least one operand")
            parts = [self.execute(p) for p in plan.operands]
            cols = list(parts[0])
            return {k: np.concatenate([np.asarray(p[k]) for p in parts])
                    for k in cols}
        if isinstance(plan, WindowRel):
            t = self.execute(plan.input)
            return np_window(t, plan.partition_keys, plan.order_keys,
                             plan.func, plan.arg, plan.name)
        raise TypeError(type(plan))
