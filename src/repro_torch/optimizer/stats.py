"""Cardinality / selectivity heuristics for the rule-based optimizer — counterpart of ``repro/optimizer/stats.py``.

No histograms or NDV sketches — the same class of closed-form guesses
classical System-R-style optimizers fall back to when stats are missing.
They only need to be good enough to (a) pick hash-join build sides and
(b) order joins so selective dimension tables apply early, which is what the
paper's host-optimizer (DuckDB) contributes to Sirius plans.

String predicates get one real statistic for free: the dictionary.  When
the catalog carries column dictionaries (``Catalog.with_dictionaries`` —
the engine attaches them from its loaded tables), LIKE / IN / prefix /
equality selectivities are the predicate's measured *hit rate over the
dictionary* instead of the Selinger constants.  Codes are assumed uniform
(no per-code frequencies), and the constants remain the fallback whenever
no dictionary is available.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SetRel, SortRel, WindowRel,
)
from ..relational import strings
from ..relational.expressions import (
    Between, BinOp, Col, Expr, InList, Like, Lit, StartsWith, UnOp, walk_expr,
)

# default selectivity guesses (classic Selinger-style constants)
SEL_EQ = 0.05
SEL_RANGE = 0.3
SEL_BETWEEN = 0.25
SEL_LIKE = 0.1
SEL_IN_PER_VALUE = 0.05
SEL_DEFAULT = 0.5


def _dictionary_of(e: Expr, catalog) -> Optional[object]:
    """Dictionary of a bare-column operand, when the catalog knows it."""
    if catalog is None or not isinstance(e, Col):
        return None
    getter = getattr(catalog, "dictionary_for", None)
    return getter(e.name) if getter is not None else None


def selectivity(e: Expr, catalog=None) -> float:
    """Heuristic fraction of rows satisfying predicate ``e``.

    With a dictionary-carrying ``catalog``, string predicates return their
    dictionary hit rate; otherwise the classic constants apply.
    """
    if isinstance(e, BinOp):
        if e.op == "and":
            return selectivity(e.left, catalog) * selectivity(e.right, catalog)
        if e.op == "or":
            s1 = selectivity(e.left, catalog)
            s2 = selectivity(e.right, catalog)
            return min(1.0, s1 + s2 - s1 * s2)
        if e.op in ("==", "!="):
            sel = SEL_EQ
            if isinstance(e.right, Lit) and isinstance(e.right.value, str):
                d = _dictionary_of(e.left, catalog)
                if d is not None and len(d):
                    sel = strings.eq_selectivity(d, e.right.value)
            return sel if e.op == "==" else 1.0 - sel
        if e.op in ("<", "<=", ">", ">="):
            return SEL_RANGE
        return SEL_DEFAULT
    if isinstance(e, UnOp) and e.op == "not":
        return max(0.0, 1.0 - selectivity(e.operand, catalog))
    if isinstance(e, Between):
        return SEL_BETWEEN
    if isinstance(e, InList):
        values = list(e.values)
        d = _dictionary_of(e.operand, catalog)
        if d is not None and len(d) and all(isinstance(v, str) for v in values):
            s = strings.in_selectivity(d, values)
        else:
            s = min(1.0, SEL_IN_PER_VALUE * max(len(values), 1))
        return 1.0 - s if e.negate else s
    if isinstance(e, Like):
        d = _dictionary_of(e.operand, catalog)
        s = strings.like_selectivity(d, e.pattern) \
            if d is not None and len(d) else SEL_LIKE
        return 1.0 - s if e.negate else s
    if isinstance(e, StartsWith):
        d = _dictionary_of(e.operand, catalog)
        s = strings.prefix_selectivity(d, e.prefix) \
            if d is not None and len(d) else SEL_LIKE
        return 1.0 - s if e.negate else s
    if isinstance(e, Lit):
        if isinstance(e.value, bool):
            return 1.0 if e.value else 0.0
        return SEL_DEFAULT
    return SEL_DEFAULT


def contains_subquery(e: Expr) -> bool:
    return any(isinstance(n, ScalarSubquery) for n in walk_expr(e))


def rel_columns(rel: Rel, catalog) -> List[str]:
    """Output column names of a plan node (needs the catalog for bare
    ReadRels)."""
    if isinstance(rel, ReadRel):
        if rel.columns:
            return list(rel.columns)
        if catalog is not None and catalog.has_table(rel.table):
            return catalog.columns(rel.table)
        return []                     # unknown table: treat as opaque
    if isinstance(rel, (FilterRel, SortRel, FetchRel, ExchangeRel)):
        return rel_columns(rel.input, catalog)
    if isinstance(rel, ProjectRel):
        names = [n for n, _ in rel.exprs]
        if rel.keep_input:
            base = [c for c in rel_columns(rel.input, catalog)
                    if c not in names]
            return base + names
        return names
    if isinstance(rel, JoinRel):
        probe = rel_columns(rel.probe, catalog)
        if rel.how in ("semi", "anti"):
            return probe
        if rel.how == "mark":
            return probe + [rel.mark_name]
        build = [c for c in rel_columns(rel.build, catalog) if c not in probe]
        out = probe + build
        if rel.how == "left":
            out = out + ["__matched"]
        return out
    if isinstance(rel, AggregateRel):
        return list(rel.group_keys) + [a.name for a in rel.aggs]
    if isinstance(rel, WindowRel):
        return rel_columns(rel.input, catalog) + [rel.name]
    if isinstance(rel, SetRel):
        return rel_columns(rel.operands[0], catalog) if rel.operands else []
    raise TypeError(type(rel))


def estimate(rel: Rel, catalog) -> float:
    """Estimated output rows (also memoized onto ``rel.estimated_rows``)."""
    if isinstance(rel, ReadRel):
        base = catalog.row_estimate(rel.table) if catalog is not None else 1e3
        out = base * (selectivity(rel.filter, catalog)
                      if rel.filter is not None else 1.0)
    elif isinstance(rel, FilterRel):
        out = estimate(rel.input, catalog) * selectivity(rel.condition,
                                                       catalog)
    elif isinstance(rel, (ProjectRel, ExchangeRel)):
        out = estimate(rel.input, catalog)
    elif isinstance(rel, SortRel):
        out = estimate(rel.input, catalog)
        if rel.limit is not None:
            out = min(out, float(rel.limit))
    elif isinstance(rel, FetchRel):
        out = min(estimate(rel.input, catalog), float(rel.count))
    elif isinstance(rel, JoinRel):
        p = estimate(rel.probe, catalog)
        b = estimate(rel.build, catalog)
        if rel.how in ("semi",):
            out = p * 0.5
        elif rel.how == "anti":
            out = p * 0.5
        elif rel.how == "mark":
            out = p
        else:
            # FK-join heuristic: output ≈ the larger (fact) side, scaled by
            # how selective the smaller side already is relative to its base
            out = max(p, b)
            if rel.how == "left":
                out = max(out, p)
        if rel.post_filter is not None:
            out *= selectivity(rel.post_filter, catalog)
    elif isinstance(rel, AggregateRel):
        child = estimate(rel.input, catalog)
        out = 1.0 if not rel.group_keys else max(1.0, child * 0.1)
        if rel.having is not None:
            out *= selectivity(rel.having, catalog)
    elif isinstance(rel, WindowRel):
        out = estimate(rel.input, catalog)
    elif isinstance(rel, SetRel):
        out = sum(estimate(p, catalog) for p in rel.operands)
    else:
        out = 1e3
    rel.estimated_rows = float(out)
    return rel.estimated_rows


def annotate(rel: Rel, catalog) -> Rel:
    """Set ``estimated_rows`` on every node (including scalar-subquery
    sub-plans) so ``explain`` shows the optimizer's cardinality view."""
    estimate(rel, catalog)
    for node in _walk_all(rel):
        estimate(node, catalog)
    return rel


def _walk_all(rel: Rel):
    yield rel
    for child in rel.inputs():
        yield from _walk_all(child)
    for e in _rel_exprs(rel):
        for n in walk_expr(e):
            if isinstance(n, ScalarSubquery):
                yield from _walk_all(n.plan)


def _rel_exprs(rel: Rel) -> List[Expr]:
    import dataclasses

    out: List[Expr] = []
    for f in dataclasses.fields(rel):
        v = getattr(rel, f.name)
        if isinstance(v, Expr):
            out.append(v)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, Expr):
                    out.append(item)
                elif isinstance(item, tuple):
                    out.extend(x for x in item if isinstance(x, Expr))
                elif hasattr(item, "expr") and isinstance(
                        getattr(item, "expr", None), Expr):
                    out.append(item.expr)
    return out
