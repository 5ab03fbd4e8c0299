"""Rule-based plan rewrites — counterpart of ``repro/optimizer/rules.py``.

The passes reproduce the standard rewrites DuckDB performs before emitting a
Substrait plan to Sirius (the paper's host-optimizer contribution):

  * ``fold_constants``        — literal arithmetic/boolean folding
  * ``pushdown_predicates``   — FilterRel conjuncts sink through projections
    and joins into ``ReadRel.filter`` (scan-level predicate pushdown);
    conjuncts spanning both join sides become the join's ``post_filter``
  * ``prune_projections``     — required-column analysis top-down, landing in
    ``ReadRel.columns`` (scan-level projection pushdown)
  * ``reorder_joins``         — greedy smallest-intermediate-first ordering
    of left-deep inner/semi/anti chains, under key-availability constraints
  * ``choose_build_sides``    — the smaller estimated side of an inner join
    becomes the hash-build side (the pipeline breaker, paper §3.2.2)
  * ``order_conjuncts``       — most-selective-first AND ordering

Every pass is a pure function Rel → Rel (nodes are rebuilt, never mutated),
so the naive plan stays valid for rules-off comparisons.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SortRel,
)
from ..relational.expressions import (
    BinOp, Col, Expr, Lit, UnOp, and_all as _and_all,
    split_conjuncts as _conjuncts, transform_expr,
)
from .stats import contains_subquery, estimate, rel_columns, selectivity


def _replace_children(rel: Rel, **kw) -> Rel:
    return dataclasses.replace(rel, **kw)


def _map_children(rel: Rel, fn) -> Rel:
    """Rebuild ``rel`` with ``fn`` applied to every child Rel (and to plans
    inside ScalarSubquery expressions)."""
    changes = {}
    for f in dataclasses.fields(rel):
        v = getattr(rel, f.name)
        if isinstance(v, Rel):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, Expr):
            nv = _map_subplans(v, fn)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, list) and v:
            new_items, dirty = [], False
            for item in v:
                if isinstance(item, tuple) and len(item) == 2 \
                        and isinstance(item[1], Expr):
                    ne = _map_subplans(item[1], fn)
                    dirty |= ne is not item[1]
                    new_items.append((item[0], ne))
                elif hasattr(item, "expr") and isinstance(
                        getattr(item, "expr", None), Expr):
                    ne = _map_subplans(item.expr, fn)
                    if ne is not item.expr:
                        item = dataclasses.replace(item, expr=ne)
                        dirty = True
                    new_items.append(item)
                else:
                    new_items.append(item)
            if dirty:
                changes[f.name] = new_items
    return dataclasses.replace(rel, **changes) if changes else rel


def _map_subplans(e: Expr, fn) -> Expr:
    def visit(node: Expr) -> Expr:
        if isinstance(node, ScalarSubquery):
            np_ = fn(node.plan)
            if np_ is not node.plan:
                return ScalarSubquery(np_, node.column)
        return node
    return transform_expr(e, visit)


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

_FOLD_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
               "*": lambda a, b: a * b, "/": lambda a, b: a / b}
_FOLD_CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
             "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
             ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def _is_plain_num(e: Expr) -> bool:
    return (isinstance(e, Lit) and e.kind is None
            and isinstance(e.value, (int, float))
            and not isinstance(e.value, bool))


def _fold_expr(e: Expr) -> Expr:
    def visit(node: Expr) -> Expr:
        if isinstance(node, BinOp):
            l, r = node.left, node.right
            if node.op in _FOLD_ARITH and _is_plain_num(l) and _is_plain_num(r):
                if node.op == "/" and r.value == 0:
                    return node
                return Lit(_FOLD_ARITH[node.op](l.value, r.value))
            if node.op in _FOLD_CMP and _is_plain_num(l) and _is_plain_num(r):
                return Lit(bool(_FOLD_CMP[node.op](l.value, r.value)))
            if node.op in ("and", "or"):
                for a, b in ((l, r), (r, l)):
                    if isinstance(a, Lit) and isinstance(a.value, bool):
                        if node.op == "and":
                            return b if a.value else Lit(False)
                        return Lit(True) if a.value else b
        if isinstance(node, UnOp):
            v = node.operand
            if node.op == "-" and _is_plain_num(v):
                return Lit(-v.value)
            if node.op == "not" and isinstance(v, Lit) \
                    and isinstance(v.value, bool):
                return Lit(not v.value)
            if node.op == "not" and isinstance(v, UnOp) and v.op == "not":
                return v.operand
        return node
    return transform_expr(e, visit)


def fold_constants(rel: Rel, catalog=None) -> Rel:
    rel = _map_children(rel, lambda c: fold_constants(c, catalog))
    changes = {}
    for f in dataclasses.fields(rel):
        v = getattr(rel, f.name)
        if isinstance(v, Expr):
            nv = _fold_expr(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, list) and v:
            new_items, dirty = [], False
            for item in v:
                if isinstance(item, tuple) and len(item) == 2 \
                        and isinstance(item[1], Expr):
                    ne = _fold_expr(item[1])
                    dirty |= ne is not item[1]
                    new_items.append((item[0], ne))
                elif hasattr(item, "expr") and isinstance(
                        getattr(item, "expr", None), Expr):
                    ne = _fold_expr(item.expr)
                    if ne is not item.expr:
                        item = dataclasses.replace(item, expr=ne)
                        dirty = True
                    new_items.append(item)
                else:
                    new_items.append(item)
            if dirty:
                changes[f.name] = new_items
    return dataclasses.replace(rel, **changes) if changes else rel


# ---------------------------------------------------------------------------
# predicate pushdown
# ---------------------------------------------------------------------------


def pushdown_predicates(rel: Rel, catalog) -> Rel:
    return _push(rel, [], catalog)


def _push(rel: Rel, preds: List[Expr], catalog) -> Rel:
    """Return a plan equivalent to Filter(rel, AND(preds))."""
    rel = _map_children(rel, lambda c: _push(c, [], catalog)) \
        if not isinstance(rel, (FilterRel, ReadRel, ProjectRel, JoinRel,
                                SortRel, ExchangeRel)) else rel

    if isinstance(rel, FilterRel):
        return _push(rel.input, preds + _conjuncts(rel.condition), catalog)

    if isinstance(rel, ReadRel):
        into_scan = [p for p in preds if not contains_subquery(p)]
        keep = [p for p in preds if contains_subquery(p)]
        if into_scan:
            existing = _conjuncts(rel.filter)
            rel = _replace_children(rel, filter=_and_all(existing + into_scan))
        return _wrap_filter(rel, keep, catalog)

    if isinstance(rel, ProjectRel):
        passthrough = _passthrough_cols(rel, catalog)
        # pure renames (out_name -> Col(src)) are invertible: predicates on
        # the renamed output can be rewritten to the source name and pushed
        # through — this is what carries filters into aliased self-join and
        # derived-table scans, whose every column sits under a rename
        rename = {n: e.name for n, e in rel.exprs if isinstance(e, Col)}
        down, keep = [], []
        for p in preds:
            cols = set(p.columns())
            if not cols:
                keep.append(p)
            elif cols <= passthrough:
                down.append(p)
            elif cols <= (passthrough | set(rename)):
                down.append(transform_expr(
                    p, lambda n: Col(rename[n.name])
                    if isinstance(n, Col) and n.name in rename else n))
            else:
                keep.append(p)
        new_input = _push(rel.input, down, catalog)
        rel = _replace_children(rel, input=new_input)
        return _wrap_filter(rel, keep, catalog)

    if isinstance(rel, (SortRel, ExchangeRel)):
        limited = isinstance(rel, SortRel) and rel.limit is not None
        if limited:
            new_input = _push(rel.input, [], catalog)
            rel = _replace_children(rel, input=new_input)
            return _wrap_filter(rel, preds, catalog)
        new_input = _push(rel.input, preds, catalog)
        return _replace_children(rel, input=new_input)

    if isinstance(rel, JoinRel):
        probe_cols = set(rel_columns(rel.probe, catalog))
        build_cols = set(rel_columns(rel.build, catalog))
        probe_preds: List[Expr] = []
        build_preds: List[Expr] = []
        post: List[Expr] = []
        keep: List[Expr] = []
        build_ok = rel.how in ("inner", "semi", "anti")
        for p in preds:
            cols = set(p.columns())
            if cols and cols <= probe_cols:
                probe_preds.append(p)
            elif build_ok and cols and cols <= build_cols:
                build_preds.append(p)
            elif cols and cols <= (probe_cols | build_cols) \
                    and rel.how == "inner" and not contains_subquery(p):
                post.append(p)
            else:
                keep.append(p)
        new_probe = _push(rel.probe, probe_preds, catalog)
        new_build = _push(rel.build, build_preds, catalog)
        post_filter = rel.post_filter
        if post:
            post_filter = _and_all(_conjuncts(post_filter) + post)
        rel = _replace_children(rel, probe=new_probe, build=new_build,
                                post_filter=post_filter)
        return _wrap_filter(rel, keep, catalog)

    # breakers (Aggregate, Fetch) and anything else: optimize children,
    # keep the predicates above
    return _wrap_filter(rel, preds, catalog)


def _wrap_filter(rel: Rel, preds: List[Expr], catalog=None) -> Rel:
    # predicates that stay behind may embed scalar-subquery plans: those
    # sub-plans still deserve their own pushdown pass
    preds = [_map_subplans(p, lambda sp: _push(sp, [], catalog))
             for p in preds]
    cond = _and_all(preds)
    return rel if cond is None else FilterRel(rel, cond)


def _passthrough_cols(rel: ProjectRel, catalog) -> set:
    """Columns readable below this projection under the same name."""
    defined = {n for n, _ in rel.exprs}
    out = set()
    for n, e in rel.exprs:
        if isinstance(e, Col) and e.name == n:
            out.add(n)
    if rel.keep_input:
        out |= {c for c in rel_columns(rel.input, catalog)
                if c not in defined}
    return out


# ---------------------------------------------------------------------------
# projection pruning
# ---------------------------------------------------------------------------


def prune_projections(rel: Rel, catalog) -> Rel:
    return _prune(rel, None, catalog)


def _req(required, *extra) -> Optional[set]:
    if required is None:
        return None
    out = set(required)
    for cols in extra:
        out |= set(cols)
    return out


def _prune(rel: Rel, required: Optional[set], catalog) -> Rel:
    """Rebuild ``rel`` so it only produces ``required`` columns (None = all).
    Sub-plans inside scalar subqueries are pruned independently."""
    if isinstance(rel, ReadRel):
        if required is not None and catalog is not None \
                and catalog.has_table(rel.table):
            schema = catalog.columns(rel.table)
            cols = [c for c in schema if c in required]
            return _replace_children(rel, columns=cols)
        return rel

    if isinstance(rel, FilterRel):
        child_req = _req(required, rel.condition.columns()) \
            if required is not None else None
        cond = _prune_expr_subplans(rel.condition, catalog)
        return FilterRel(_prune(rel.input, child_req, catalog), cond)

    if isinstance(rel, ProjectRel):
        exprs = [(n, _prune_expr_subplans(e, catalog)) for n, e in rel.exprs]
        if required is not None and not rel.keep_input:
            exprs = [(n, e) for n, e in exprs if n in required] or exprs[:1]
        used: List[str] = []
        for _, e in exprs:
            used.extend(e.columns())
        if rel.keep_input:
            child_req = _req(required, used) if required is not None else None
        else:
            child_req = set(used)
        return ProjectRel(_prune(rel.input, child_req, catalog), exprs,
                          rel.keep_input)

    if isinstance(rel, JoinRel):
        probe_cols = set(rel_columns(rel.probe, catalog))
        build_cols = set(rel_columns(rel.build, catalog))
        post_cols = set(rel.post_filter.columns()) if rel.post_filter \
            is not None else set()
        if required is None:
            probe_req = None
            build_req = None if rel.how in ("inner", "left") else \
                set(rel.build_keys) | (post_cols & build_cols)
        else:
            want = set(required) | post_cols
            probe_req = (want & probe_cols) | set(rel.probe_keys)
            build_req = (want & build_cols) | set(rel.build_keys)
            if rel.how in ("semi", "anti"):
                build_req = set(rel.build_keys) | (post_cols & build_cols)
        post = _prune_expr_subplans(rel.post_filter, catalog) \
            if rel.post_filter is not None else None
        return dataclasses.replace(
            rel,
            probe=_prune(rel.probe, probe_req, catalog),
            build=_prune(rel.build, build_req, catalog),
            post_filter=post)

    if isinstance(rel, AggregateRel):
        # the aggregate defines its input needs exactly, independent of what
        # the parent wants
        child_req: set = set(rel.group_keys)
        aggs = []
        for a in rel.aggs:
            if a.expr is not None:
                child_req |= set(a.expr.columns())
                aggs.append(dataclasses.replace(
                    a, expr=_prune_expr_subplans(a.expr, catalog)))
            else:
                aggs.append(a)
        having = _prune_expr_subplans(rel.having, catalog) \
            if rel.having is not None else None
        return AggregateRel(_prune(rel.input, child_req, catalog),
                            list(rel.group_keys), aggs, having)

    if isinstance(rel, SortRel):
        child_req = _req(required, [k.name for k in rel.keys]) \
            if required is not None else None
        return dataclasses.replace(
            rel, input=_prune(rel.input, child_req, catalog))

    if isinstance(rel, FetchRel):
        return dataclasses.replace(
            rel, input=_prune(rel.input, required, catalog))

    if isinstance(rel, ExchangeRel):
        child_req = _req(required, rel.keys) if required is not None else None
        return dataclasses.replace(
            rel, input=_prune(rel.input, child_req, catalog))

    return rel


def _prune_expr_subplans(e: Expr, catalog) -> Expr:
    def visit(node: Expr) -> Expr:
        if isinstance(node, ScalarSubquery):
            return ScalarSubquery(_prune(node.plan, None, catalog),
                                  node.column)
        return node
    return transform_expr(e, visit)


# ---------------------------------------------------------------------------
# join reordering + build-side selection
# ---------------------------------------------------------------------------

_REORDERABLE = ("inner", "semi", "anti")


def reorder_joins(rel: Rel, catalog) -> Rel:
    rel = _map_children(rel, lambda c: reorder_joins(c, catalog))
    if not isinstance(rel, JoinRel) or rel.how not in _REORDERABLE:
        return rel
    # decompose the left-deep probe spine
    chain: List[JoinRel] = []
    node: Rel = rel
    while isinstance(node, JoinRel) and node.how in _REORDERABLE:
        chain.append(node)
        node = node.probe
    if len(chain) < 2:
        return rel
    base = node
    chain.reverse()                   # bottom-most join first
    base_cols = set(rel_columns(base, catalog))

    entries = []
    for j in chain:
        post_cols = set(j.post_filter.columns()) if j.post_filter is not None \
            else set()
        entries.append({
            "join": j,
            "build_cols": set(rel_columns(j.build, catalog)),
            "build_est": estimate(j.build, catalog),
            "post_cols": post_cols,
        })

    ordered = []
    avail = set(base_cols)
    pending = list(entries)
    while pending:
        # candidates whose probe keys (and post-filter probe-side columns)
        # are already available on the spine
        cands = []
        for ent in pending:
            j = ent["join"]
            need = set(j.probe_keys) | (ent["post_cols"] - ent["build_cols"])
            if need <= avail:
                cands.append(ent)
        if not cands:
            return rel                # give up: keep original order
        # greedy: smallest estimated build side first (semi/anti are
        # row-reducing, so their small builds naturally float up).
        # Identity-based removal: these dicts hold Rel/Expr whose == is
        # overloaded, so list.remove would mis-match.
        ent = min(cands, key=lambda e: e["build_est"])
        pending = [p for p in pending if p is not ent]
        ordered.append(ent)
        if ent["join"].how == "inner":
            avail |= ent["build_cols"]

    out: Rel = base
    for ent in ordered:
        j = ent["join"]
        out = dataclasses.replace(j, probe=out)
    return out


def choose_build_sides(rel: Rel, catalog) -> Rel:
    rel = _map_children(rel, lambda c: choose_build_sides(c, catalog))
    if isinstance(rel, JoinRel) and rel.how == "inner":
        p = estimate(rel.probe, catalog)
        b = estimate(rel.build, catalog)
        if b > p * 1.2:               # hysteresis: only swap when clearly won
            rel = dataclasses.replace(
                rel, probe=rel.build, build=rel.probe,
                probe_keys=list(rel.build_keys),
                build_keys=list(rel.probe_keys))
    return rel


# ---------------------------------------------------------------------------
# conjunct ordering (most selective first)
# ---------------------------------------------------------------------------


def order_conjuncts(rel: Rel, catalog=None) -> Rel:
    rel = _map_children(rel, lambda c: order_conjuncts(c, catalog))

    def reorder(e: Optional[Expr]) -> Optional[Expr]:
        cs = _conjuncts(e)
        if len(cs) < 2:
            return e
        cs.sort(key=lambda c: selectivity(c, catalog))
        return _and_all(cs)

    if isinstance(rel, ReadRel) and rel.filter is not None:
        return _replace_children(rel, filter=reorder(rel.filter))
    if isinstance(rel, FilterRel):
        return _replace_children(rel, condition=reorder(rel.condition))
    return rel
