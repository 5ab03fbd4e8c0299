"""AST → plan-IR lowering (the "standard plan" half of the drop-in pipeline) — counterpart of ``repro/sql/lower.py``.

Produces a deliberately *naive* plan — full-width table scans, the join tree
in FROM/connectivity order, and every non-join predicate in one FilterRel
above the joins — so that the rule-based optimizer (repro_torch.optimizer) is the
component that earns predicate pushdown, projection pruning, join ordering
and build-side selection, exactly as DuckDB's optimizer does in front of
Sirius.

Subquery handling mirrors the rewrites DuckDB applies before emitting
Substrait:
  * ``x IN (SELECT ...)``     → semi join   (NOT IN → anti join)
  * ``EXISTS (SELECT ...)``   → semi join on the correlated equality keys
    (NOT EXISTS → anti join); only equality correlation is supported,
  * uncorrelated scalar subqueries → ``ScalarSubquery`` nodes, executed
    first by the engine and bound as literals,
  * correlated scalar comparisons (``x < (SELECT agg ... WHERE inner =
    outer)``) → the subquery aggregate grouped by its correlation keys,
    inner-joined on those keys, comparison kept as a residual predicate.

FROM-clause shapes beyond base tables: derived tables are lowered first
and bound like base tables; LEFT OUTER JOIN entries keep their ON
condition at the join (equality keys + build-side predicates), and
``count(col)`` over a left join's build side lowers to
``sum(case when __matched ...)``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Set, Tuple

from ..core.plan import (
    AggregateRel, FetchRel, FilterRel, JoinRel, ProjectRel, ReadRel, Rel,
    ScalarSubquery, SortRel,
)
from ..relational.aggregate import AggSpec
from ..relational.expressions import (
    Between, BinOp, Case, Cast, Col, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, and_all, expr_children, expr_equal, split_conjuncts,
    transform_expr, walk_expr,
)
from ..relational.sort import SortKey
from ..relational.table import BOOL, NUMERIC, STRING
from .binder import Binding, Catalog, DEFAULT_CATALOG, Scope, bind_expr
from .lexer import SqlError
from .nodes import (
    OrderItem, OuterCol, SelectItem, SelectStmt, SqlCol, SqlExists, SqlFunc,
    SqlInSubquery, SqlSubquery, Star,
)

_AGG_FN_MAP = {"sum": "sum", "avg": "avg", "min": "min", "max": "max",
               "count": "count"}


def _contains(e: Expr, types) -> bool:
    return any(isinstance(n, types) for n in walk_expr(e))


def _cols_of(e: Expr) -> List[str]:
    return [n.name for n in walk_expr(e) if isinstance(n, Col)]


def _outer_cols_of(e: Expr) -> List[str]:
    return [n.name for n in walk_expr(e) if isinstance(n, OuterCol)]


class _Lowering:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._names = itertools.count()

    def fresh(self, prefix: str) -> str:
        return f"__{prefix}{next(self._names)}"

    # ------------------------------------------------------------------
    def _make_bindings(self, refs) -> List[Binding]:
        """Resolve FROM entries: catalog tables → column/kind bindings,
        derived tables → lowered sub-plans with inferred output kinds."""
        out: List[Binding] = []
        for t in refs:
            if t.subquery is not None:
                plan, cols, corr, kinds = self.lower(t.subquery)
                assert not corr
                out.append(Binding(t.binding_name, cols, kinds, plan=plan))
                continue
            if not self.catalog.has_table(t.name):
                raise SqlError(f"unknown table {t.name!r}")
            cols = self.catalog.columns(t.name)
            kinds = {c: self.catalog.kind(t.name, c) for c in cols}
            out.append(Binding(t.binding_name, cols, kinds, table=t.name))
        return out

    def _scan_for(self, b: Binding) -> Rel:
        """A binding's scan: ReadRel / derived sub-plan, plus a renaming
        projection when the scope assigned non-source effective names."""
        base: Rel = b.plan if b.plan is not None else ReadRel(b.table)
        if b.renamed:
            base = ProjectRel(base, [(b.eff[c], Col(c)) for c in b.columns])
        return base

    def lower(self, stmt: SelectStmt, outer: Optional[Scope] = None,
              for_exists: bool = False, corr_group: bool = False):
        """→ (plan, output column names, correlations, output kinds).

        ``correlations`` is a list of (outer_col, inner_col) equality pairs
        extracted from the WHERE clause; non-empty only when ``outer`` is
        given and the subquery is correlated.  With ``corr_group`` (the
        correlated-scalar-subquery path) the inner correlation columns are
        injected as leading group keys and output columns, which is the
        standard aggregate decorrelation DuckDB performs.
        """
        bindings = self._make_bindings(stmt.from_tables)
        left_bindings = self._make_bindings([t for t, _ in stmt.left_joins])
        scope = Scope(self.catalog, bindings + left_bindings, parent=outer)

        where = bind_expr(stmt.where, scope) if stmt.where is not None \
            else None
        conjuncts = split_conjuncts(where)

        correlations: List[Tuple[str, str]] = []
        plain: List[Expr] = []
        sub_joins: List[Expr] = []       # IN/EXISTS subquery conjuncts
        scalar_cmps: List[Expr] = []     # conjuncts embedding (SELECT ...)
        for c in conjuncts:
            if isinstance(c, (SqlExists, SqlInSubquery)):
                sub_joins.append(c)
                continue
            outer_refs = _outer_cols_of(c)
            if outer_refs:
                pair = self._correlation_pair(c)
                if pair is None:
                    raise SqlError(
                        "only equality correlation (inner_col = outer_col) "
                        "is supported in subqueries")
                correlations.append(pair)
                continue
            if _contains(c, SqlSubquery):
                scalar_cmps.append(c)
                continue
            plain.append(c)

        # -- join tree over the FROM tables -----------------------------
        plan, available = self._join_tree(bindings, plain, scope)

        # -- LEFT JOIN entries (ON conditions stay at the join) ----------
        if len(stmt.left_joins) > 1:
            raise SqlError(
                "at most one LEFT JOIN per SELECT is supported (the "
                "engine's __matched marker is per-query)")
        left_info: List[Tuple[str, set]] = []
        for (tref, on_expr), b in zip(stmt.left_joins, left_bindings):
            plan, available = self._lower_left_join(
                plan, available, b, on_expr, scope, left_info)

        # -- IN / EXISTS subqueries → semi/anti joins --------------------
        for c in sub_joins:
            plan = self._lower_sub_join(plan, c, scope)

        # -- scalar subquery comparisons: uncorrelated → ScalarSubquery,
        #    correlated → decorrelating aggregate join ------------------
        for c in scalar_cmps:
            plan, rewritten = self._lower_scalar_cmp(plan, available, c,
                                                     scope)
            plain.append(rewritten)

        # WHERE predicates over the left join's build side would compare
        # garbage values on unmatched rows — reject instead of mis-answer
        self._check_left_guard(plain, left_info)

        # -- residual predicates (single FilterRel; optimizer pushes) ----
        residual = and_all(plain)
        if residual is not None:
            plan = FilterRel(plan, residual)

        if for_exists:
            return plan, list(available), correlations, {}

        # -- select items / aggregation ----------------------------------
        items = self._expand_items(stmt.items, available)
        bound_items = [SelectItem(bind_expr(it.expr, scope), it.alias)
                       for it in items]
        alias_map = {it.alias: it.expr for it in bound_items if it.alias}

        group_exprs = self._bind_group_by(stmt.group_by, scope, alias_map)
        has_agg = bool(group_exprs) or any(
            _contains(it.expr, SqlFunc) for it in bound_items)
        having = None
        if stmt.having is not None:
            having = bind_expr(stmt.having, scope)
            having = self._subst_aliases(having, alias_map)
            has_agg = True

        if corr_group and correlations:
            # decorrelation: group by the correlation keys, output them first
            if not has_agg:
                raise SqlError(
                    "correlated scalar subquery must be an aggregate")
            inner_keys: List[str] = []
            for _o, i in correlations:
                if i not in inner_keys:
                    inner_keys.append(i)
            group_exprs = [(k, Col(k)) for k in inner_keys] + group_exprs
            bound_items = [SelectItem(Col(k), k) for k in inner_keys] \
                + bound_items

        # unmatched left-join rows have no build-side values: only the
        # count(col)→sum(case __matched) rewrite can consume those columns
        self._check_left_guard(
            [it.expr for it in bound_items] + [e for _n, e in group_exprs]
            + ([having] if having is not None else []), left_info)

        # output kinds (for derived-table bindings in the enclosing scope)
        out_kinds: Dict[str, Optional[str]] = {}

        out_names: List[str] = []
        out_exprs: List[Tuple[str, Expr]] = []

        if has_agg:
            plan, key_names, rewrite = self._build_aggregate(
                plan, group_exprs, bound_items, having, scope, left_info)
            for i, it in enumerate(bound_items):
                name = it.alias or self._default_name(it.expr, i)
                out_kinds[name] = self._expr_kind(it.expr, scope)
                out_exprs.append((name, rewrite(it.expr)))
                out_names.append(name)
        else:
            for i, it in enumerate(bound_items):
                e = self._lower_scalar_subqueries(it.expr, scope)
                name = it.alias or self._default_name(e, i)
                out_kinds[name] = self._expr_kind(it.expr, scope)
                out_exprs.append((name, e))
                out_names.append(name)

        if len(set(out_names)) != len(out_names):
            raise SqlError(f"duplicate output column names: {out_names}")
        plan = ProjectRel(plan, out_exprs)

        if stmt.distinct:
            plan = AggregateRel(plan, list(out_names), [])

        # -- order by / limit --------------------------------------------
        if stmt.order_by:
            keys = [self._sort_key(o, out_exprs, scope) for o in stmt.order_by]
            plan = SortRel(plan, keys, limit=stmt.limit)
        elif stmt.limit is not None:
            plan = FetchRel(plan, stmt.limit)

        return plan, out_names, correlations, out_kinds

    # ------------------------------------------------------------------
    def _expr_kind(self, e: Expr, scope: Scope) -> Optional[str]:
        """Best-effort output kind of a bound expression (for derived-table
        column bindings; None = unknown, which only disables the binder's
        date-literal coercion for that column)."""
        if isinstance(e, Col):
            return scope.kind_of(e.name)
        if isinstance(e, SqlFunc):
            if e.name in ("min", "max") and e.arg is not None:
                return self._expr_kind(e.arg, scope)
            return NUMERIC
        if isinstance(e, Substr):
            return STRING
        if isinstance(e, (ExtractYear, Cast)):
            return NUMERIC
        if isinstance(e, Lit):
            return e.resolved_kind()
        if isinstance(e, (Between, InList, Like, StartsWith)):
            return BOOL
        if isinstance(e, BinOp):
            if e.op in ("and", "or") or e.op in ("==", "!=", "<", "<=", ">",
                                                 ">="):
                return BOOL
            return NUMERIC
        if isinstance(e, Case) and e.whens:
            return self._expr_kind(e.whens[0][1], scope)
        return None

    # ------------------------------------------------------------------
    def _correlation_pair(self, c: Expr) -> Optional[Tuple[str, str]]:
        if isinstance(c, BinOp) and c.op == "==":
            l, r = c.left, c.right
            if isinstance(l, Col) and isinstance(r, OuterCol):
                return (r.name, l.name)
            if isinstance(l, OuterCol) and isinstance(r, Col):
                return (l.name, r.name)
        return None

    def _lower_scalar_subqueries(self, e: Expr, scope: Scope) -> Expr:
        def visit(node: Expr) -> Expr:
            if isinstance(node, SqlSubquery):
                plan, cols, corr, _kinds = self.lower(node.select, outer=scope)
                if corr:
                    raise SqlError(
                        "correlated scalar subqueries are only supported as "
                        "the comparison operand of a WHERE conjunct")
                if len(cols) != 1:
                    raise SqlError(
                        "scalar subquery must produce exactly one column")
                return ScalarSubquery(plan, cols[0])
            return node
        return transform_expr(e, visit)

    def _join_tree(self, bindings: List[Binding], plain: List[Expr],
                   scope: Scope):
        """Greedy connectivity join over the FROM bindings.  Consumes the
        cross-binding equality conjuncts from ``plain``."""
        inner_ids = {id(b) for b in bindings}

        def is_equi(c: Expr) -> Optional[Tuple[str, str]]:
            if isinstance(c, BinOp) and c.op == "==" \
                    and isinstance(c.left, Col) and isinstance(c.right, Col):
                lb = scope.col_binding.get(c.left.name)
                rb = scope.col_binding.get(c.right.name)
                if lb and rb and lb[0] is not rb[0] \
                        and id(lb[0]) in inner_ids and id(rb[0]) in inner_ids:
                    return (c.left.name, c.right.name)
            return None

        # NB: never use list.remove / `in` on Expr lists — Expr.__eq__ builds
        # a BinOp (truthy), so equality-based removal hits the wrong element
        equi: List[Tuple[Expr, str, str]] = []
        rest: List[Expr] = []
        for c in plain:
            pair = is_equi(c)
            if pair is not None:
                equi.append((c, *pair))
            else:
                rest.append(c)
        plain[:] = rest

        plan: Rel = self._scan_for(bindings[0])
        available = set(bindings[0].eff_columns())
        remaining = list(bindings[1:])
        while remaining:
            picked = None
            for b in remaining:
                tcols = set(b.eff_columns())
                keys = [(a, bb) if a in available else (bb, a)
                        for _, a, bb in equi
                        if (a in available and bb in tcols)
                        or (bb in available and a in tcols)]
                if keys:
                    picked = (b, keys)
                    break
            if picked is None:
                raise SqlError(
                    f"disconnected join graph: no equality predicate links "
                    f"{[b.name for b in remaining]} to the joined tables "
                    "(cross joins are not supported)")
            b, keys = picked
            probe_keys = [k[0] for k in keys]
            build_keys = [k[1] for k in keys]
            plan = JoinRel(plan, self._scan_for(b), probe_keys, build_keys,
                           "inner")
            available |= set(b.eff_columns())
            used = {(a, bb) for a, bb in zip(probe_keys, build_keys)}
            equi = [e for e in equi
                    if (e[1], e[2]) not in used and (e[2], e[1]) not in used]
            remaining = [r for r in remaining if r is not b]
        # equality conjuncts that never linked a new table (both sides were
        # already available) stay as residual filters
        plain.extend(c for c, _a, _b in equi)
        return plan, available

    def _lower_left_join(self, plan: Rel, available: Set[str], b: Binding,
                         on_expr: Expr, scope: Scope,
                         left_info: List[Tuple[str, set]]):
        """LEFT OUTER JOIN lowering.  The ON condition must decompose into
        cross-side equality keys plus build-side-only predicates (pushed
        beneath the join, where they are outer-join-safe); the engine's left
        join marks matched rows with ``__matched``."""
        bound = bind_expr(on_expr, scope)
        bcols = set(b.eff_columns())
        probe_keys: List[str] = []
        build_keys: List[str] = []
        build_preds: List[Expr] = []
        for c in split_conjuncts(bound):
            if isinstance(c, BinOp) and c.op == "==" \
                    and isinstance(c.left, Col) and isinstance(c.right, Col):
                l, r = c.left.name, c.right.name
                if l in available and r in bcols:
                    probe_keys.append(l); build_keys.append(r)
                    continue
                if r in available and l in bcols:
                    probe_keys.append(r); build_keys.append(l)
                    continue
            cols = set(c.columns())
            if cols and cols <= bcols and not _contains(c, SqlSubquery):
                build_preds.append(c)
                continue
            raise SqlError(
                "LEFT JOIN ON supports equality keys plus right-side-only "
                "predicates")
        if not probe_keys:
            raise SqlError("LEFT JOIN requires at least one equality key")
        scan = self._scan_for(b)
        if build_preds:
            scan = FilterRel(scan, and_all(build_preds))
        plan = JoinRel(plan, scan, probe_keys, build_keys, "left")
        left_info.append(("__matched", bcols))
        return plan, available | bcols | {"__matched"}

    def _check_left_guard(self, exprs, left_info) -> None:
        """Reject references to a LEFT JOIN's build-side columns outside
        ``count(col)``.  The engine fills unmatched rows' build columns with
        arbitrary gathered values guarded by ``__matched``; only the
        count-rewrite consults the guard, so any other use would silently
        compute over garbage — a SqlError is the honest answer."""
        if not left_info:
            return
        bcols = set()
        for _mark, bc in left_info:
            bcols |= bc

        def visit(e: Expr) -> None:
            if isinstance(e, SqlFunc) and e.name == "count" \
                    and not e.distinct and isinstance(e.arg, Col) \
                    and e.arg.name in bcols:
                return                 # guarded: lowered to sum(case when)
            if isinstance(e, Col) and e.name in bcols:
                raise SqlError(
                    f"column {e.name!r} from a LEFT JOIN's right side can "
                    "only be used inside count(...) — unmatched rows have "
                    "no value for it")
            for child in expr_children(e):
                visit(child)

        for e in exprs:
            if e is not None:
                visit(e)

    def _lower_scalar_cmp(self, plan: Rel, available: Set[str], c: Expr,
                          scope: Scope):
        """Lower a WHERE conjunct embedding a scalar subquery.

        Uncorrelated subqueries become ``ScalarSubquery`` literals (executed
        first by the engine).  A correlated subquery must appear as one side
        of a comparison; it is decorrelated into an aggregate grouped by its
        correlation keys, inner-joined on those keys, with the comparison
        kept as a residual predicate — DuckDB's standard rewrite, and
        NULL-faithful here because a key with no group simply finds no join
        partner (sum/avg over the empty set compare as unknown in SQL).
        """
        is_cmp = (isinstance(c, BinOp)
                  and c.op in ("==", "!=", "<", "<=", ">", ">=")
                  and (isinstance(c.left, SqlSubquery)
                       ^ isinstance(c.right, SqlSubquery)))
        if not is_cmp:
            # any embedded subquery must be uncorrelated here
            return plan, self._lower_scalar_subqueries(c, scope)
        sub = c.right if isinstance(c.right, SqlSubquery) else c.left
        sub_plan, cols, corr, _kinds = self.lower(sub.select, outer=scope,
                                                  corr_group=True)
        if not corr:
            if len(cols) != 1:
                raise SqlError(
                    "scalar subquery must produce exactly one column")
            repl = ScalarSubquery(sub_plan, cols[0])
        else:
            inner_keys: List[str] = []
            key_outer: dict = {}
            for o, i in corr:
                if i in key_outer:
                    if key_outer[i] != o:
                        raise SqlError(
                            "conflicting correlation predicates on "
                            f"column {i!r}")
                    continue
                key_outer[i] = o
                inner_keys.append(i)
            missing = [key_outer[i] for i in inner_keys
                       if key_outer[i] not in available]
            if missing:
                raise SqlError(
                    f"correlated columns {missing} are not available in the "
                    "outer FROM clause")
            if len(cols) != len(inner_keys) + 1:
                raise SqlError("correlated scalar subquery must produce "
                               "exactly one column")
            tag = self.fresh("sq")
            renames = [(f"{tag}_k{j}", Col(k))
                       for j, k in enumerate(inner_keys)]
            renames.append((f"{tag}_v", Col(cols[len(inner_keys)])))
            sub_plan = ProjectRel(sub_plan, renames)
            plan = JoinRel(plan, sub_plan,
                           [key_outer[i] for i in inner_keys],
                           [f"{tag}_k{j}" for j in range(len(inner_keys))],
                           "inner")
            repl = Col(f"{tag}_v")
        if isinstance(c.right, SqlSubquery):
            other = self._lower_scalar_subqueries(c.left, scope)
            return plan, BinOp(c.op, other, repl)
        other = self._lower_scalar_subqueries(c.right, scope)
        return plan, BinOp(c.op, repl, other)

    def _lower_sub_join(self, plan: Rel, c: Expr, scope: Scope) -> Rel:
        if isinstance(c, SqlInSubquery):
            operand = bind_expr(c.operand, scope)
            if not isinstance(operand, Col):
                raise SqlError("IN (SELECT ...) requires a plain column on "
                               "the left-hand side")
            sub_plan, sub_cols, corr, _k = self.lower(c.select, outer=scope)
            if corr:
                raise SqlError("correlated IN subqueries are not supported")
            if len(sub_cols) != 1:
                raise SqlError("IN subquery must produce exactly one column")
            how = "anti" if c.negate else "semi"
            return JoinRel(plan, sub_plan, [operand.name], [sub_cols[0]], how)
        assert isinstance(c, SqlExists)
        sub_plan, _cols, corr, _k = self.lower(c.select, outer=scope,
                                               for_exists=True)
        if not corr:
            raise SqlError("EXISTS subquery must be correlated with the "
                           "outer query through an equality predicate")
        probe_keys = [outer for outer, _ in corr]
        build_keys = [inner for _, inner in corr]
        how = "anti" if c.negate else "semi"
        return JoinRel(plan, sub_plan, probe_keys, build_keys, how)

    # ------------------------------------------------------------------
    def _expand_items(self, items: List[SelectItem], available: Set[str]):
        out = []
        for it in items:
            if isinstance(it.expr, Star):
                # ``available`` holds *effective* (already-resolved) names —
                # emit bound Cols directly: re-resolving them as unqualified
                # SqlCols would fail for renamed self-join columns, and the
                # internal left-join marker is not a user-visible column
                out.extend(SelectItem(Col(c)) for c in sorted(available)
                           if not c.startswith("__"))
            else:
                out.append(it)
        return out

    def _bind_group_by(self, group_by, scope: Scope, alias_map):
        """→ list of (key_name, bound_expr)."""
        out: List[Tuple[str, Expr]] = []
        for i, g in enumerate(group_by):
            alias_name = None
            if isinstance(g, SqlCol) and g.qualifier is None \
                    and g.name in alias_map:
                alias_name = g.name
                bound = alias_map[g.name]
            else:
                bound = bind_expr(g, scope)
            if isinstance(bound, Col):
                out.append((bound.name, bound))
                continue
            # expression key: name it after the select alias when one matches
            name = alias_name
            if name is None:
                for a, e in alias_map.items():
                    if expr_equal(e, bound):
                        name = a
                        break
            out.append((name or self.fresh("key"), bound))
        return out

    def _subst_aliases(self, e: Expr, alias_map) -> Expr:
        def visit(node: Expr) -> Expr:
            if isinstance(node, SqlCol) and node.qualifier is None \
                    and node.name in alias_map:
                return alias_map[node.name]
            return node
        return transform_expr(e, visit)

    def _default_name(self, e: Expr, i: int) -> str:
        if isinstance(e, Col):
            return e.name
        return f"col{i}"

    def _build_aggregate(self, plan: Rel, group_exprs, bound_items,
                         having, scope: Scope, left_info=()):
        """Insert (pre-projection?) + AggregateRel; returns a rewriter that
        maps post-aggregation expressions onto the aggregate's output."""
        # pre-projection for expression-valued group keys
        pre: List[Tuple[str, Expr]] = []
        key_names: List[str] = []
        for name, e in group_exprs:
            key_names.append(name)
            if not isinstance(e, Col):
                pre.append((name, e))
        if pre:
            plan = ProjectRel(plan, pre, keep_input=True)

        aggs: List[AggSpec] = []

        def agg_name_for(fn_node: SqlFunc, preferred: Optional[str]) -> str:
            fn = _AGG_FN_MAP[fn_node.name]
            if fn_node.name == "count" and fn_node.arg is None:
                fn = "count_star"
            elif fn_node.name == "count" and fn_node.distinct:
                fn = "count_distinct"
            arg = None
            if fn_node.arg is not None:
                arg = self._lower_scalar_subqueries(fn_node.arg, scope)
            if fn == "count" and isinstance(arg, Col):
                # count(col) over the build side of a LEFT JOIN counts
                # matches, not rows: rewrite to sum(case when matched)
                for mark, bcols in left_info:
                    if arg.name in bcols:
                        fn = "sum"
                        arg = Case([(Col(mark), Lit(1))], Lit(0))
                        break
            for spec in aggs:
                if spec.fn == fn and expr_equal(spec.expr, arg):
                    return spec.name
            name = preferred or self.fresh("agg")
            if any(a.name == name for a in aggs):
                name = self.fresh("agg")
            aggs.append(AggSpec(fn, arg, name))
            return name

        # seed the agg list from the select items so single-agg items keep
        # their SQL alias as the aggregate's output name
        for it in bound_items:
            if isinstance(it.expr, SqlFunc) and it.alias:
                agg_name_for(it.expr, it.alias)

        rewritten_having = None
        if having is not None:
            rewritten_having = self._rewrite_post_agg(
                having, group_exprs, agg_name_for, None)
            # alias refs to agg outputs: SqlCol(alias) already substituted by
            # _subst_aliases; plain Col refs to agg names pass through
            bad = [c for c in _cols_of(rewritten_having)
                   if c not in key_names
                   and not any(a.name == c for a in aggs)]
            if bad:
                raise SqlError(f"HAVING references non-aggregated columns "
                               f"{bad}")
            rewritten_having = self._lower_scalar_subqueries(
                rewritten_having, scope)

        agg_rel = AggregateRel(plan, key_names, aggs, having=rewritten_having)

        def rewrite(e: Expr) -> Expr:
            out = self._rewrite_post_agg(e, group_exprs, agg_name_for, None)
            out = self._lower_scalar_subqueries(out, scope)
            bad = [c for c in _cols_of(out)
                   if c not in key_names
                   and not any(a.name == c for a in agg_rel.aggs)]
            if bad:
                raise SqlError(
                    f"column(s) {bad} must appear in GROUP BY or inside an "
                    "aggregate function")
            return out

        return agg_rel, key_names, rewrite

    def _rewrite_post_agg(self, e: Expr, group_exprs, agg_name_for,
                          preferred):
        """Top-down: SqlFunc subtrees → Col(agg name); group-key-matching
        subtrees → Col(key name)."""
        if isinstance(e, SqlFunc):
            return Col(agg_name_for(e, preferred))
        for name, ge in group_exprs:
            if expr_equal(e, ge):
                return Col(name)
        if not dataclasses.is_dataclass(e):
            return e
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                nv = self._rewrite_post_agg(v, group_exprs, agg_name_for,
                                            None)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, (list, tuple)) and not isinstance(v, str):
                new_items, dirty = [], False
                for item in v:
                    if isinstance(item, Expr):
                        ni = self._rewrite_post_agg(item, group_exprs,
                                                    agg_name_for, None)
                        dirty |= ni is not item
                        new_items.append(ni)
                    elif isinstance(item, tuple):
                        ni = tuple(
                            self._rewrite_post_agg(x, group_exprs,
                                                   agg_name_for, None)
                            if isinstance(x, Expr) else x for x in item)
                        dirty |= any(a is not b for a, b in zip(ni, item))
                        new_items.append(ni)
                    else:
                        new_items.append(item)
                if dirty:
                    changes[f.name] = new_items
        return dataclasses.replace(e, **changes) if changes else e

    def _sort_key(self, o: OrderItem, out_exprs, scope: Scope) -> SortKey:
        e = o.expr
        # a bare identifier naming an output column (alias or plain column)
        if isinstance(e, SqlCol) and e.qualifier is None:
            for name, _ in out_exprs:
                if name == e.name:
                    return SortKey(name, o.ascending)
        bound = bind_expr(e, scope)
        if isinstance(bound, Col):
            for name, oe in out_exprs:
                if isinstance(oe, Col) and oe.name == bound.name \
                        or name == bound.name:
                    return SortKey(name, o.ascending)
        for name, oe in out_exprs:
            if expr_equal(oe, bound):
                return SortKey(name, o.ascending)
        raise SqlError(
            "ORDER BY must reference an output column of the SELECT list")


def lower_select(stmt: SelectStmt, catalog: Optional[Catalog] = None) -> Rel:
    """Lower a bound SELECT statement to a (naive, unoptimized) plan."""
    catalog = catalog or DEFAULT_CATALOG
    plan, _cols, corr, _kinds = _Lowering(catalog).lower(stmt)
    assert not corr
    return plan
