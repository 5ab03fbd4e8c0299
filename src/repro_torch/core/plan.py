"""Substrait-like query plan IR — counterpart of ``repro/core/plan.py``.

A tree of relational operators with embedded scalar expressions: ReadRel,
FilterRel, ProjectRel, JoinRel, AggregateRel, SortRel, FetchRel and
ExchangeRel (bypassed on a single node), and SetRel and WindowRel as IR
only.  ``plan_to_json`` / ``plan_from_json`` are the reference's JSON
rendering of a plan, byte for byte; the Substrait wire format is a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Tuple

from ..relational.aggregate import AggSpec
from ..relational.expressions import (
    Between, BinOp, Case, Cast, Col, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp,
)
from ..relational.sort import SortKey


class Rel:
    """Base class for plan nodes."""

    # Cardinality annotation set by repro.optimizer.annotate (class-level
    # default keeps it out of dataclass fields and the JSON wire format).
    estimated_rows: Optional[float] = None

    def inputs(self) -> List["Rel"]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Rel):
                out.append(v)
            elif isinstance(v, list):
                out.extend(x for x in v if isinstance(x, Rel))
        return out


@dataclasses.dataclass
class ReadRel(Rel):
    table: str
    columns: Optional[List[str]] = None           # projection pushdown
    filter: Optional[Expr] = None                 # predicate pushdown


@dataclasses.dataclass
class FilterRel(Rel):
    input: Rel
    condition: Expr


@dataclasses.dataclass
class ProjectRel(Rel):
    input: Rel
    exprs: List[Tuple[str, Expr]]                 # (output name, expression)
    keep_input: bool = False                      # append instead of replace


@dataclasses.dataclass
class JoinRel(Rel):
    """probe ⋈ build.  ``build`` is the pipeline breaker side (paper §3.2.2)."""
    probe: Rel
    build: Rel
    probe_keys: List[str]
    build_keys: List[str]
    how: str = "inner"                            # inner|left|semi|anti|mark
    mark_name: str = "__mark"
    post_filter: Optional[Expr] = None            # non-equi residual predicate


@dataclasses.dataclass
class AggregateRel(Rel):
    input: Rel
    group_keys: List[str]
    aggs: List[AggSpec]
    having: Optional[Expr] = None


@dataclasses.dataclass
class SortRel(Rel):
    input: Rel
    keys: List[SortKey]
    limit: Optional[int] = None


@dataclasses.dataclass
class FetchRel(Rel):
    input: Rel
    count: int


@dataclasses.dataclass
class ExchangeRel(Rel):
    """Exchange as a dedicated physical operator (paper §3.2.4)."""
    input: Rel
    kind: str                                     # shuffle|broadcast|merge|multicast
    keys: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SetRel(Rel):
    """Set operation (UNION ALL): interchange vocabulary only, not run by
    the device pipeline engine."""
    operands: List[Rel]
    op: str = "union_all"


@dataclasses.dataclass
class WindowRel(Rel):
    """Window function over partitions (no frame clause).

    ``row_number``/``rank`` rank rows within a partition by ``order_keys``;
    aggregate functions (sum/count/avg/min/max over ``arg``) broadcast the
    partition-wide value to every row.  Like SetRel, not run by the device
    pipeline engine.
    """
    input: Rel
    partition_keys: List[str]
    order_keys: List[SortKey]
    func: str                                     # row_number|rank|sum|count|avg|min|max
    arg: Optional[str] = None                     # input column (aggregates)
    name: str = "__window"


@dataclasses.dataclass
class ScalarSubquery(Expr):
    """Uncorrelated scalar subquery — executed first, bound as a literal.

    DuckDB's optimizer does the same materialization before the plan reaches
    Sirius; we keep the node so plans stay single-tree and serializable.
    """
    plan: Rel
    column: str

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# JSON serialization (the reference's plan rendering, byte for byte)
# ---------------------------------------------------------------------------

_EXPR_TYPES = {c.__name__: c for c in
               (Col, Lit, BinOp, UnOp, Between, InList, Like, StartsWith,
                Case, ExtractYear, Substr, Cast)}
_REL_TYPES = {c.__name__: c for c in
              (ReadRel, FilterRel, ProjectRel, JoinRel, AggregateRel, SortRel,
               FetchRel, ExchangeRel, SetRel, WindowRel)}


def _enc(obj: Any) -> Any:
    if isinstance(obj, ScalarSubquery):
        return {"@expr": "ScalarSubquery", "plan": _enc(obj.plan), "column": obj.column}
    if isinstance(obj, Expr):
        d = {"@expr": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = _enc(getattr(obj, f.name))
        return d
    if isinstance(obj, Rel):
        d = {"@rel": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = _enc(getattr(obj, f.name))
        return d
    if isinstance(obj, AggSpec):
        return {"@agg": True, "fn": obj.fn, "expr": _enc(obj.expr), "name": obj.name}
    if isinstance(obj, SortKey):
        return {"@sortkey": True, "name": obj.name, "ascending": obj.ascending}
    if isinstance(obj, (list, tuple)):
        return [_enc(x) for x in obj]
    return obj


def _dec(d: Any) -> Any:
    if isinstance(d, list):
        return [_dec(x) for x in d]
    if not isinstance(d, dict):
        return d
    if "@expr" in d:
        name = d.pop("@expr")
        if name == "ScalarSubquery":
            return ScalarSubquery(_dec(d["plan"]), d["column"])
        cls = _EXPR_TYPES[name]
        kwargs = {k: _dec(v) for k, v in d.items()}
        if name == "Case":
            kwargs["whens"] = [tuple(w) for w in kwargs["whens"]]
        return cls(**kwargs)
    if "@rel" in d:
        name = d.pop("@rel")
        cls = _REL_TYPES[name]
        kwargs = {k: _dec(v) for k, v in d.items()}
        if name == "ProjectRel":
            kwargs["exprs"] = [tuple(e) for e in kwargs["exprs"]]
        return cls(**kwargs)
    if d.get("@agg"):
        return AggSpec(d["fn"], _dec(d["expr"]), d["name"])
    if d.get("@sortkey"):
        return SortKey(d["name"], d["ascending"])
    return d


def plan_to_json(plan: Rel) -> str:
    return json.dumps(_enc(plan))


def plan_from_json(s: str) -> Rel:
    return _dec(json.loads(s))


def walk(plan: Rel):
    """Pre-order traversal."""
    yield plan
    for child in plan.inputs():
        yield from walk(child)


def rel_exprs(rel: Rel) -> List[Expr]:
    """All Expr objects directly attached to ``rel`` (scan filters, join
    residuals, projection expressions, aggregate measures, having...)."""
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
                elif isinstance(item, AggSpec) and isinstance(item.expr, Expr):
                    out.append(item.expr)
    return out


def walk_deep(plan: Rel):
    """Pre-order traversal that also descends into scalar-subquery sub-plans
    (``walk`` stays expression-blind)."""
    from ..relational.expressions import walk_expr

    yield plan
    for e in rel_exprs(plan):
        for node in walk_expr(e):
            if isinstance(node, ScalarSubquery):
                yield from walk_deep(node.plan)
    for child in plan.inputs():
        yield from walk_deep(child)


def _expr_str(e: Expr) -> str:
    """Compact expression rendering: scalar-subquery sub-plans are elided so
    EXPLAIN lines stay one plan node per line."""
    from ..relational.expressions import Col as _Col, transform_expr

    def strip(n):
        if isinstance(n, ScalarSubquery):
            return _Col(f"<scalar-subquery:{n.column}>")
        return n

    return repr(transform_expr(e, strip))


def explain(plan: Rel, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(plan).__name__
    extra = ""
    if isinstance(plan, ReadRel):
        extra = f" {plan.table}"
        if plan.columns:
            extra += f" cols={plan.columns}"
        if plan.filter is not None:
            extra += f" filter={_expr_str(plan.filter)}"
    elif isinstance(plan, FilterRel):
        extra = f" {_expr_str(plan.condition)}"
    elif isinstance(plan, ProjectRel):
        extra = f" {[n for n, _ in plan.exprs]}"
    elif isinstance(plan, JoinRel):
        extra = f" {plan.how} on {plan.probe_keys}={plan.build_keys}"
        if plan.post_filter is not None:
            extra += " post_filter=..."
    elif isinstance(plan, AggregateRel):
        extra = f" by {plan.group_keys} aggs={[a.name for a in plan.aggs]}"
        if plan.having is not None:
            extra += " having=..."
    elif isinstance(plan, SortRel):
        extra = " by " + ", ".join(
            k.name + ("" if k.ascending else " desc") for k in plan.keys)
        if plan.limit is not None:
            extra += f" limit={plan.limit}"
    elif isinstance(plan, ExchangeRel):
        extra = f" {plan.kind} keys={plan.keys}"
    elif isinstance(plan, SetRel):
        extra = f" {plan.op} over {len(plan.operands)} inputs"
    elif isinstance(plan, WindowRel):
        extra = f" {plan.func}"
        if plan.arg:
            extra += f"({plan.arg})"
        extra += f" partition by {plan.partition_keys}"
        if plan.order_keys:
            extra += " order by " + ", ".join(
                k.name + ("" if k.ascending else " desc")
                for k in plan.order_keys)
        extra += f" as {plan.name}"
    if plan.estimated_rows is not None:
        extra += f"  [~{plan.estimated_rows:,.0f} rows]"
    lines = [f"{pad}{name}{extra}"]
    for child in plan.inputs():
        lines.append(explain(child, indent + 1))
    return "\n".join(lines)


def plan_equal(a: Rel, b: Rel) -> bool:
    """Structural equality over plan trees.

    The dataclass-generated ``__eq__`` on Rel nodes is unusable because the
    embedded Expr nodes overload ``==`` to *build* comparison expressions;
    this compares node types and fields recursively instead.
    """
    from ..relational.expressions import expr_equal

    if type(a) is not type(b):
        return False
    if isinstance(a, AggSpec):
        return (a.fn == b.fn and a.name == b.name
                and expr_equal(a.expr, b.expr, rel_eq=plan_equal))
    if isinstance(a, SortKey):
        return a.name == b.name and a.ascending == b.ascending
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, Rel) or isinstance(vb, Rel):
            if not (isinstance(va, Rel) and isinstance(vb, Rel)
                    and plan_equal(va, vb)):
                return False
        elif isinstance(va, Expr) or isinstance(vb, Expr):
            if not expr_equal(va, vb, rel_eq=plan_equal):
                return False
        elif isinstance(va, (list, tuple)) and isinstance(vb, (list, tuple)):
            if len(va) != len(vb):
                return False
            for xa, xb in zip(va, vb):
                if isinstance(xa, Rel):
                    if not (isinstance(xb, Rel) and plan_equal(xa, xb)):
                        return False
                elif isinstance(xa, (AggSpec, SortKey)):
                    if not plan_equal(xa, xb):
                        return False
                elif not expr_equal(xa, xb, rel_eq=plan_equal):
                    return False
        elif va != vb:
            return False
    return True
