"""Substrait-like query plan IR — counterpart of ``repro/core/plan.py``.

A tree of relational operators with embedded scalar expressions: ReadRel,
FilterRel, ProjectRel, JoinRel, AggregateRel, SortRel, FetchRel and
ExchangeRel (bypassed on a single node).  The JSON wire format, SetRel and
WindowRel belong to the Substrait slice of the port and are not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..relational.aggregate import AggSpec
from ..relational.expressions import Expr
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


def walk(plan: Rel):
    """Pre-order traversal."""
    yield plan
    for child in plan.inputs():
        yield from walk(child)


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
