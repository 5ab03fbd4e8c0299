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
    if plan.estimated_rows is not None:
        extra += f"  [~{plan.estimated_rows:,.0f} rows]"
    lines = [f"{pad}{name}{extra}"]
    for child in plan.inputs():
        lines.append(explain(child, indent + 1))
    return "\n".join(lines)
