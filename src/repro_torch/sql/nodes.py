"""SQL AST — counterpart of ``repro/sql/nodes.py``.

Scalar expressions reuse the engine's own Expr algebra
(``repro_torch.relational.expressions``) so parse output composes directly with the
plan IR; SQL-only constructs (unresolved column refs, aggregate calls,
subqueries, intervals) are Expr subclasses that the binder and the lowering
pass eliminate.  Statement-level nodes (SELECT and its clauses) are plain
dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..relational.expressions import Expr

AGG_FUNCS = ("sum", "avg", "min", "max", "count")


# ---------------------------------------------------------------------------
# SQL-only expression leaves (eliminated by binding/lowering)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SqlCol(Expr):
    """Unresolved column reference, optionally qualified by a table alias."""
    qualifier: Optional[str]
    name: str


@dataclasses.dataclass(eq=False)
class OuterCol(Expr):
    """Binder-resolved reference to a column of an *enclosing* query scope
    (a correlated reference, decorrelated into join keys during lowering)."""
    name: str


@dataclasses.dataclass(eq=False)
class SqlFunc(Expr):
    """Aggregate call; ``arg`` None means count(*)."""
    name: str
    arg: Optional[Expr]
    distinct: bool = False


@dataclasses.dataclass(eq=False)
class IntervalLit(Expr):
    """INTERVAL 'n' unit — only valid added to / subtracted from a date
    literal; folded to a DateLit by the binder."""
    amount: int
    unit: str                       # year | month | day


@dataclasses.dataclass(eq=False)
class Star(Expr):
    """The ``*`` select item (only meaningful under EXISTS or bare SELECT)."""


@dataclasses.dataclass(eq=False)
class SqlSubquery(Expr):
    """Scalar subquery: (SELECT single-expr FROM ...)."""
    select: "SelectStmt"


@dataclasses.dataclass(eq=False)
class SqlExists(Expr):
    select: "SelectStmt"
    negate: bool = False


@dataclasses.dataclass(eq=False)
class SqlInSubquery(Expr):
    operand: Expr
    select: "SelectStmt"
    negate: bool = False


# ---------------------------------------------------------------------------
# statement nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TableRef:
    """A FROM-list entry: a base table or a derived table (FROM subquery).

    For a derived table ``name`` equals the (mandatory) alias and
    ``subquery`` holds the parsed SELECT; the lowering pass lowers it first
    and binds its output columns like a base table's."""
    name: str
    alias: Optional[str] = None
    subquery: Optional["SelectStmt"] = None

    @property
    def binding_name(self) -> str:
        return self.alias or self.name


@dataclasses.dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclasses.dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True


@dataclasses.dataclass
class SelectStmt:
    items: List[SelectItem]
    from_tables: List[TableRef]
    where: Optional[Expr] = None
    group_by: List[Expr] = dataclasses.field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
    # LEFT OUTER JOIN entries: (table, ON condition).  Kept separate from
    # from_tables because their ON predicates must NOT fold into WHERE.
    left_joins: List[tuple] = dataclasses.field(default_factory=list)
