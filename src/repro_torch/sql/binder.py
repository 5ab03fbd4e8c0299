"""Name resolution + light typing against the catalog — counterpart of ``repro/sql/binder.py``.

The binder rewrites parser output in three ways:

  * ``SqlCol`` → engine ``Col`` (local scope) or ``OuterCol`` (correlated
    reference to an enclosing scope, later decorrelated into join keys);
  * date coercion: a string literal compared against (or bounding a BETWEEN
    over) a DATE column becomes a DateLit, and ``date '...' ± interval``
    arithmetic is constant-folded to a DateLit — the rewrites DuckDB's
    binder performs before its optimizer runs;
  * scope bookkeeping: which FROM binding provides each column (the
    lowering pass builds the join graph from this).

The plan IR addresses columns purely by name, so every reference resolves
to a scope-unique **effective name**: the first binding to provide a source
column name keeps it; later bindings (aliased self-joins like ``nation n1,
nation n2``, colliding derived-table outputs) have theirs renamed to
``<binding>__<column>``, and the lowering inserts a renaming projection
over those scans.  Unqualified references are only valid while unambiguous;
qualified ones resolve through the binding's alias.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..data.tpch import TPCH_BASE_ROWS, TPCH_SCHEMA
from ..relational.expressions import (
    Between, BinOp, Col, Expr, Lit, transform_expr,
)
from ..relational.table import DATE, date_to_days
from .lexer import SqlError
from .nodes import IntervalLit, SqlCol


class Catalog:
    """Table schemas (column → kind), base-cardinality estimates, and —
    when attached — the string columns' dictionaries.

    Dictionaries turn the optimizer's constant string-predicate guesses
    (``SEL_LIKE`` et al.) into measured hit rates over the actual value
    domain; see ``repro_torch.optimizer.stats.selectivity``.
    """

    def __init__(self, schema: Dict[str, Dict[str, str]],
                 rows: Optional[Dict[str, float]] = None,
                 dictionaries: Optional[Dict[str, Dict[str, object]]] = None):
        self.schema = schema
        self.rows = dict(rows or {})
        # table -> column -> sorted np.ndarray of distinct values
        self.dictionaries = dict(dictionaries or {})

    @staticmethod
    def tpch(scale_factor: float = 1.0) -> "Catalog":
        rows = {t: max(r * scale_factor, 1.0) if t not in ("region", "nation")
                else float(r) for t, r in TPCH_BASE_ROWS.items()}
        return Catalog(TPCH_SCHEMA, rows)

    def has_table(self, name: str) -> bool:
        return name in self.schema

    def columns(self, table: str) -> List[str]:
        return list(self.schema[table])

    def kind(self, table: str, col: str) -> str:
        return self.schema[table][col]

    def row_estimate(self, table: str) -> float:
        return float(self.rows.get(table, 1000.0))

    # -- dictionary-informed statistics ------------------------------------
    def with_dictionaries(self, tables) -> "Catalog":
        """Copy of this catalog with string dictionaries attached.

        ``tables`` maps table name to either a loaded ``relational.Table``
        or a plain ``{column: dictionary}`` mapping (what the engine keeps —
        dictionaries are host-side, so no device table needs pinning)."""
        dicts: Dict[str, Dict[str, object]] = dict(self.dictionaries)
        for name, table in tables.items():
            if not self.has_table(name):
                continue
            if hasattr(table, "columns") and not isinstance(table, dict):
                cols = {c: col.dictionary for c, col in table.columns.items()
                        if col.dictionary is not None}
            else:
                cols = {c: d for c, d in table.items() if d is not None}
            if cols:
                dicts[name] = cols
        return Catalog(self.schema, self.rows, dicts)

    def dictionary_for(self, column: str):
        """Dictionary of a (globally unique) column name, or None.

        TPC-H and the ClickBench hits table both have globally unique
        column names, so a flat lookup is unambiguous; renamed self-join
        columns simply miss and fall back to the constant heuristics.
        """
        for cols in self.dictionaries.values():
            if column in cols:
                return cols[column]
        return None


DEFAULT_CATALOG = Catalog.tpch()


class Binding:
    """One FROM-list entry resolved against the catalog (or a pre-lowered
    derived table): its source columns, their kinds, and the scope-unique
    *effective* output names the lowering uses downstream.

    Effective names are what make self-joins work on a plan IR that
    addresses columns purely by name: the first occurrence of a source
    column name in the scope keeps it, later occurrences (``nation n2``)
    are renamed to ``<binding>__<column>`` and the lowering inserts a
    renaming projection over that scan.
    """

    def __init__(self, name: str, columns: List[str],
                 kinds: Dict[str, Optional[str]], table: Optional[str] = None,
                 plan=None):
        self.name = name              # binding (alias) name
        self.table = table            # catalog table; None for derived
        self.columns = list(columns)  # source column names
        self.kinds = dict(kinds)      # source column -> kind (or None)
        self.plan = plan              # derived table's lowered sub-plan
        self.eff: Dict[str, str] = {}  # source column -> effective name

    def eff_columns(self) -> List[str]:
        return [self.eff[c] for c in self.columns]

    @property
    def renamed(self) -> bool:
        return any(self.eff[c] != c for c in self.columns)


class Scope:
    """Binding scope: the FROM entries of one SELECT (base tables, derived
    tables and left-join tables), chained to the parent query's scope for
    correlated references.  Resolution returns *effective* column names."""

    def __init__(self, catalog: Catalog, bindings: List[Binding],
                 parent: Optional["Scope"] = None):
        self.catalog = catalog
        self.bindings = bindings
        self.parent = parent
        self.by_alias: Dict[str, Binding] = {}
        self.by_source: Dict[str, List[Binding]] = {}
        self.col_binding: Dict[str, tuple] = {}  # eff -> (binding, src col)
        for b in bindings:
            if b.name in self.by_alias:
                raise SqlError(f"duplicate table alias {b.name!r}")
            self.by_alias[b.name] = b
            for col in b.columns:
                self.by_source.setdefault(col, []).append(b)
        taken = set()
        for b in bindings:
            for col in b.columns:
                eff = col if col not in taken else f"{b.name}__{col}"
                if eff in taken:
                    raise SqlError(
                        f"cannot disambiguate column {col!r} of {b.name!r}")
                taken.add(eff)
                b.eff[col] = eff
                self.col_binding[eff] = (b, col)

    def resolve(self, qualifier: Optional[str], name: str):
        """→ ("local"|"outer", effective column name)."""
        if qualifier is not None:
            b = self.by_alias.get(qualifier)
            if b is not None:
                if name not in b.eff:
                    raise SqlError(
                        f"column {name!r} not in table {qualifier!r}")
                return "local", b.eff[name]
            if self.parent is not None:
                _, eff = self.parent.resolve(qualifier, name)
                return "outer", eff
            raise SqlError(f"unknown table alias {qualifier!r}")
        cands = self.by_source.get(name, [])
        if len(cands) == 1:
            return "local", cands[0].eff[name]
        if len(cands) > 1:
            raise SqlError(
                f"ambiguous column {name!r} (qualify it with a table alias)")
        if self.parent is not None:
            _, eff = self.parent.resolve(None, name)
            return "outer", eff
        raise SqlError(f"unknown column {name!r}")

    def kind_of(self, name: str) -> Optional[str]:
        """Kind of an *effective* column name (None when unknown)."""
        hit = self.col_binding.get(name)
        return hit[0].kinds.get(hit[1]) if hit else None


# ---------------------------------------------------------------------------
# binding rewrites
# ---------------------------------------------------------------------------

_DATE_INTERVAL_OPS = ("+", "-")


def _shift_date(days: int, amount: int, unit: str) -> int:
    import calendar
    import datetime

    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    if unit == "day":
        return int(days) + amount
    months = amount * (12 if unit == "year" else 1)
    total = d.year * 12 + (d.month - 1) + months
    y, m = divmod(total, 12)
    m += 1
    # SQL semantics: clamp to the target month's last day (Jan 31 + 1 month
    # is Feb 28/29, not an error)
    day = min(d.day, calendar.monthrange(y, m)[1])
    return date_to_days(f"{y:04d}-{m:02d}-{day:02d}")


def _parse_date(s: str) -> Optional[int]:
    """'1995-03-15' (or unpadded '1995-3-15') → days since epoch, else None."""
    import datetime

    parts = s.split("-")
    if len(parts) != 3:
        return None
    try:
        d = datetime.date(int(parts[0]), int(parts[1]), int(parts[2]))
    except ValueError:
        return None
    return date_to_days(d.isoformat())


def _date_lit(s: str) -> Lit:
    days = _parse_date(s)
    if days is None:
        raise SqlError(f"cannot compare a DATE column with non-date string "
                       f"{s!r}")
    return Lit(days, DATE)


def bind_expr(expr: Expr, scope: Scope) -> Expr:
    """Resolve columns and fold date arithmetic.  Subquery nodes are left in
    place (the lowering pass recurses into them with a child scope)."""
    from .nodes import OuterCol, SqlExists, SqlInSubquery, SqlSubquery

    def visit(e: Expr) -> Expr:
        if isinstance(e, SqlCol):
            where, col = scope.resolve(e.qualifier, e.name)
            return Col(col) if where == "local" else OuterCol(col)
        if isinstance(e, SqlInSubquery):
            # operand is bound; the subquery select binds during lowering
            return e
        if isinstance(e, (SqlSubquery, SqlExists)):
            return e
        if isinstance(e, BinOp):
            # fold: date_lit ± interval
            if e.op in _DATE_INTERVAL_OPS:
                l, r = e.left, e.right
                if isinstance(l, Lit) and l.kind == DATE \
                        and isinstance(r, IntervalLit):
                    sign = 1 if e.op == "+" else -1
                    return Lit(_shift_date(l.value, sign * r.amount, r.unit),
                               DATE)
            # coerce: DATE column compared against a string literal — a
            # non-date string here is always a type error, never a silent
            # raw-string comparison
            if e.op in ("==", "!=", "<", "<=", ">", ">="):
                l, r = e.left, e.right
                if isinstance(l, Col) and scope.kind_of(l.name) == DATE \
                        and isinstance(r, Lit) and isinstance(r.value, str):
                    return BinOp(e.op, l, _date_lit(r.value))
                if isinstance(r, Col) and scope.kind_of(r.name) == DATE \
                        and isinstance(l, Lit) and isinstance(l.value, str):
                    return BinOp(e.op, _date_lit(l.value), r)
            return e
        if isinstance(e, Between):
            v = e.operand
            if isinstance(v, Col) and scope.kind_of(v.name) == DATE:
                lo, hi = e.lo, e.hi
                changed = False
                if isinstance(lo, Lit) and isinstance(lo.value, str):
                    lo, changed = _date_lit(lo.value), True
                if isinstance(hi, Lit) and isinstance(hi.value, str):
                    hi, changed = _date_lit(hi.value), True
                if changed:
                    return Between(v, lo, hi)
            return e
        if isinstance(e, IntervalLit):
            return e                 # consumed by the BinOp fold above
        return e

    bound = transform_expr(expr, visit)
    for node in _walk_shallow(bound):
        if isinstance(node, IntervalLit):
            raise SqlError("INTERVAL is only supported added to/subtracted "
                           "from a DATE literal")
    return bound


def _walk_shallow(e: Expr):
    from ..relational.expressions import walk_expr
    yield from walk_expr(e)
