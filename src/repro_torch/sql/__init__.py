"""SQL frontend — counterpart of ``repro/sql/__init__.py``.

    sql text ── tokenize ─▶ parse ─▶ bind ─▶ lower ─▶ naive plan IR
                                   (repro_torch.optimizer.optimize) ─▶ optimized IR
                                   (SiriusEngine.execute / FallbackEngine) ─▶ rows

Supported SQL (the TPC-H + ClickBench surface): SELECT [DISTINCT] with
joins (comma / INNER JOIN ON / LEFT OUTER JOIN ON), aliased self-joins,
derived tables in FROM, WHERE / GROUP BY (incl. expression keys) / HAVING /
ORDER BY / LIMIT, aggregates (sum, avg, min, max, count, count(distinct)),
subqueries (IN / NOT IN, EXISTS / NOT EXISTS, scalar — correlated scalar
comparisons are decorrelated DuckDB-style), CASE, CAST, EXTRACT(YEAR),
date/interval arithmetic, and the string functions LIKE (with backslash
escapes), substring(col, start, len) and starts_with(col, 'prefix').

Entry points (this module):
  * ``sql_to_plan(sql, catalog=None, optimize=True)`` — SQL text →
    (optimized) plan IR;
  * ``sql_to_wire(sql, catalog=None, optimize=True)`` — SQL text → the
    Substrait-style wire plan, byte for byte the reference's;
  * ``run_sql(sql, db, catalog=None, optimize=True)`` — end-to-end
    execution on a ``SiriusEngine`` (device ``Table`` result), a
    ``FallbackEngine`` or a host-format dict-of-dicts (host dict result);
  * ``explain_sql(sql, catalog=None)`` — naive and optimized plans side by
    side with cardinality annotations;
  * ``EXPLAIN ANALYZE <query>`` — recognized as a prefix by ``run_sql`` and
    ``SiriusEngine.sql``: the query runs with per-operator telemetry and
    the ``QueryProfile`` comes back instead of the rows.

``Catalog`` supplies table schemas, row estimates and (optionally, via
``Catalog.with_dictionaries``) string dictionaries for the optimizer's
dictionary-informed selectivity.  ``DEFAULT_CATALOG`` is TPC-H at SF 1;
the ClickBench catalog comes from ``repro_torch.data.clickbench``.
"""
from __future__ import annotations

import re
from typing import Optional

from ..core.plan import Rel, explain
from .binder import Catalog, DEFAULT_CATALOG
from .lexer import SqlError, tokenize
from .lower import lower_select
from .parser import parse_sql

__all__ = [
    "Catalog", "EXPLAIN_ANALYZE_RE", "SqlError", "explain_sql", "parse_sql",
    "run_sql", "sql_to_plan", "sql_to_wire", "tokenize",
]

# ``EXPLAIN ANALYZE`` is an entry-point prefix, not grammar: the statement
# after it parses unchanged, so the lexer/parser never see the keywords.
EXPLAIN_ANALYZE_RE = re.compile(r"^\s*explain\s+analyze\b", re.IGNORECASE)


def sql_to_plan(sql: str, catalog: Optional[Catalog] = None,
                optimize: bool = True) -> Rel:
    """Parse + bind + lower SQL text to plan IR.

    Args:
        sql: a single SELECT statement (trailing ``;`` allowed).
        catalog: table schemas / stats to bind against (default: TPC-H).
        optimize: run the rule-based optimizer passes; with False the
            naive lowering is returned (full-width scans, FROM-order join
            tree, one residual FilterRel) — the optimizer A/B baseline.

    Raises:
        SqlError: on lexical, syntactic or binding errors, with a caret
            pointing into the source text where possible.
    """
    plan = lower_select(parse_sql(sql), catalog or DEFAULT_CATALOG)
    if optimize:
        from ..optimizer import optimize as _optimize
        plan = _optimize(plan, catalog or DEFAULT_CATALOG)
    return plan


def sql_to_wire(sql: str, catalog: Optional[Catalog] = None,
                optimize: bool = True) -> dict:
    """SQL text → Substrait-style wire plan (the host-database producer).

    Parse, bind, lower, optimize, then serialize through
    ``repro_torch.substrait.emit`` so the plan can cross a process/system
    boundary and be handed to ``SiriusEngine.accelerate`` (or any other
    consumer).  Serialize the returned dict canonically with
    ``repro_torch.substrait.wire_bytes``.
    """
    from ..substrait import emit

    cat = catalog or DEFAULT_CATALOG
    return emit(sql_to_plan(sql, cat, optimize), cat)


def run_sql(sql: str, db, catalog: Optional[Catalog] = None,
            optimize: bool = True):
    """Execute SQL text against ``db`` (parse → optimize → execute).

    ``db`` is where to run:
      * a ``SiriusEngine``: the result is a device ``Table`` (call
        ``.to_host()`` for numpy columns).  Prefer ``SiriusEngine.sql``,
        which also attaches the loaded tables' dictionaries to the catalog;
      * a ``FallbackEngine``: the numpy engine; returns a host-format dict;
      * ``dict[table] -> dict[col] -> np.ndarray``: host data, run on a
        fresh ``FallbackEngine``.

    ``EXPLAIN ANALYZE <query>`` delegates to ``db.sql`` (the engine that
    profiles) and returns the ``QueryProfile``; a host dict or a
    ``FallbackEngine`` has no operator clock and raises ``SqlError``.
    """
    from ..core.fallback import FallbackEngine

    if EXPLAIN_ANALYZE_RE.match(sql):
        if hasattr(db, "sql"):
            return db.sql(sql, catalog=catalog, optimize=optimize)
        raise SqlError("EXPLAIN ANALYZE requires a profiling engine "
                       "(SiriusEngine); got " + type(db).__name__)
    plan = sql_to_plan(sql, catalog, optimize)
    if isinstance(db, dict):
        return FallbackEngine(db).execute(plan)
    return db.execute(plan)


def explain_sql(sql: str, catalog: Optional[Catalog] = None) -> str:
    """EXPLAIN: the naive lowered plan and the optimized plan side by side."""
    naive = sql_to_plan(sql, catalog, optimize=False)
    optimized = sql_to_plan(sql, catalog, optimize=True)
    return ("-- naive plan --\n" + explain(naive)
            + "\n-- optimized plan --\n" + explain(optimized))
