"""SQL frontend — counterpart of ``repro/sql/__init__.py``.

    sql text ── tokenize ─▶ parse ─▶ bind ─▶ lower ─▶ naive plan IR
                                   (repro_torch.optimizer.optimize) ─▶ optimized IR
                                   (SiriusEngine.execute) ─▶ device Table

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
  * ``run_sql(sql, engine, catalog=None, optimize=True)`` — end-to-end
    execution on a ``SiriusEngine`` (device ``Table`` result);
  * ``explain_sql(sql, catalog=None)`` — naive and optimized plans side by
    side with cardinality annotations.

Not ported yet, and raising ``NotImplementedError`` where the reference
would use them: host-format databases (they need ``core/fallback.py``'s
``FallbackEngine``), ``EXPLAIN ANALYZE`` (it needs
``observability/profile.py``'s ``QueryProfile``) and ``sql_to_wire``
(the Substrait boundary).

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
    "run_sql", "sql_to_plan", "tokenize",
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


def run_sql(sql: str, db, catalog: Optional[Catalog] = None,
            optimize: bool = True):
    """Execute SQL text on the engine ``db`` (parse → optimize → execute).

    ``db`` is a ``SiriusEngine``; the result is a device ``Table`` (call
    ``.to_host()`` for numpy columns).  Prefer ``SiriusEngine.sql``, which
    also attaches the loaded tables' dictionaries to the catalog.
    """
    if EXPLAIN_ANALYZE_RE.match(sql):
        raise NotImplementedError(
            "EXPLAIN ANALYZE needs QueryProfile (observability/profile.py), "
            "which is not ported yet")
    if isinstance(db, dict):
        raise NotImplementedError(
            "running SQL on a host-format database needs FallbackEngine "
            "(core/fallback.py), which is not ported yet; load the tables "
            "into a SiriusEngine instead")
    return db.execute(sql_to_plan(sql, catalog, optimize))


def explain_sql(sql: str, catalog: Optional[Catalog] = None) -> str:
    """EXPLAIN: the naive lowered plan and the optimized plan side by side."""
    naive = sql_to_plan(sql, catalog, optimize=False)
    optimized = sql_to_plan(sql, catalog, optimize=True)
    return ("-- naive plan --\n" + explain(naive)
            + "\n-- optimized plan --\n" + explain(optimized))
