"""The port's SQL frontend and optimizer against the JAX package.

For the 22 TPC-H ``SQL_QUERIES`` (default catalog) and the 15
``CLICKBENCH_QUERIES`` (the ClickBench catalog with the string dictionaries
of a 20,000-row sample attached, as ``SiriusEngine.sql`` attaches them),
the naive and the optimized plans print byte for byte the reference's
``explain`` text, cardinality annotations included; and errors carry the
reference's message and caret.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest

from repro.core.plan import explain as ref_explain
from repro.data import clickbench as ref_cb
from repro.data.tpch_queries import SQL_QUERIES as REF_SQL_QUERIES
from repro.sql import SqlError as RefSqlError
from repro.sql import sql_to_plan as ref_sql_to_plan
from repro_torch.core.plan import explain, plan_equal
from repro_torch.data import clickbench as cb
from repro_torch.data.tpch_queries import SQL_PUSHDOWN_QIDS, SQL_QUERIES
from repro_torch.relational.table import Table
from repro_torch.sql import (
    EXPLAIN_ANALYZE_RE, SqlError, explain_sql, run_sql, sql_to_plan,
)

N_ROWS = 20_000


def test_query_texts_are_the_reference_texts():
    assert SQL_QUERIES == REF_SQL_QUERIES
    assert cb.CLICKBENCH_QUERIES == ref_cb.CLICKBENCH_QUERIES
    assert cb.CLICKBENCH_STRING_QIDS == ref_cb.CLICKBENCH_STRING_QIDS
    assert cb.CLICKBENCH_SCHEMA == ref_cb.CLICKBENCH_SCHEMA
    assert SQL_PUSHDOWN_QIDS == tuple(q for q in sorted(SQL_QUERIES) if q != 18)


@pytest.fixture(scope="module")
def cb_catalogs():
    """(port catalog, reference catalog), both with the same dictionaries."""
    hits = Table.from_pydict(cb.generate(N_ROWS)["hits"])
    dicts = {"hits": {c: col.dictionary for c, col in hits.columns.items()
                      if col.dictionary is not None}}
    return (cb.clickbench_catalog(N_ROWS).with_dictionaries(dicts),
            ref_cb.clickbench_catalog(N_ROWS).with_dictionaries(dicts))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("qid", sorted(SQL_QUERIES))
def test_tpch_plan_text_matches_reference(qid, optimize):
    sql = SQL_QUERIES[qid]
    got = explain(sql_to_plan(sql, optimize=optimize))
    assert got == ref_explain(ref_sql_to_plan(sql, optimize=optimize))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("qid", list(cb.CLICKBENCH_QUERIES))
def test_clickbench_plan_text_matches_reference(qid, optimize, cb_catalogs):
    cat, ref_cat = cb_catalogs
    sql = cb.CLICKBENCH_QUERIES[qid]
    got = explain(sql_to_plan(sql, cat, optimize=optimize))
    assert got == ref_explain(ref_sql_to_plan(sql, ref_cat, optimize=optimize))


def test_dictionaries_steer_string_selectivity(cb_catalogs):
    """q20's LIKE is costed by its dictionary hit rate, not the constant."""
    cat, _ = cb_catalogs
    sql = cb.CLICKBENCH_QUERIES["q20"]
    with_dicts = explain(sql_to_plan(sql, cat))
    without = explain(sql_to_plan(sql, cb.clickbench_catalog(N_ROWS)))
    assert with_dicts != without


@pytest.mark.parametrize("sql,caret_col", [
    ("select from t", 7),
    ("select a from t where", 21),
    ("select a from t limit 1.5", 22),
    ("select 'abc from t", 7),
    ("select a # b from lineitem", 9),
])
def test_errors_point_where_the_reference_points(sql, caret_col):
    with pytest.raises(SqlError) as mine:
        sql_to_plan(sql)
    with pytest.raises(RefSqlError) as theirs:
        ref_sql_to_plan(sql)
    assert str(mine.value) == str(theirs.value)
    line, caret = str(mine.value).splitlines()[1:3]
    assert line == "  " + sql and caret == "  " + " " * caret_col + "^"


@pytest.mark.parametrize("sql,match", [
    ("select l_foo from lineitem", "unknown column 'l_foo'"),
    ("select a from nosuch", "unknown table 'nosuch'"),
    ("select l_quantity from lineitem l, lineitem l", "duplicate table alias"),
])
def test_bind_errors_match_reference(sql, match):
    with pytest.raises(SqlError, match=match) as mine:
        sql_to_plan(sql)
    with pytest.raises(RefSqlError) as theirs:
        ref_sql_to_plan(sql)
    assert str(mine.value) == str(theirs.value)


def test_optimize_is_pure_and_plans_compare_structurally():
    sql = SQL_QUERIES[5]
    naive = sql_to_plan(sql, optimize=False)
    before = explain(naive)
    from repro_torch.optimizer import optimize
    opt = optimize(naive)
    assert explain(naive) == before
    assert plan_equal(naive, sql_to_plan(sql, optimize=False))
    assert not plan_equal(naive, opt)
    assert plan_equal(opt, sql_to_plan(sql))


def test_explain_sql_shows_both_plans():
    text = explain_sql(SQL_QUERIES[6])
    assert text.startswith("-- naive plan --\n")
    assert "\n-- optimized plan --\n" in text and "rows]" in text


def test_unported_entry_points_say_what_is_missing():
    """EXPLAIN ANALYZE needs an engine that profiles: on anything without
    ``sql`` (host data, a FallbackEngine) ``run_sql`` says so, as the
    reference does (tests/test_torch_observability.py runs it on an
    engine); a host-format database runs on the port's FallbackEngine
    (tests/test_torch_fallback.py)."""
    assert EXPLAIN_ANALYZE_RE.match("  EXPLAIN analyze select 1")
    with pytest.raises(SqlError, match="EXPLAIN ANALYZE requires a profiling"):
        run_sql("explain analyze " + SQL_QUERIES[6], object())
    with pytest.raises(SqlError, match="got dict"):
        run_sql("explain analyze " + SQL_QUERIES[6], {"lineitem": {}})
    lineitem = {"l_shipdate": np.array(["1994-06-01"], "datetime64[D]"),
                "l_discount": np.array([0.06]), "l_quantity": np.array([1.0]),
                "l_extendedprice": np.array([100.0])}
    out = run_sql(SQL_QUERIES[6], {"lineitem": lineitem})
    np.testing.assert_allclose(out["revenue"], [6.0])
