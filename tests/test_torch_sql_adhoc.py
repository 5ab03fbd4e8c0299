"""The port's SQL frontend against the JAX reference on the ad hoc cases of
``tests/test_sql.py``, on the same text.

* Lexer and parser: the tokens of a text (kinds, values, positions) and
  the parse trees of precedence, predicates, aggregates with CASE, and
  qualified columns equal the reference's node for node; the reference
  test's own claims hold on the port's tree.  (Error positions of the
  parser: ``tests/test_torch_sql.py::test_errors_point_where_the_reference_points``.)
* Binder and lowering: each rejected text raises the reference's message,
  and each naive plan (LEFT JOIN lowering, date coercion and INTERVAL,
  semi and anti joins from IN / NOT EXISTS, a correlated scalar subquery)
  prints the reference's ``plan_to_json``.
* End to end at SF0.01: every ad hoc query gives the reference's rows (the
  reference on its numpy ``FallbackEngine``, the port on its own
  ``FallbackEngine`` and on ``SiriusEngine(device="cpu")``), with the
  reference test's own checks on the port's rows; re-registering a table
  drops its stale dictionaries in both packages.
"""
import dataclasses

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.executor import SiriusEngine as RefSiriusEngine
from repro.core.plan import plan_to_json as ref_plan_to_json
from repro.relational.table import Table as RefTable
from repro.sql import SqlError as RefSqlError
from repro.sql import parse_sql as ref_parse_sql
from repro.sql import run_sql as ref_run_sql
from repro.sql import sql_to_plan as ref_sql_to_plan
from repro.sql import tokenize as ref_tokenize
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.plan import (
    AggregateRel, JoinRel, plan_equal, plan_to_json, walk,
)
from repro_torch.data.tpch import load_into_engine
from repro_torch.relational.expressions import (
    BinOp, InList, Like, Lit, walk_expr,
)
from repro_torch.relational.table import Table
from repro_torch.sql import SqlError, parse_sql, run_sql, sql_to_plan, tokenize
from repro_torch.sql.nodes import SqlCol, SqlExists, SqlFunc

from conftest import assert_tables_equal

torch.set_num_threads(1)


def _tree(obj):
    """A parse or plan node as nested tuples: class name and fields (the
    nodes overload ``==`` to build expressions, so they are compared so)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _tree(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_tree(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return tuple(obj.tolist())
    return obj


# ---------------------------------------------------------------------------
# lexer and parser
# ---------------------------------------------------------------------------


def test_tokenize_basics():
    text = "select a, 'it''s' , 1.5 <= x -- comment\nfrom t"
    toks = tokenize(text)
    assert [_tree(t) for t in toks] == [_tree(t) for t in ref_tokenize(text)]
    kinds = [(t.kind, t.value) for t in toks[:-1]]
    assert ("kw", "select") in kinds
    assert ("str", "it's") in kinds
    assert ("num", 1.5) in kinds
    assert ("op", "<=") in kinds
    assert all(v != "comment" for _, v in kinds)


def _flat_and(e, out):
    if isinstance(e, BinOp) and e.op == "and":
        _flat_and(e.left, out)
        _flat_and(e.right, out)
    else:
        out.append(e)
    return out


def check_precedence(stmt):
    item = stmt.items[0].expr
    assert isinstance(item, BinOp) and item.op == "+"          # * binds tighter
    assert isinstance(item.right, BinOp) and item.right.op == "*"
    w = stmt.where
    assert isinstance(w, BinOp) and w.op == "or"               # and over or
    assert isinstance(w.right, BinOp) and w.right.op == "and"


def check_predicates(stmt):
    conjs = _flat_and(stmt.where, [])
    assert any(isinstance(c, InList) and c.negate for c in conjs)
    assert any(isinstance(c, Like) and not c.negate for c in conjs)
    assert any(isinstance(c, Like) and c.negate for c in conjs)
    assert any(isinstance(c, SqlExists) and c.negate for c in conjs)


def check_agg_and_case(stmt):
    assert isinstance(stmt.items[0].expr, SqlFunc)
    assert stmt.items[0].expr.arg is None
    assert stmt.order_by[0].ascending is False
    assert stmt.limit == 5


def check_qualified(stmt):
    e = stmt.items[0].expr
    assert isinstance(e, SqlCol) and e.qualifier == "o"


PARSE_CASES = {
    "precedence_and_shapes": (
        "select a + b * 2 from lineitem where x = 1 or y = 2 and z = 3",
        check_precedence),
    "predicates": (
        "select * from t where a between 1 and 2 and b not in (1, 2) "
        "and c like 'x%' and d not like '%y' and not exists "
        "(select * from u where u1 = a)", check_predicates),
    "agg_and_case": (
        "select count(*) c, sum(case when x > 0 then 1 else 0 end) s "
        "from t group by g order by c desc limit 5", check_agg_and_case),
    "qualified_and_bare_columns": (
        "select o.o_orderkey, l_quantity from orders o, lineitem "
        "where o.o_orderkey = l_orderkey", check_qualified),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_trees_equal_the_reference(case):
    text, check = PARSE_CASES[case]
    stmt = parse_sql(text)
    assert _tree(stmt) == _tree(ref_parse_sql(text))
    check(stmt)


# ---------------------------------------------------------------------------
# binder and lowering
# ---------------------------------------------------------------------------


REJECTED = [
    ("select x from nosuch", "unknown table"),
    ("select nope from lineitem", "unknown column"),
    ("select n_name from nation, nation", "duplicate table alias"),
    ("select n_name from nation n1, nation n2, region "
     "where n1.n_regionkey = r_regionkey and n2.n_regionkey = r_regionkey",
     "ambiguous column"),
    ("select c from (select count(*) as c from nation)", "alias"),
    ("select c_custkey, sum(o_totalprice) as s from customer left outer join "
     "orders on c_custkey = o_custkey group by c_custkey", "LEFT JOIN"),
    ("select c_custkey, o_orderkey from customer left outer join orders "
     "on c_custkey = o_custkey", "LEFT JOIN"),
    ("select c_custkey from customer left outer join orders "
     "on c_custkey = o_custkey where o_totalprice > 0", "LEFT JOIN"),
    ("select c_custkey from customer "
     "left outer join orders on c_custkey = o_custkey "
     "left outer join nation on c_nationkey = n_nationkey",
     "at most one LEFT JOIN"),
    ("select n_name from nation, region where n_name = 'X'", "disconnected"),
]


@pytest.mark.parametrize("sql,match", REJECTED)
def test_rejected_texts_raise_the_reference_error(sql, match):
    with pytest.raises(SqlError, match=match) as mine:
        sql_to_plan(sql)
    with pytest.raises(RefSqlError) as theirs:
        ref_sql_to_plan(sql)
    assert str(mine.value) == str(theirs.value)


def _joins(plan):
    return [r for r in walk(plan) if isinstance(r, JoinRel)]


def check_left_join(plan):
    joins = _joins(plan)
    assert len(joins) == 1 and joins[0].how == "left"


def check_date_coercion(plan):
    lits = [n for r in walk(plan) if hasattr(r, "condition")
            for n in walk_expr(r.condition) if isinstance(n, Lit)]
    assert any(lit.kind == "date" for lit in lits)


def check_semi(plan):
    (j,) = _joins(plan)
    assert j.how == "semi"
    assert j.probe_keys == ["o_orderkey"] and j.build_keys == ["l_orderkey"]


def check_anti(plan):
    (j,) = _joins(plan)
    assert j.how == "anti" and j.probe_keys == ["c_custkey"]


CORRELATED = ("select c_custkey from customer where c_acctbal > "
              "(select min(o_totalprice) from orders "
              "where o_custkey = c_custkey) order by c_custkey")


def check_correlated(plan):
    aggs = [r for r in walk(plan) if isinstance(r, AggregateRel)]
    assert any(j.how == "inner" for j in _joins(plan))
    assert any(a.group_keys == ["o_custkey"] for a in aggs)


NAIVE_PLANS = {
    "left_join_lowering": (
        "select c_custkey, count(o_orderkey) as n from customer left outer "
        "join orders on c_custkey = o_custkey group by c_custkey",
        check_left_join),
    "date_coercion": ("select l_orderkey from lineitem "
                      "where l_shipdate < '1995-03-15'", check_date_coercion),
    "interval": ("select o_orderkey from orders where "
                 "o_orderdate < date '1993-10-01' + interval '3' month",
                 check_date_coercion),
    "semi_join_from_in": (
        "select o_orderpriority from orders where o_orderkey in "
        "(select l_orderkey from lineitem)", check_semi),
    "anti_join_from_not_exists": (
        "select c_name from customer where not exists "
        "(select * from orders where o_custkey = c_custkey)", check_anti),
    "correlated_scalar_subquery": (CORRELATED, check_correlated),
}


@pytest.mark.parametrize("case", list(NAIVE_PLANS))
def test_naive_plans_equal_the_reference(case):
    sql, check = NAIVE_PLANS[case]
    plan = sql_to_plan(sql, optimize=False)
    assert plan_to_json(plan) == ref_plan_to_json(
        ref_sql_to_plan(sql, optimize=False))
    check(plan)


def test_interval_folds_into_the_date():
    a = sql_to_plan("select o_orderkey from orders where "
                    "o_orderdate < date '1993-10-01' + interval '3' month",
                    optimize=False)
    b = sql_to_plan("select o_orderkey from orders where "
                    "o_orderdate < date '1994-01-01'", optimize=False)
    assert plan_equal(a, b)


# ---------------------------------------------------------------------------
# end to end at SF0.01
# ---------------------------------------------------------------------------


def check_self_join(out, db):
    assert len(out["a"]) == 10          # C(5,2) pairs of AMERICA nations
    assert (np.asarray(out["a"], "U") < np.asarray(out["b"], "U")).all()


def check_two_level(out, db):
    assert int(sum(out["n_regions"])) == 5      # 5 regions, 25 nations


def check_left_join_counts(out, db):
    assert len(out["c_custkey"]) == len(db["customer"]["c_custkey"])
    assert int(np.sum(out["n"])) == len(db["orders"]["o_orderkey"])
    # dbgen: customers whose key is a multiple of 3 place no orders
    zero = np.asarray(out["c_custkey"])[np.asarray(out["n"]) == 0]
    assert (zero % 3 == 0).all() and len(zero) > 0


def check_correlated_rows(out, db):
    orders, cust = db["orders"], db["customer"]
    keys, inv = np.unique(orders["o_custkey"], return_inverse=True)
    mins = np.full(len(keys), np.inf)
    np.minimum.at(mins, inv, orders["o_totalprice"])
    mn = dict(zip(keys, mins))
    want = np.array(sorted(
        ck for ck, bal in zip(cust["c_custkey"], cust["c_acctbal"])
        if ck in mn and bal > mn[ck]))
    assert len(want) > 0 and (np.asarray(out["c_custkey"]) == want).all()


def check_count(out, db):
    assert int(out["n"][0]) == 25


ADHOC = ("select n_name, count(*) as suppliers, sum(s_acctbal) as total "
         "from supplier, nation where s_nationkey = n_nationkey "
         "and s_acctbal > 0 group by n_name order by total desc limit 5")


def check_adhoc(out, db):
    assert len(out["n_name"]) == 5
    totals = np.asarray(out["total"])
    assert (totals[:-1] >= totals[1:]).all()


def check_distinct(out, db):
    assert sorted(np.asarray(out["l_returnflag"]).tolist()) == ["A", "N", "R"]


ROW_CASES = {
    "self_join_with_aliases": (
        "select n1.n_name as a, n2.n_name as b "
        "from nation n1, nation n2, region "
        "where n1.n_regionkey = r_regionkey and n2.n_regionkey = r_regionkey "
        "and r_name = 'AMERICA' and n1.n_name < n2.n_name order by a, b",
        check_self_join),
    "derived_table_two_level_aggregate": (
        "select cnt, count(*) as n_regions "
        "from (select r_regionkey, count(*) as cnt from nation, region "
        "      where n_regionkey = r_regionkey group by r_regionkey) "
        "     as per_region group by cnt order by cnt", check_two_level),
    "left_join_count_rewrite": (
        "select c_custkey, count(o_orderkey) as n "
        "from customer left outer join orders on c_custkey = o_custkey "
        "group by c_custkey order by c_custkey", check_left_join_counts),
    "correlated_scalar_subquery": (CORRELATED, check_correlated_rows),
    "run_sql_on_host_dict": ("select count(*) as n from nation", check_count),
    "run_sql_adhoc_query": (ADHOC, check_adhoc),
    "select_distinct": ("select distinct l_returnflag from lineitem "
                        "order by l_returnflag", check_distinct),
}


@pytest.fixture(scope="module")
def port_engine(tpch_db):
    eng = SiriusEngine(device="cpu")
    load_into_engine(eng, tpch_db)
    return eng


@pytest.mark.parametrize("where", ["fallback", "engine"])
@pytest.mark.parametrize("case", list(ROW_CASES))
def test_rows_equal_the_reference(case, where, tpch_db, port_engine):
    sql, check = ROW_CASES[case]
    want = ref_run_sql(sql, tpch_db)
    if where == "fallback":
        got = run_sql(sql, tpch_db)
    else:
        got = run_sql(sql, port_engine).to_host()
    assert_tables_equal(got, want)
    check(got, tpch_db)


def test_adhoc_optimized_rows_equal_naive_rows(tpch_db):
    assert_tables_equal(run_sql(ADHOC, tpch_db),
                        run_sql(ADHOC, tpch_db, optimize=False))


def test_reregister_drops_stale_dictionaries():
    first = {"s": np.array(["a", "b"]), "k": np.array([1, 2])}
    second = {"k": np.array([1, 2, 3])}
    eng, ref = SiriusEngine(device="cpu"), RefSiriusEngine()
    eng.register("t", Table.from_pydict(first))
    ref.register("t", RefTable.from_pydict(first))
    assert "t" in eng.table_dictionaries and "t" in ref.table_dictionaries
    eng.register("t", Table.from_pydict(second))
    ref.register("t", RefTable.from_pydict(second))
    assert "t" not in eng.table_dictionaries
    assert "t" not in ref.table_dictionaries
