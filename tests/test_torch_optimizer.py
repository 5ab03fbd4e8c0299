"""The port's rule-based optimizer against the JAX reference's, rule by rule.

Every case of ``tests/test_optimizer.py`` runs here on both packages: each
input plan is built from one description with each package's own IR
classes, the reference's rule and the port's run on their own copy, and
the outputs must print the same ``plan_to_json`` and ``explain`` text,
cardinality annotations included; the reference test's own assertions
then hold on the port's output.  ``optimize`` on the 22 hand-built TPC-H
plans gives the reference's plans byte for byte, keeps their rows (the
port's numpy ``FallbackEngine`` against the reference's, at SF0.01) and
leaves its input untouched.
"""
import types

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest

import repro.core.plan as ref_plan
import repro.optimizer as ref_optimizer
import repro.optimizer.rules as ref_rules
import repro.relational.aggregate as ref_aggregate
import repro.relational.expressions as ref_expressions
import repro_torch.core.plan as port_plan
import repro_torch.optimizer as port_optimizer
import repro_torch.optimizer.rules as port_rules
import repro_torch.relational.aggregate as port_aggregate
import repro_torch.relational.expressions as port_expressions
from repro.core.fallback import FallbackEngine as RefFallbackEngine
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.sql.binder import DEFAULT_CATALOG as REF_CAT
from repro_torch.core.fallback import FallbackEngine
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.sql.binder import DEFAULT_CATALOG as CAT

from conftest import assert_tables_equal


def _ns(plan, optimizer, rules, aggregate, expressions, cat):
    return types.SimpleNamespace(
        **{n: getattr(plan, n) for n in (
            "AggregateRel", "FilterRel", "JoinRel", "ProjectRel", "ReadRel",
            "SortRel", "explain", "plan_to_json", "plan_equal")},
        **{n: getattr(optimizer, n) for n in (
            "annotate", "estimate", "optimize", "rel_columns")},
        **{n: getattr(rules, n) for n in (
            "choose_build_sides", "fold_constants", "order_conjuncts",
            "prune_projections", "pushdown_predicates", "reorder_joins")},
        AggSpec=aggregate.AggSpec, BinOp=expressions.BinOp,
        Col=expressions.Col, Lit=expressions.Lit, CAT=cat)


REF = _ns(ref_plan, ref_optimizer, ref_rules, ref_aggregate, ref_expressions,
          REF_CAT)
PORT = _ns(port_plan, port_optimizer, port_rules, port_aggregate,
           port_expressions, CAT)


# ---------------------------------------------------------------------------
# the reference test's input plans, one description for both packages
# ---------------------------------------------------------------------------


def fold_plan(m):
    return m.FilterRel(m.ReadRel("nation"),
                       m.BinOp("and",
                               m.Col("n_nationkey")
                               < (m.Lit(2) + m.Lit(3) * m.Lit(4)),
                               m.Lit(True)))


def pushdown_both_sides_plan(m):
    join = m.JoinRel(m.ReadRel("orders"), m.ReadRel("customer"),
                     ["o_custkey"], ["c_custkey"], "inner")
    return m.FilterRel(m.FilterRel(m.FilterRel(
        join, m.Col("o_shippriority") == m.Lit(0)),
        m.Col("c_acctbal") > m.Lit(0.0)),
        m.Col("o_totalprice") > m.Col("c_acctbal"))


def pushdown_left_join_plan(m):
    join = m.JoinRel(m.ReadRel("customer"), m.ReadRel("orders"),
                     ["c_custkey"], ["o_custkey"], "left")
    return m.FilterRel(join, m.Col("o_totalprice") > m.Lit(100.0))


def pushdown_sort_limit_plan(m):
    return m.FilterRel(m.SortRel(m.ReadRel("orders"), [], limit=10),
                       m.Col("o_totalprice") > m.Lit(0.0))


def prune_scans_plan(m):
    return m.AggregateRel(m.ReadRel("lineitem"), ["l_returnflag"],
                          [m.AggSpec("sum", m.Col("l_quantity"), "q")])


def prune_join_keys_plan(m):
    join = m.JoinRel(m.ReadRel("orders"), m.ReadRel("customer"),
                     ["o_custkey"], ["c_custkey"], "inner")
    return m.AggregateRel(join, [],
                          [m.AggSpec("sum", m.Col("o_totalprice"), "t")])


def build_side_plan(how):
    def plan(m):
        return m.JoinRel(m.ReadRel("nation"), m.ReadRel("lineitem"),
                         ["n_nationkey"], ["l_suppkey"], how)
    return plan


def reorder_selective_plan(m):
    j1 = m.JoinRel(m.ReadRel("lineitem"), m.ReadRel("orders"),
                   ["l_orderkey"], ["o_orderkey"], "inner")
    return m.JoinRel(j1, m.ReadRel("nation",
                                   filter=m.Col("n_name") == m.Lit("PERU")),
                     ["l_suppkey"], ["n_nationkey"], "inner")


def reorder_keys_plan(m):
    j1 = m.JoinRel(m.ReadRel("orders"), m.ReadRel("customer"),
                   ["o_custkey"], ["c_custkey"], "inner")
    return m.JoinRel(j1, m.ReadRel("nation"),
                     ["c_nationkey"], ["n_nationkey"], "inner")


def conjuncts_plan(m):
    return m.ReadRel("lineitem",
                     filter=(m.Col("l_quantity") < m.Lit(24.0))
                     & (m.Col("l_shipmode") == m.Lit("MAIL")))


def estimate_plan(m):
    return m.ReadRel("lineitem", filter=m.Col("l_quantity") < m.Lit(24.0))


# ---------------------------------------------------------------------------
# the reference test's assertions, on the port's output
# ---------------------------------------------------------------------------


def check_fold(m, plan, out):
    assert isinstance(out.condition.right, m.Lit)
    assert out.condition.right.value == 14
    # the input plan is untouched (passes are pure)
    assert isinstance(plan.condition, m.BinOp) and plan.condition.op == "and"


def check_pushdown_both_sides(m, plan, out):
    assert isinstance(out, m.JoinRel)
    assert isinstance(out.probe, m.ReadRel) and out.probe.filter is not None
    assert isinstance(out.build, m.ReadRel) and out.build.filter is not None
    assert out.post_filter is not None          # cross-side pred → residual


def check_pushdown_left_join(m, plan, out):
    assert isinstance(out, m.FilterRel)         # stays above the outer join
    assert out.input.build.filter is None


def check_pushdown_sort_limit(m, plan, out):
    assert isinstance(out, m.FilterRel)         # limit is order-sensitive
    assert out.input.input.filter is None


def check_prune_scans(m, plan, out):
    assert set(out.input.columns) == {"l_returnflag", "l_quantity"}


def check_prune_join_keys(m, plan, out):
    assert set(out.input.probe.columns) == {"o_custkey", "o_totalprice"}
    assert out.input.build.columns == ["c_custkey"]


def check_swap(m, plan, out):
    assert out.build.table == "nation"          # 25 rows beats 6M
    assert out.probe_keys == ["l_suppkey"]
    assert out.build_keys == ["n_nationkey"]


def check_asymmetric(m, plan, out):
    assert out.build.table == "lineitem"


def check_reorder_selective(m, plan, out):
    assert out.build.table == "orders"          # outermost join is now orders
    assert out.probe.build.table == "nation"    # nation applied first


def check_reorder_keys(m, plan, out):
    assert out.build.table == "nation"          # c_nationkey needs customer
    assert out.probe.build.table == "customer"


def check_conjuncts(m, plan, out):
    assert out.filter.left.op == "=="           # eq (0.05) before range (0.3)


RULE_CASES = {
    "fold_constants": ("fold_constants", fold_plan, check_fold),
    "pushdown_through_join_to_both_sides": (
        "pushdown_predicates", pushdown_both_sides_plan,
        check_pushdown_both_sides),
    "pushdown_stops_at_left_join_build_side": (
        "pushdown_predicates", pushdown_left_join_plan,
        check_pushdown_left_join),
    "pushdown_respects_sort_limit": (
        "pushdown_predicates", pushdown_sort_limit_plan,
        check_pushdown_sort_limit),
    "prune_projections_narrows_scans": (
        "prune_projections", prune_scans_plan, check_prune_scans),
    "prune_keeps_join_keys": (
        "prune_projections", prune_join_keys_plan, check_prune_join_keys),
    "choose_build_side_swaps_to_smaller": (
        "choose_build_sides", build_side_plan("inner"), check_swap),
    "choose_build_side_leaves_asymmetric_joins": (
        "choose_build_sides", build_side_plan("semi"), check_asymmetric),
    "reorder_joins_moves_selective_build_first": (
        "reorder_joins", reorder_selective_plan, check_reorder_selective),
    "reorder_respects_key_availability": (
        "reorder_joins", reorder_keys_plan, check_reorder_keys),
    "order_conjuncts_most_selective_first": (
        "order_conjuncts", conjuncts_plan, check_conjuncts),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_equals_the_reference(case):
    rule, describe, check = RULE_CASES[case]
    ref_in, port_in = describe(REF), describe(PORT)
    assert PORT.plan_to_json(port_in) == REF.plan_to_json(ref_in)
    ref_out = getattr(REF, rule)(ref_in, REF.CAT)
    port_out = getattr(PORT, rule)(port_in, PORT.CAT)
    assert PORT.plan_to_json(port_out) == REF.plan_to_json(ref_out)
    assert PORT.explain(port_out) == REF.explain(ref_out)
    check(PORT, port_in, port_out)
    check(REF, ref_in, ref_out)     # the reference test's own claim, again
    assert PORT.plan_equal(port_in, describe(PORT))     # the input untouched


def test_estimates_and_annotation_equal_the_reference():
    ref_scan, scan = estimate_plan(REF), estimate_plan(PORT)
    est = PORT.estimate(scan, PORT.CAT)
    assert est == REF.estimate(ref_scan, REF.CAT)
    assert 0 < est < PORT.CAT.row_estimate("lineitem")
    PORT.annotate(scan, PORT.CAT)
    REF.annotate(ref_scan, REF.CAT)
    assert "rows]" in PORT.explain(scan)
    assert PORT.explain(scan) == REF.explain(ref_scan)


def test_rel_columns_shapes_equal_the_reference():
    def semi(m):
        return m.JoinRel(m.ReadRel("orders", ["o_orderkey", "o_custkey"]),
                         m.ReadRel("customer"), ["o_custkey"], ["c_custkey"],
                         "semi")

    def agg(m):
        return m.AggregateRel(semi(m), ["o_custkey"],
                              [m.AggSpec("count", None, "n")])

    for describe, want in ((semi, ["o_orderkey", "o_custkey"]),
                           (agg, ["o_custkey", "n"])):
        assert PORT.rel_columns(describe(PORT), PORT.CAT) == want
        assert REF.rel_columns(describe(REF), REF.CAT) == want


# ---------------------------------------------------------------------------
# the whole pipeline on every hand-built TPC-H plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tpch_db):
    return FallbackEngine(tpch_db), RefFallbackEngine(tpch_db)


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_optimize_preserves_semantics_q(qid, engines):
    port_fb, ref_fb = engines
    opt = PORT.optimize(QUERIES[qid]())
    ref_opt = REF.optimize(REF_QUERIES[qid]())
    assert PORT.plan_to_json(opt) == REF.plan_to_json(ref_opt)
    assert PORT.explain(opt) == REF.explain(ref_opt)
    got = port_fb.execute(opt)
    assert_tables_equal(got, port_fb.execute(QUERIES[qid]()))
    assert_tables_equal(got, ref_fb.execute(ref_opt))


def test_optimize_is_pure():
    """optimize must not mutate its input plan."""
    a, b = QUERIES[3](), QUERIES[3]()
    PORT.optimize(a)
    assert PORT.plan_equal(a, b)
    assert PORT.plan_to_json(a) == REF.plan_to_json(REF_QUERIES[3]())
