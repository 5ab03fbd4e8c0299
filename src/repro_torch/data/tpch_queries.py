"""TPC-H queries as hand-built plan trees — the slice of
``repro/data/tpch_queries.py`` that the port runs so far: Q1, Q3, Q5, Q6.

The builders stand in for a host optimizer's output (pushed-down filters,
join orders chosen by the FK graph), exactly as the reference's do; where
the spec's ORDER BY admits ties, tie-breaking keys are appended so every
engine agrees row for row.
"""
from __future__ import annotations

from ..core.plan import AggregateRel, JoinRel, ReadRel, Rel, SortRel
from ..relational.aggregate import AggSpec
from ..relational.expressions import Between, Col as C, DateLit as D, Lit as L
from ..relational.sort import SortKey as K


def _sum(e, name):
    return AggSpec("sum", e, name)


def _rev():
    return C("l_extendedprice") * (L(1.0) - C("l_discount"))


def q1() -> Rel:
    scan = ReadRel("lineitem", filter=C("l_shipdate") <= D("1998-09-02"))
    agg = AggregateRel(scan, ["l_returnflag", "l_linestatus"], [
        _sum(C("l_quantity"), "sum_qty"),
        _sum(C("l_extendedprice"), "sum_base_price"),
        _sum(_rev(), "sum_disc_price"),
        _sum(_rev() * (L(1.0) + C("l_tax")), "sum_charge"),
        AggSpec("avg", C("l_quantity"), "avg_qty"),
        AggSpec("avg", C("l_extendedprice"), "avg_price"),
        AggSpec("avg", C("l_discount"), "avg_disc"),
        AggSpec("count_star", None, "count_order"),
    ])
    return SortRel(agg, [K("l_returnflag"), K("l_linestatus")])


def q3() -> Rel:
    cust = ReadRel("customer", ["c_custkey"],
                   filter=C("c_mktsegment") == L("BUILDING"))
    orders = JoinRel(
        ReadRel("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                           "o_shippriority"],
                filter=C("o_orderdate") < D("1995-03-15")),
        cust, ["o_custkey"], ["c_custkey"], "semi")
    li = ReadRel("lineitem", ["l_orderkey", "l_extendedprice", "l_discount"],
                 filter=C("l_shipdate") > D("1995-03-15"))
    j = JoinRel(li, orders, ["l_orderkey"], ["o_orderkey"], "inner")
    agg = AggregateRel(j, ["l_orderkey", "o_orderdate", "o_shippriority"],
                       [_sum(_rev(), "revenue")])
    return SortRel(agg, [K("revenue", False), K("o_orderdate"),
                         K("l_orderkey")], limit=10)


def q5() -> Rel:
    region = ReadRel("region", ["r_regionkey"], filter=C("r_name") == L("ASIA"))
    nation = JoinRel(ReadRel("nation", ["n_nationkey", "n_name", "n_regionkey"]),
                     region, ["n_regionkey"], ["r_regionkey"], "semi")
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_nationkey"]), nation,
                   ["s_nationkey"], ["n_nationkey"], "inner")
    orders = JoinRel(
        ReadRel("orders", ["o_orderkey", "o_custkey"],
                filter=(C("o_orderdate") >= D("1994-01-01"))
                & (C("o_orderdate") < D("1995-01-01"))),
        ReadRel("customer", ["c_custkey", "c_nationkey"]),
        ["o_custkey"], ["c_custkey"], "inner")
    li = JoinRel(ReadRel("lineitem", ["l_orderkey", "l_suppkey",
                                      "l_extendedprice", "l_discount"]),
                 orders, ["l_orderkey"], ["o_orderkey"], "inner")
    j = JoinRel(li, supp, ["l_suppkey", "c_nationkey"],
                ["s_suppkey", "s_nationkey"], "inner")
    agg = AggregateRel(j, ["n_name"], [_sum(_rev(), "revenue")])
    return SortRel(agg, [K("revenue", False)])


def q6() -> Rel:
    li = ReadRel("lineitem", filter=(
        (C("l_shipdate") >= D("1994-01-01")) & (C("l_shipdate") < D("1995-01-01"))
        & Between(C("l_discount"), L(0.05), L(0.07)) & (C("l_quantity") < L(24.0))))
    return AggregateRel(li, [], [_sum(C("l_extendedprice") * C("l_discount"),
                                      "revenue")])


QUERIES = {1: q1, 3: q3, 5: q5, 6: q6}
