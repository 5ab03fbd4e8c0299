"""TPC-H queries — counterpart of ``repro/data/tpch_queries.py``: the 22
hand-built plan trees and the SQL text of all 22 queries (``SQL_QUERIES``).

The plan functions stand in for a host optimizer's output (decorrelated
subqueries, pushed-down filters, join orders chosen by the FK graph),
exactly as the reference's do; where the spec's ORDER BY admits ties,
tie-breaking keys are appended so every engine agrees row for row
(ordering only, never the result set).
"""
from __future__ import annotations

import numpy as np

from ..core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SortRel,
)
from ..relational.aggregate import AggSpec
from ..relational.expressions import (
    Between, Case, Col as C, DateLit as D, ExtractYear, InList, Like, Lit as L,
    Substr,
)
from ..relational.sort import SortKey as K


def _month_add(date: str, months: int) -> str:
    d = np.datetime64(date, "M") + np.timedelta64(months, "M")
    day = str(np.datetime64(date, "D"))[8:]
    return f"{d}-{day}"


def _sum(e, name):
    return AggSpec("sum", e, name)


def _rev():
    return C("l_extendedprice") * (L(1.0) - C("l_discount"))


# ---------------------------------------------------------------------------


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


def _europe_supplier_ps() -> Rel:
    region = ReadRel("region", ["r_regionkey"], filter=C("r_name") == L("EUROPE"))
    nation = JoinRel(ReadRel("nation", ["n_nationkey", "n_name", "n_regionkey"]),
                     region, ["n_regionkey"], ["r_regionkey"], "semi")
    supp = JoinRel(ReadRel("supplier"), nation,
                   ["s_nationkey"], ["n_nationkey"], "inner")
    return JoinRel(ReadRel("partsupp",
                           ["ps_partkey", "ps_suppkey", "ps_supplycost"]),
                   supp, ["ps_suppkey"], ["s_suppkey"], "inner")


def q2() -> Rel:
    mincost = AggregateRel(_europe_supplier_ps(), ["ps_partkey"],
                           [AggSpec("min", C("ps_supplycost"), "min_cost")])
    mincost = ProjectRel(mincost, [("mc_partkey", C("ps_partkey")),
                                   ("min_cost", C("min_cost"))])
    part = ReadRel("part", ["p_partkey", "p_mfgr", "p_size", "p_type"],
                   filter=(C("p_size") == L(15)) & Like(C("p_type"), "%BRASS"))
    j = JoinRel(_europe_supplier_ps(), part,
                ["ps_partkey"], ["p_partkey"], "inner")
    j = JoinRel(j, mincost, ["ps_partkey", "ps_supplycost"],
                ["mc_partkey", "min_cost"], "semi")
    proj = ProjectRel(j, [
        ("s_acctbal", C("s_acctbal")), ("s_name", C("s_name")),
        ("n_name", C("n_name")), ("p_partkey", C("ps_partkey")),
        ("p_mfgr", C("p_mfgr")), ("s_address", C("s_address")),
        ("s_phone", C("s_phone")), ("s_comment", C("s_comment"))])
    return SortRel(proj, [K("s_acctbal", False), K("n_name"), K("s_name"),
                          K("p_partkey")], limit=100)


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


def q4() -> Rel:
    li = ReadRel("lineitem", ["l_orderkey"],
                 filter=C("l_commitdate") < C("l_receiptdate"))
    orders = ReadRel("orders", ["o_orderkey", "o_orderpriority"],
                     filter=(C("o_orderdate") >= D("1993-07-01"))
                     & (C("o_orderdate") < D(_month_add("1993-07-01", 3))))
    j = JoinRel(orders, li, ["o_orderkey"], ["l_orderkey"], "semi")
    agg = AggregateRel(j, ["o_orderpriority"],
                       [AggSpec("count_star", None, "order_count")])
    return SortRel(agg, [K("o_orderpriority")])


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


def q7() -> Rel:
    nations = InList(C("n_name"), ["FRANCE", "GERMANY"])
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_nationkey"]),
                   ProjectRel(ReadRel("nation", filter=nations),
                              [("n_nationkey", C("n_nationkey")),
                               ("supp_nation", C("n_name"))]),
                   ["s_nationkey"], ["n_nationkey"], "inner")
    cust = JoinRel(ReadRel("customer", ["c_custkey", "c_nationkey"]),
                   ProjectRel(ReadRel("nation", filter=nations),
                              [("n2_nationkey", C("n_nationkey")),
                               ("cust_nation", C("n_name"))]),
                   ["c_nationkey"], ["n2_nationkey"], "inner")
    orders = JoinRel(ReadRel("orders", ["o_orderkey", "o_custkey"]),
                     cust, ["o_custkey"], ["c_custkey"], "inner")
    li = ReadRel("lineitem",
                 ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
                  "l_shipdate"],
                 filter=Between(C("l_shipdate"), D("1995-01-01"), D("1996-12-31")))
    j = JoinRel(li, orders, ["l_orderkey"], ["o_orderkey"], "inner")
    j = JoinRel(j, supp, ["l_suppkey"], ["s_suppkey"], "inner",
                post_filter=(
                    ((C("supp_nation") == L("FRANCE"))
                     & (C("cust_nation") == L("GERMANY")))
                    | ((C("supp_nation") == L("GERMANY"))
                       & (C("cust_nation") == L("FRANCE")))))
    proj = ProjectRel(j, [("supp_nation", C("supp_nation")),
                          ("cust_nation", C("cust_nation")),
                          ("l_year", ExtractYear(C("l_shipdate"))),
                          ("volume", _rev())])
    agg = AggregateRel(proj, ["supp_nation", "cust_nation", "l_year"],
                       [_sum(C("volume"), "revenue")])
    return SortRel(agg, [K("supp_nation"), K("cust_nation"), K("l_year")])


def q8() -> Rel:
    part = ReadRel("part", ["p_partkey"],
                   filter=C("p_type") == L("ECONOMY ANODIZED STEEL"))
    li = JoinRel(ReadRel("lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                                      "l_extendedprice", "l_discount"]),
                 part, ["l_partkey"], ["p_partkey"], "semi")
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_nationkey"]),
                   ProjectRel(ReadRel("nation"),
                              [("sn_key", C("n_nationkey")),
                               ("n2_name", C("n_name"))]),
                   ["s_nationkey"], ["sn_key"], "inner")
    li = JoinRel(li, supp, ["l_suppkey"], ["s_suppkey"], "inner")
    orders = ReadRel("orders", ["o_orderkey", "o_custkey", "o_orderdate"],
                     filter=Between(C("o_orderdate"), D("1995-01-01"),
                                    D("1996-12-31")))
    j = JoinRel(li, orders, ["l_orderkey"], ["o_orderkey"], "inner")
    region = ReadRel("region", ["r_regionkey"], filter=C("r_name") == L("AMERICA"))
    nat1 = JoinRel(ReadRel("nation", ["n_nationkey", "n_regionkey"]), region,
                   ["n_regionkey"], ["r_regionkey"], "semi")
    cust = JoinRel(ReadRel("customer", ["c_custkey", "c_nationkey"]), nat1,
                   ["c_nationkey"], ["n_nationkey"], "semi")
    j = JoinRel(j, cust, ["o_custkey"], ["c_custkey"], "semi")
    proj = ProjectRel(j, [
        ("o_year", ExtractYear(C("o_orderdate"))),
        ("volume", _rev()),
        ("brazil_volume", Case([(C("n2_name") == L("BRAZIL"), _rev())], L(0.0)))])
    agg = AggregateRel(proj, ["o_year"], [
        _sum(C("brazil_volume"), "num"), _sum(C("volume"), "den")])
    share = ProjectRel(agg, [("o_year", C("o_year")),
                             ("mkt_share", C("num") / C("den"))])
    return SortRel(share, [K("o_year")])


def q9() -> Rel:
    part = ReadRel("part", ["p_partkey"], filter=Like(C("p_name"), "%green%"))
    li = JoinRel(ReadRel("lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                                      "l_quantity", "l_extendedprice",
                                      "l_discount"]),
                 part, ["l_partkey"], ["p_partkey"], "semi")
    li = JoinRel(li, ReadRel("partsupp",
                             ["ps_partkey", "ps_suppkey", "ps_supplycost"]),
                 ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"],
                 "inner")
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_nationkey"]),
                   ReadRel("nation", ["n_nationkey", "n_name"]),
                   ["s_nationkey"], ["n_nationkey"], "inner")
    li = JoinRel(li, supp, ["l_suppkey"], ["s_suppkey"], "inner")
    j = JoinRel(li, ReadRel("orders", ["o_orderkey", "o_orderdate"]),
                ["l_orderkey"], ["o_orderkey"], "inner")
    proj = ProjectRel(j, [
        ("nation", C("n_name")),
        ("o_year", ExtractYear(C("o_orderdate"))),
        ("amount", _rev() - C("ps_supplycost") * C("l_quantity"))])
    agg = AggregateRel(proj, ["nation", "o_year"],
                       [_sum(C("amount"), "sum_profit")])
    return SortRel(agg, [K("nation"), K("o_year", False)])


def q10() -> Rel:
    orders = ReadRel("orders", ["o_orderkey", "o_custkey"],
                     filter=(C("o_orderdate") >= D("1993-10-01"))
                     & (C("o_orderdate") < D(_month_add("1993-10-01", 3))))
    li = ReadRel("lineitem", ["l_orderkey", "l_extendedprice", "l_discount"],
                 filter=C("l_returnflag") == L("R"))
    j = JoinRel(li, orders, ["l_orderkey"], ["o_orderkey"], "inner")
    j = JoinRel(j, ReadRel("customer"), ["o_custkey"], ["c_custkey"], "inner")
    j = JoinRel(j, ReadRel("nation", ["n_nationkey", "n_name"]),
                ["c_nationkey"], ["n_nationkey"], "inner")
    agg = AggregateRel(j, ["c_custkey", "c_name", "c_acctbal", "c_phone",
                           "n_name", "c_address", "c_comment"],
                       [_sum(_rev(), "revenue")])
    return SortRel(agg, [K("revenue", False), K("c_custkey")], limit=20)


def _q11_value_by_part() -> Rel:
    nation = ReadRel("nation", ["n_nationkey"],
                     filter=C("n_name") == L("GERMANY"))
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_nationkey"]), nation,
                   ["s_nationkey"], ["n_nationkey"], "semi")
    ps = JoinRel(ReadRel("partsupp", ["ps_partkey", "ps_suppkey",
                                      "ps_supplycost", "ps_availqty"]),
                 supp, ["ps_suppkey"], ["s_suppkey"], "semi")
    return ps


def q11() -> Rel:
    value = C("ps_supplycost") * C("ps_availqty")
    total = ScalarSubquery(
        AggregateRel(_q11_value_by_part(), [], [_sum(value, "t")]), "t")
    agg = AggregateRel(_q11_value_by_part(), ["ps_partkey"],
                       [_sum(value, "value")],
                       having=C("value") > total * L(0.0001))
    return SortRel(agg, [K("value", False), K("ps_partkey")])


def q12() -> Rel:
    li = ReadRel("lineitem", ["l_orderkey", "l_shipmode"],
                 filter=(InList(C("l_shipmode"), ["MAIL", "SHIP"])
                         & (C("l_commitdate") < C("l_receiptdate"))
                         & (C("l_shipdate") < C("l_commitdate"))
                         & (C("l_receiptdate") >= D("1994-01-01"))
                         & (C("l_receiptdate") < D("1995-01-01"))))
    j = JoinRel(li, ReadRel("orders", ["o_orderkey", "o_orderpriority"]),
                ["l_orderkey"], ["o_orderkey"], "inner")
    high = InList(C("o_orderpriority"), ["1-URGENT", "2-HIGH"])
    agg = AggregateRel(j, ["l_shipmode"], [
        _sum(Case([(high, L(1))], L(0)), "high_line_count"),
        _sum(Case([(high, L(0))], L(1)), "low_line_count")])
    return SortRel(agg, [K("l_shipmode")])


def q13() -> Rel:
    orders = ReadRel("orders", ["o_orderkey", "o_custkey"],
                     filter=Like(C("o_comment"), "%special%requests%",
                                 negate=True))
    j = JoinRel(ReadRel("customer", ["c_custkey"]), orders,
                ["c_custkey"], ["o_custkey"], "left")
    per_cust = AggregateRel(j, ["c_custkey"], [
        _sum(Case([(C("__matched"), L(1))], L(0)), "c_count")])
    dist = AggregateRel(per_cust, ["c_count"],
                        [AggSpec("count_star", None, "custdist")])
    return SortRel(dist, [K("custdist", False), K("c_count", False)])


def q14() -> Rel:
    li = ReadRel("lineitem", ["l_partkey", "l_extendedprice", "l_discount"],
                 filter=(C("l_shipdate") >= D("1995-09-01"))
                 & (C("l_shipdate") < D(_month_add("1995-09-01", 1))))
    j = JoinRel(li, ReadRel("part", ["p_partkey", "p_type"]),
                ["l_partkey"], ["p_partkey"], "inner")
    agg = AggregateRel(j, [], [
        _sum(Case([(Like(C("p_type"), "PROMO%"), _rev())], L(0.0)), "promo"),
        _sum(_rev(), "total")])
    return ProjectRel(agg, [("promo_revenue",
                             L(100.0) * C("promo") / C("total"))])


def _q15_revenue() -> Rel:
    li = ReadRel("lineitem", ["l_suppkey", "l_extendedprice", "l_discount"],
                 filter=(C("l_shipdate") >= D("1996-01-01"))
                 & (C("l_shipdate") < D(_month_add("1996-01-01", 3))))
    return AggregateRel(li, ["l_suppkey"], [_sum(_rev(), "total_revenue")])


def q15() -> Rel:
    best = ScalarSubquery(AggregateRel(_q15_revenue(), [], [
        AggSpec("max", C("total_revenue"), "m")]), "m")
    j = JoinRel(ReadRel("supplier", ["s_suppkey", "s_name", "s_address",
                                     "s_phone"]),
                _q15_revenue(), ["s_suppkey"], ["l_suppkey"], "inner")
    f = FilterRel(j, C("total_revenue") >= best)
    proj = ProjectRel(f, [
        ("s_suppkey", C("s_suppkey")), ("s_name", C("s_name")),
        ("s_address", C("s_address")), ("s_phone", C("s_phone")),
        ("total_revenue", C("total_revenue"))])
    return SortRel(proj, [K("s_suppkey")])


def q16() -> Rel:
    part = ReadRel("part", ["p_partkey", "p_brand", "p_type", "p_size"],
                   filter=((C("p_brand") != L("Brand#45"))
                           & Like(C("p_type"), "MEDIUM POLISHED%", negate=True)
                           & InList(C("p_size"), [49, 14, 23, 45, 19, 3, 36, 9])))
    ps = JoinRel(ReadRel("partsupp", ["ps_partkey", "ps_suppkey"]), part,
                 ["ps_partkey"], ["p_partkey"], "inner")
    bad_supp = ReadRel("supplier", ["s_suppkey"],
                       filter=Like(C("s_comment"), "%Customer%Complaints%"))
    ps = JoinRel(ps, bad_supp, ["ps_suppkey"], ["s_suppkey"], "anti")
    agg = AggregateRel(ps, ["p_brand", "p_type", "p_size"],
                       [AggSpec("count_distinct", C("ps_suppkey"),
                                "supplier_cnt")])
    return SortRel(agg, [K("supplier_cnt", False), K("p_brand"), K("p_type"),
                         K("p_size")])


def q17() -> Rel:
    part = ReadRel("part", ["p_partkey"],
                   filter=(C("p_brand") == L("Brand#23"))
                   & (C("p_container") == L("MED BOX")))
    li = JoinRel(ReadRel("lineitem", ["l_partkey", "l_quantity",
                                      "l_extendedprice"]),
                 part, ["l_partkey"], ["p_partkey"], "semi")
    avg_qty = AggregateRel(ReadRel("lineitem", ["l_partkey", "l_quantity"]),
                           ["l_partkey"],
                           [AggSpec("avg", C("l_quantity"), "avg_qty")])
    avg_qty = ProjectRel(avg_qty, [("ap_partkey", C("l_partkey")),
                                   ("avg_qty", C("avg_qty"))])
    j = JoinRel(li, avg_qty, ["l_partkey"], ["ap_partkey"], "inner",
                post_filter=C("l_quantity") < L(0.2) * C("avg_qty"))
    agg = AggregateRel(j, [], [_sum(C("l_extendedprice"), "s")])
    return ProjectRel(agg, [("avg_yearly", C("s") / L(7.0))])


def q18() -> Rel:
    big = AggregateRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                       ["l_orderkey"], [_sum(C("l_quantity"), "sq")],
                       having=C("sq") > L(300.0))
    big = ProjectRel(big, [("big_okey", C("l_orderkey"))])
    orders = JoinRel(ReadRel("orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_totalprice"]),
                     big, ["o_orderkey"], ["big_okey"], "semi")
    j = JoinRel(orders, ReadRel("customer", ["c_custkey", "c_name"]),
                ["o_custkey"], ["c_custkey"], "inner")
    li = JoinRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]), j,
                 ["l_orderkey"], ["o_orderkey"], "inner")
    agg = AggregateRel(li, ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                            "o_totalprice"], [_sum(C("l_quantity"), "sum_qty")])
    return SortRel(agg, [K("o_totalprice", False), K("o_orderdate"),
                         K("o_orderkey")], limit=100)


def q19() -> Rel:
    li = ReadRel("lineitem", ["l_partkey", "l_quantity", "l_extendedprice",
                              "l_discount"],
                 filter=(InList(C("l_shipmode"), ["AIR", "AIR REG"])
                         & (C("l_shipinstruct") == L("DELIVER IN PERSON"))))
    part = ReadRel("part", ["p_partkey", "p_brand", "p_container", "p_size"])
    cond1 = ((C("p_brand") == L("Brand#12"))
             & InList(C("p_container"), ["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
             & Between(C("l_quantity"), L(1.0), L(11.0))
             & Between(C("p_size"), L(1), L(5)))
    cond2 = ((C("p_brand") == L("Brand#23"))
             & InList(C("p_container"), ["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
             & Between(C("l_quantity"), L(10.0), L(20.0))
             & Between(C("p_size"), L(1), L(10)))
    cond3 = ((C("p_brand") == L("Brand#34"))
             & InList(C("p_container"), ["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
             & Between(C("l_quantity"), L(20.0), L(30.0))
             & Between(C("p_size"), L(1), L(15)))
    j = JoinRel(li, part, ["l_partkey"], ["p_partkey"], "inner",
                post_filter=cond1 | cond2 | cond3)
    return AggregateRel(j, [], [_sum(_rev(), "revenue")])


def q20() -> Rel:
    forest = ReadRel("part", ["p_partkey"], filter=Like(C("p_name"), "forest%"))
    shipped = AggregateRel(
        ReadRel("lineitem", ["l_partkey", "l_suppkey", "l_quantity"],
                filter=(C("l_shipdate") >= D("1994-01-01"))
                & (C("l_shipdate") < D("1995-01-01"))),
        ["l_partkey", "l_suppkey"], [_sum(C("l_quantity"), "sum_qty")])
    ps = JoinRel(ReadRel("partsupp", ["ps_partkey", "ps_suppkey",
                                      "ps_availqty"]),
                 forest, ["ps_partkey"], ["p_partkey"], "semi")
    ps = JoinRel(ps, shipped, ["ps_partkey", "ps_suppkey"],
                 ["l_partkey", "l_suppkey"], "inner",
                 post_filter=C("ps_availqty") > L(0.5) * C("sum_qty"))
    ps = ProjectRel(ps, [("avail_supp", C("ps_suppkey"))])
    nation = ReadRel("nation", ["n_nationkey"], filter=C("n_name") == L("CANADA"))
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_name", "s_address",
                                        "s_nationkey"]),
                   nation, ["s_nationkey"], ["n_nationkey"], "semi")
    supp = JoinRel(supp, ps, ["s_suppkey"], ["avail_supp"], "semi")
    return SortRel(ProjectRel(supp, [("s_name", C("s_name")),
                                     ("s_address", C("s_address"))]),
                   [K("s_name")])


def q21() -> Rel:
    late = ReadRel("lineitem", ["l_orderkey", "l_suppkey"],
                   filter=C("l_receiptdate") > C("l_commitdate"))
    n_all = AggregateRel(ReadRel("lineitem", ["l_orderkey", "l_suppkey"]),
                         ["l_orderkey"],
                         [AggSpec("count_distinct", C("l_suppkey"), "n_all")],
                         having=C("n_all") > L(1))
    n_all = ProjectRel(n_all, [("na_okey", C("l_orderkey"))])
    n_late = AggregateRel(late, ["l_orderkey"],
                          [AggSpec("count_distinct", C("l_suppkey"), "n_late")],
                          having=C("n_late") == L(1))
    n_late = ProjectRel(n_late, [("nl_okey", C("l_orderkey"))])
    nation = ReadRel("nation", ["n_nationkey"],
                     filter=C("n_name") == L("SAUDI ARABIA"))
    supp = JoinRel(ReadRel("supplier", ["s_suppkey", "s_name", "s_nationkey"]),
                   nation, ["s_nationkey"], ["n_nationkey"], "semi")
    orders_f = ReadRel("orders", ["o_orderkey"],
                       filter=C("o_orderstatus") == L("F"))
    j = JoinRel(late, supp, ["l_suppkey"], ["s_suppkey"], "inner")
    j = JoinRel(j, orders_f, ["l_orderkey"], ["o_orderkey"], "semi")
    j = JoinRel(j, n_all, ["l_orderkey"], ["na_okey"], "semi")
    j = JoinRel(j, n_late, ["l_orderkey"], ["nl_okey"], "semi")
    agg = AggregateRel(j, ["s_name"], [AggSpec("count_star", None, "numwait")])
    return SortRel(agg, [K("numwait", False), K("s_name")], limit=100)


def q22() -> Rel:
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    in_codes = InList(Substr(C("c_phone"), 1, 2), codes)
    avg_bal = ScalarSubquery(
        AggregateRel(ReadRel("customer", ["c_acctbal", "c_phone"],
                             filter=(C("c_acctbal") > L(0.0)) & in_codes),
                     [], [AggSpec("avg", C("c_acctbal"), "a")]), "a")
    cust = ReadRel("customer", ["c_custkey", "c_phone", "c_acctbal"],
                   filter=in_codes)
    cust = FilterRel(cust, C("c_acctbal") > avg_bal)
    cust = JoinRel(cust, ReadRel("orders", ["o_custkey"]),
                   ["c_custkey"], ["o_custkey"], "anti")
    proj = ProjectRel(cust, [("cntrycode", Substr(C("c_phone"), 1, 2)),
                             ("c_acctbal", C("c_acctbal"))])
    agg = AggregateRel(proj, ["cntrycode"],
                       [AggSpec("count_star", None, "numcust"),
                        _sum(C("c_acctbal"), "totacctbal")])
    return SortRel(agg, [K("cntrycode")])


QUERIES = {i: fn for i, fn in enumerate(
    [q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15, q16,
     q17, q18, q19, q20, q21, q22], start=1)}


# ---------------------------------------------------------------------------
# SQL-text versions (the paper's *actual* input format) — all 22 queries.
#
# These feed the SQL frontend (repro_torch.sql) + rule-based optimizer
# (repro_torch.optimizer) and are validated row-for-row against
# the 22 hand-built plans above.
# Textual deviations from the TPC-H spec, all semantics- or
# determinism-preserving:
#   * the tie-breaking ORDER BY keys the hand-built plans add (Q3/Q10/Q11/
#     Q18) appear in the text too, so row order is engine-independent;
#   * Q19 uses the standard factored form (shipmode/shipinstruct conjuncts
#     hoisted out of the OR) — equivalent, and it exercises join-level
#     residual (post_filter) placement;
#   * Q11's HAVING threshold multiplies inside the scalar subquery instead
#     of outside — same arithmetic;
#   * Q22 groups by the substring expression directly rather than through a
#     derived table (the expression-valued group key is the engine's native
#     shape);
#   * Q7/Q8/Q9 inline the spec's derived-table column list as select-item
#     aliases and Q15 inlines the spec's revenue *view* as a derived table —
#     same plans after lowering;
#   * Q21 replaces the spec's lineitem self-joins (exists l2 / not exists
#     l3) with the equivalent per-order distinct-supplier-count subqueries
#     the hand-built plan uses: >1 distinct suppliers overall and exactly 1
#     distinct late supplier — the rewrite DuckDB's flattening produces;
#   * Q15 compares total_revenue with = (spec) where the hand-built plan
#     uses >= against the max — identical row sets by definition of max.
# ---------------------------------------------------------------------------

SQL_QUERIES = {
    1: """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey
  and s_suppkey = ps_suppkey
  and p_size = 15
  and p_type like '%BRASS'
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (select min(ps_supplycost)
                       from partsupp, supplier, nation, region
                       where p_partkey = ps_partkey
                         and s_suppkey = ps_suppkey
                         and s_nationkey = n_nationkey
                         and n_regionkey = r_regionkey
                         and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
    3: """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate, l_orderkey
limit 10
""",
    4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey
                and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
""",
    5: """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc
""",
    6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
""",
    7: """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
             extract(year from l_shipdate) as l_year,
             l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey
        and o_orderkey = l_orderkey
        and c_custkey = o_custkey
        and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
          or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate between date '1995-01-01' and date '1996-12-31')
     as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
""",
    8: """
select o_year,
       sum(case when nation = 'BRAZIL' then volume else 0 end)
       / sum(volume) as mkt_share
from (select extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount) as volume,
             n2.n_name as nation
      from part, supplier, lineitem, orders, customer, nation n1,
           nation n2, region
      where p_partkey = l_partkey
        and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey
        and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey
        and n1.n_regionkey = r_regionkey
        and r_name = 'AMERICA'
        and s_nationkey = n2.n_nationkey
        and o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL') as all_nations
group by o_year
order by o_year
""",
    9: """
select nation, o_year, sum(amount) as sum_profit
from (select n_name as nation,
             extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount)
               - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey
        and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey
        and p_partkey = l_partkey
        and o_orderkey = l_orderkey
        and s_nationkey = n_nationkey
        and p_name like '%green%') as profit
group by nation, o_year
order by nation, o_year desc
""",
    10: """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R'
  and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc, c_custkey
limit 20
""",
    11: """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey
  and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) >
       (select sum(ps_supplycost * ps_availqty) * 0.0001
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey
          and s_nationkey = n_nationkey
          and n_name = 'GERMANY')
order by value desc, ps_partkey
""",
    12: """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH' then 1 else 0 end)
           as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH' then 1 else 0 end)
           as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
  and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate
  and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1995-01-01'
group by l_shipmode
order by l_shipmode
""",
    13: """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders
        on c_custkey = o_custkey
       and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc
""",
    14: """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-10-01'
""",
    15: """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier,
     (select l_suppkey, sum(l_extendedprice * (1 - l_discount))
          as total_revenue
      from lineitem
      where l_shipdate >= date '1996-01-01'
        and l_shipdate < date '1996-04-01'
      group by l_suppkey) as revenue0
where s_suppkey = l_suppkey
  and total_revenue = (select max(total_revenue)
                       from (select l_suppkey,
                                    sum(l_extendedprice * (1 - l_discount))
                                        as total_revenue
                             from lineitem
                             where l_shipdate >= date '1996-01-01'
                               and l_shipdate < date '1996-04-01'
                             group by l_suppkey) as revenue1)
order by s_suppkey
""",
    16: """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (select s_suppkey from supplier
                         where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity)
                    from lineitem
                    where l_partkey = p_partkey)
""",
    18: """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) as sum_qty
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having sum(l_quantity) > 300)
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate, o_orderkey
limit 100
""",
    19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON'
  and ((p_brand = 'Brand#12'
        and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        and l_quantity between 1 and 11
        and p_size between 1 and 5)
    or (p_brand = 'Brand#23'
        and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        and l_quantity between 10 and 20
        and p_size between 1 and 10)
    or (p_brand = 'Brand#34'
        and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        and l_quantity between 20 and 30
        and p_size between 1 and 15))
""",
    20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (select ps_suppkey
                    from partsupp
                    where ps_partkey in (select p_partkey from part
                                         where p_name like 'forest%')
                      and ps_availqty > (select 0.5 * sum(l_quantity)
                                         from lineitem
                                         where l_partkey = ps_partkey
                                           and l_suppkey = ps_suppkey
                                           and l_shipdate >= date '1994-01-01'
                                           and l_shipdate < date '1995-01-01'))
  and s_nationkey = n_nationkey
  and n_name = 'CANADA'
order by s_name
""",
    21: """
select s_name, count(*) as numwait
from lineitem, supplier, nation
where s_suppkey = l_suppkey
  and l_receiptdate > l_commitdate
  and l_orderkey in (select o_orderkey from orders
                     where o_orderstatus = 'F')
  and l_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having count(distinct l_suppkey) > 1)
  and l_orderkey in (select l_orderkey from lineitem
                     where l_receiptdate > l_commitdate
                     group by l_orderkey
                     having count(distinct l_suppkey) = 1)
  and s_nationkey = n_nationkey
  and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
""",
    22: """
select substring(c_phone, 1, 2) as cntrycode,
       count(*) as numcust,
       sum(c_acctbal) as totacctbal
from customer
where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
  and c_acctbal > (select avg(c_acctbal) from customer
                   where c_acctbal > 0.00
                     and substring(c_phone, 1, 2)
                         in ('13', '31', '23', '29', '30', '18', '17'))
  and not exists (select * from orders where o_custkey = c_custkey)
group by substring(c_phone, 1, 2)
order by cntrycode
""",
}

# the queries on which the optimizer's predicate pushdown provably lands a
# filter in a ReadRel (Q18's only predicates are join keys + an IN subquery)
SQL_PUSHDOWN_QIDS = tuple(q for q in sorted(SQL_QUERIES) if q != 18)
