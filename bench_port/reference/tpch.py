"""The 22 TPC-H queries in plain PyTorch, one function each, following the
frozen texts in ``queries/tpch.py`` (their slots filled by ``slots``).

Each takes a ``Ref`` over the generated tables and returns the result as
host columns named and ordered as the query's select list and ORDER BY.
SQL's rules hold: a scalar subquery over no rows is NULL and its
comparison false, ``NOT IN`` over a key that is never NULL is an
anti join, ``count(o_orderkey)`` of an outer join counts matches only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..datagen.encode import days
from .ops import (Ref, Result, count_distinct, first, group, lookup, pair_key,
                  seg_count, seg_sum)


def _d(s: str) -> int:
    return days(s)


class _Joins:
    """Row maps between the tables (foreign key → row of the key)."""

    def __init__(self, r: Ref):
        self.r = r
        self._cache = {}

    def rows(self, build: tuple, probe: tuple) -> torch.Tensor:
        key = (build, probe)
        if key not in self._cache:
            self._cache[key] = lookup(self.r.col(*build), self.r.col(*probe))
        return self._cache[key]

    def li_order(self):
        return self.rows(("orders", "o_orderkey"), ("lineitem", "l_orderkey"))

    def li_supp(self):
        return self.rows(("supplier", "s_suppkey"), ("lineitem", "l_suppkey"))

    def li_part(self):
        return self.rows(("part", "p_partkey"), ("lineitem", "l_partkey"))

    def order_cust(self):
        return self.rows(("customer", "c_custkey"), ("orders", "o_custkey"))

    def ps_supp(self):
        return self.rows(("supplier", "s_suppkey"), ("partsupp", "ps_suppkey"))

    def ps_part(self):
        return self.rows(("part", "p_partkey"), ("partsupp", "ps_partkey"))

    def nation_row(self, nationkey: torch.Tensor) -> torch.Tensor:
        return lookup(self.r.col("nation", "n_nationkey"), nationkey)


def _rev(r: Ref, m=None):
    ext, disc = r.col("lineitem", "l_extendedprice"), r.col("lineitem", "l_discount")
    if m is not None:
        ext, disc = ext[m], disc[m]
    return ext * (1 - disc)


def _nation_name(r: Ref, j: _Joins, nationkey: torch.Tensor):
    return r.col("nation", "n_name")[j.nation_row(nationkey)]


def q1(r: Ref, j: _Joins, p: dict):
    m = r.col("lineitem", "l_shipdate") <= _d(p["date"])
    rf, ls = r.col("lineitem", "l_returnflag")[m], r.col("lineitem", "l_linestatus")[m]
    gid, n = group([rf, ls])
    qty = r.col("lineitem", "l_quantity")[m]
    ext = r.col("lineitem", "l_extendedprice")[m]
    disc = r.col("lineitem", "l_discount")[m]
    tax = r.col("lineitem", "l_tax")[m]
    cnt = seg_count(gid, n)
    dp = ext * (1 - disc)
    out = (Result()
           .string("l_returnflag", first(rf, gid, n), r.dictionary("lineitem", "l_returnflag"))
           .string("l_linestatus", first(ls, gid, n), r.dictionary("lineitem", "l_linestatus"))
           .num("sum_qty", seg_sum(qty, gid, n))
           .num("sum_base_price", seg_sum(ext, gid, n))
           .num("sum_disc_price", seg_sum(dp, gid, n))
           .num("sum_charge", seg_sum(dp * (1 + tax), gid, n))
           .num("avg_qty", seg_sum(qty, gid, n) / cnt)
           .num("avg_price", seg_sum(ext, gid, n) / cnt)
           .num("avg_disc", seg_sum(disc, gid, n) / cnt)
           .num("count_order", cnt))
    return out.host([("l_returnflag", False), ("l_linestatus", False)])


def _region_nations(r: Ref, region: str) -> torch.Tensor:
    """Bool per nation row: the nation lies in ``region``."""
    rk = r.col("region", "r_regionkey")[r.eq("region", "r_name", region)]
    return torch.isin(r.col("nation", "n_regionkey"), rk)


def q2(r: Ref, j: _Joins, p: dict):
    in_region = _region_nations(r, p["region"])
    s_ok = in_region[j.nation_row(r.col("supplier", "s_nationkey"))]
    sidx, pidx = j.ps_supp(), j.ps_part()
    ok = s_ok[sidx]
    cost = r.col("partsupp", "ps_supplycost")
    n_part = r.ds.rows("part")
    mincost = torch.full((n_part,), float("inf"), dtype=cost.dtype, device=cost.device)
    mincost.scatter_reduce_(0, pidx[ok], cost[ok], "amin")
    part_ok = ((r.col("part", "p_size") == int(p["size"]))
               & r.like("part", "p_type", f"%{p['type']}"))
    sel = ok & part_ok[pidx] & (cost == mincost[pidx])
    s, pr = sidx[sel], pidx[sel]
    nrow = j.nation_row(r.col("supplier", "s_nationkey")[s])
    out = (Result()
           .num("s_acctbal", r.col("supplier", "s_acctbal")[s])
           .string("s_name", r.col("supplier", "s_name")[s], r.dictionary("supplier", "s_name"))
           .string("n_name", r.col("nation", "n_name")[nrow], r.dictionary("nation", "n_name"))
           .num("p_partkey", r.col("part", "p_partkey")[pr])
           .string("p_mfgr", r.col("part", "p_mfgr")[pr], r.dictionary("part", "p_mfgr"))
           .string("s_address", r.col("supplier", "s_address")[s], r.dictionary("supplier", "s_address"))
           .string("s_phone", r.col("supplier", "s_phone")[s], r.dictionary("supplier", "s_phone"))
           .string("s_comment", r.col("supplier", "s_comment")[s], r.dictionary("supplier", "s_comment")))
    return out.host([("s_acctbal", True), ("n_name", False), ("s_name", False),
                     ("p_partkey", False)], 100)


def q3(r: Ref, j: _Joins, p: dict):
    d = _d(p["date"])
    c_ok = r.eq("customer", "c_mktsegment", p["segment"])
    o_ok = c_ok[j.order_cust()] & (r.col("orders", "o_orderdate") < d)
    oidx = j.li_order()
    m = o_ok[oidx] & (r.col("lineitem", "l_shipdate") > d)
    ok_rows = oidx[m]
    gid, n = group([r.col("lineitem", "l_orderkey")[m]])
    out = (Result()
           .num("l_orderkey", first(r.col("lineitem", "l_orderkey")[m], gid, n))
           .num("revenue", seg_sum(_rev(r, m), gid, n))
           .date("o_orderdate", first(r.col("orders", "o_orderdate")[ok_rows], gid, n))
           .num("o_shippriority", first(r.col("orders", "o_shippriority")[ok_rows], gid, n)))
    return out.host([("revenue", True), ("o_orderdate", False), ("l_orderkey", False)], 10)


def _month_end(date: str, months: int) -> int:
    dd = np.datetime64(date, "M") + np.timedelta64(months, "M")
    return _d(f"{dd}-{date[8:]}")


def q4(r: Ref, j: _Joins, p: dict):
    od = r.col("orders", "o_orderdate")
    late = r.col("lineitem", "l_commitdate") < r.col("lineitem", "l_receiptdate")
    has = torch.zeros(r.ds.rows("orders"), dtype=torch.bool, device=r.device)
    has[j.li_order()[late]] = True
    m = (od >= _d(p["date"])) & (od < _month_end(p["date"], 3)) & has
    prio = r.col("orders", "o_orderpriority")[m]
    gid, n = group([prio])
    out = (Result()
           .string("o_orderpriority", first(prio, gid, n), r.dictionary("orders", "o_orderpriority"))
           .num("order_count", seg_count(gid, n)))
    return out.host([("o_orderpriority", False)])


def q5(r: Ref, j: _Joins, p: dict):
    in_region = _region_nations(r, p["region"])
    od = r.col("orders", "o_orderdate")
    o_ok = (od >= _d(p["date"])) & (od < _d(p["date_end"]))
    oidx, sidx = j.li_order(), j.li_supp()
    cidx = j.order_cust()[oidx]
    s_nk = r.col("supplier", "s_nationkey")[sidx]
    c_nk = r.col("customer", "c_nationkey")[cidx]
    m = o_ok[oidx] & (s_nk == c_nk) & in_region[j.nation_row(s_nk)]
    name = _nation_name(r, j, s_nk[m])
    gid, n = group([name])
    out = (Result()
           .string("n_name", first(name, gid, n), r.dictionary("nation", "n_name"))
           .num("revenue", seg_sum(_rev(r, m), gid, n)))
    return out.host([("revenue", True)])


def q6(r: Ref, j: _Joins, p: dict):
    sd = r.col("lineitem", "l_shipdate")
    disc = r.col("lineitem", "l_discount")
    m = ((sd >= _d(p["date"])) & (sd < _d(p["date_end"]))
         & (disc >= r.lit(p["discount_lo"])) & (disc <= r.lit(p["discount_hi"]))
         & (r.col("lineitem", "l_quantity") < r.lit(p["quantity"])))
    rev = (r.col("lineitem", "l_extendedprice")[m] * disc[m]).sum().reshape(1)
    return Result().num("revenue", rev).host()


def q7(r: Ref, j: _Joins, p: dict):
    sd = r.col("lineitem", "l_shipdate")
    m0 = (sd >= _d("1995-01-01")) & (sd <= _d("1996-12-31"))
    oidx, sidx = j.li_order()[m0], j.li_supp()[m0]
    cidx = j.order_cust()[oidx]
    sn = _nation_name(r, j, r.col("supplier", "s_nationkey")[sidx])
    cn = _nation_name(r, j, r.col("customer", "c_nationkey")[cidx])
    a, b = r.code("nation", "n_name", p["nation1"]), r.code("nation", "n_name", p["nation2"])
    m = ((sn == a) & (cn == b)) | ((sn == b) & (cn == a))
    year = r.year(sd[m0][m])
    vol = _rev(r, m0)[m]
    gid, n = group([sn[m], cn[m], year])
    nd = r.dictionary("nation", "n_name")
    out = (Result()
           .string("supp_nation", first(sn[m], gid, n), nd)
           .string("cust_nation", first(cn[m], gid, n), nd)
           .num("l_year", first(year, gid, n))
           .num("revenue", seg_sum(vol, gid, n)))
    return out.host([("supp_nation", False), ("cust_nation", False), ("l_year", False)])


def q8(r: Ref, j: _Joins, p: dict):
    part_ok = r.eq("part", "p_type", p["type"])
    pidx = j.li_part()
    m0 = part_ok[pidx]
    oidx = j.li_order()[m0]
    od = r.col("orders", "o_orderdate")[oidx]
    m1 = (od >= _d("1995-01-01")) & (od <= _d("1996-12-31"))
    oidx, od = oidx[m1], od[m1]
    cidx = j.order_cust()[oidx]
    in_region = _region_nations(r, p["region"])
    m2 = in_region[j.nation_row(r.col("customer", "c_nationkey")[cidx])]
    sidx = j.li_supp()[m0][m1][m2]
    n2 = _nation_name(r, j, r.col("supplier", "s_nationkey")[sidx])
    vol = _rev(r, m0)[m1][m2]
    year = r.year(od[m2])
    gid, n = group([year])
    brazil = torch.where(n2 == r.code("nation", "n_name", p["nation"]), vol,
                         torch.zeros_like(vol))
    out = (Result()
           .num("o_year", first(year, gid, n))
           .num("mkt_share", seg_sum(brazil, gid, n) / seg_sum(vol, gid, n)))
    return out.host([("o_year", False)])


def _ps_rows(r: Ref, partkey: torch.Tensor, suppkey: torch.Tensor) -> torch.Tensor:
    smax = int(r.col("partsupp", "ps_suppkey").max())
    build = pair_key(r.col("partsupp", "ps_partkey"), r.col("partsupp", "ps_suppkey"), smax)
    return lookup(build, pair_key(partkey, suppkey, smax))


def q9(r: Ref, j: _Joins, p: dict):
    part_ok = r.like("part", "p_name", f"%{p['color']}%")
    m = part_ok[j.li_part()]
    psr = _ps_rows(r, r.col("lineitem", "l_partkey")[m], r.col("lineitem", "l_suppkey")[m])
    sidx = j.li_supp()[m]
    oidx = j.li_order()[m]
    amount = (_rev(r, m) - r.col("partsupp", "ps_supplycost")[psr]
              * r.col("lineitem", "l_quantity")[m])
    nation = _nation_name(r, j, r.col("supplier", "s_nationkey")[sidx])
    year = r.year(r.col("orders", "o_orderdate")[oidx])
    gid, n = group([nation, year])
    out = (Result()
           .string("nation", first(nation, gid, n), r.dictionary("nation", "n_name"))
           .num("o_year", first(year, gid, n))
           .num("sum_profit", seg_sum(amount, gid, n)))
    return out.host([("nation", False), ("o_year", True)])


def q10(r: Ref, j: _Joins, p: dict):
    od = r.col("orders", "o_orderdate")
    o_ok = (od >= _d(p["date"])) & (od < _month_end(p["date"], 3))
    oidx = j.li_order()
    m = o_ok[oidx] & r.eq("lineitem", "l_returnflag", "R")
    cidx = j.order_cust()[oidx[m]]
    gid, n = group([cidx])
    c = first(cidx, gid, n)
    nrow = j.nation_row(r.col("customer", "c_nationkey")[c])
    cs = lambda name: r.col("customer", name)[c]  # noqa: E731
    cd = lambda name: r.dictionary("customer", name)  # noqa: E731
    out = (Result()
           .num("c_custkey", cs("c_custkey"))
           .string("c_name", cs("c_name"), cd("c_name"))
           .num("revenue", seg_sum(_rev(r, m), gid, n))
           .num("c_acctbal", cs("c_acctbal"))
           .string("n_name", r.col("nation", "n_name")[nrow], r.dictionary("nation", "n_name"))
           .string("c_address", cs("c_address"), cd("c_address"))
           .string("c_phone", cs("c_phone"), cd("c_phone"))
           .string("c_comment", cs("c_comment"), cd("c_comment")))
    return out.host([("revenue", True), ("c_custkey", False)], 20)


def q11(r: Ref, j: _Joins, p: dict):
    s_ok = _nation_name(r, j, r.col("supplier", "s_nationkey")) == r.code(
        "nation", "n_name", p["nation"])
    m = s_ok[j.ps_supp()]
    value = (r.col("partsupp", "ps_supplycost")[m]
             * r.col("partsupp", "ps_availqty")[m].to(r.f))
    threshold = value.sum() * r.lit(p["fraction"])
    pk = r.col("partsupp", "ps_partkey")[m]
    gid, n = group([pk])
    total = seg_sum(value, gid, n)
    keep = total > threshold
    out = (Result()
           .num("ps_partkey", first(pk, gid, n)[keep])
           .num("value", total[keep]))
    return out.host([("value", True), ("ps_partkey", False)])


def q12(r: Ref, j: _Joins, p: dict):
    cd, rd = r.col("lineitem", "l_commitdate"), r.col("lineitem", "l_receiptdate")
    m = (r.isin("lineitem", "l_shipmode", [p["shipmode1"], p["shipmode2"]])
         & (cd < rd) & (r.col("lineitem", "l_shipdate") < cd)
         & (rd >= _d(p["date"])) & (rd < _d(p["date_end"])))
    prio = r.col("orders", "o_orderpriority")[j.li_order()[m]]
    high = (prio == r.code("orders", "o_orderpriority", "1-URGENT")) | (
        prio == r.code("orders", "o_orderpriority", "2-HIGH"))
    mode = r.col("lineitem", "l_shipmode")[m]
    gid, n = group([mode])
    out = (Result()
           .string("l_shipmode", first(mode, gid, n), r.dictionary("lineitem", "l_shipmode"))
           .num("high_line_count", seg_sum(high.long(), gid, n))
           .num("low_line_count", seg_sum((~high).long(), gid, n)))
    return out.host([("l_shipmode", False)])


def q13(r: Ref, j: _Joins, p: dict):
    ok = ~r.like("orders", "o_comment", f"%{p['word1']}%{p['word2']}%")
    n_cust = r.ds.rows("customer")
    counts = torch.zeros(n_cust, dtype=torch.int64, device=r.device)
    counts.index_add_(0, j.order_cust()[ok], torch.ones_like(j.order_cust()[ok]))
    gid, n = group([counts])
    out = (Result()
           .num("c_count", first(counts, gid, n))
           .num("custdist", seg_count(gid, n)))
    return out.host([("custdist", True), ("c_count", True)])


def q14(r: Ref, j: _Joins, p: dict):
    sd = r.col("lineitem", "l_shipdate")
    m = (sd >= _d(p["date"])) & (sd < _d(p["date_end"]))
    promo = r.like("part", "p_type", "PROMO%")[j.li_part()[m]]
    rev = _rev(r, m)
    val = (r.lit("100.00") * torch.where(promo, rev, torch.zeros_like(rev)).sum()
           / rev.sum())
    return Result().num("promo_revenue", val.reshape(1)).host()


def q15(r: Ref, j: _Joins, p: dict):
    sd = r.col("lineitem", "l_shipdate")
    m = (sd >= _d(p["date"])) & (sd < _d(p["date_end"]))
    sk = r.col("lineitem", "l_suppkey")[m]
    gid, n = group([sk])
    total = seg_sum(_rev(r, m), gid, n)
    keys = first(sk, gid, n)
    best = total == total.max()
    srow = lookup(r.col("supplier", "s_suppkey"), keys[best])
    sc = lambda name: r.col("supplier", name)[srow]  # noqa: E731
    sd_ = lambda name: r.dictionary("supplier", name)  # noqa: E731
    out = (Result()
           .num("s_suppkey", sc("s_suppkey"))
           .string("s_name", sc("s_name"), sd_("s_name"))
           .string("s_address", sc("s_address"), sd_("s_address"))
           .string("s_phone", sc("s_phone"), sd_("s_phone"))
           .num("total_revenue", total[best]))
    return out.host([("s_suppkey", False)])


def q16(r: Ref, j: _Joins, p: dict):
    sizes = torch.tensor([int(s) for s in p["sizes"].split(",")], device=r.device)
    part_ok = (~r.eq("part", "p_brand", p["brand"])
               & ~r.like("part", "p_type", f"{p['type']}%")
               & torch.isin(r.col("part", "p_size"), sizes))
    bad = r.like("supplier", "s_comment", "%Customer%Complaints%")
    pidx, sidx = j.ps_part(), j.ps_supp()
    m = part_ok[pidx] & ~bad[sidx]
    pr = pidx[m]
    brand, ptype, size = (r.col("part", "p_brand")[pr], r.col("part", "p_type")[pr],
                          r.col("part", "p_size")[pr])
    gid, n = group([brand, ptype, size])
    out = (Result()
           .string("p_brand", first(brand, gid, n), r.dictionary("part", "p_brand"))
           .string("p_type", first(ptype, gid, n), r.dictionary("part", "p_type"))
           .num("p_size", first(size, gid, n))
           .num("supplier_cnt", count_distinct(gid, r.col("partsupp", "ps_suppkey")[m], n)))
    return out.host([("supplier_cnt", True), ("p_brand", False), ("p_type", False),
                     ("p_size", False)])


def q17(r: Ref, j: _Joins, p: dict):
    part_ok = (r.eq("part", "p_brand", p["brand"])
               & r.eq("part", "p_container", p["container"]))
    pidx = j.li_part()
    qty = r.col("lineitem", "l_quantity")
    n_part = r.ds.rows("part")
    avg = seg_sum(qty, pidx, n_part) / seg_count(pidx, n_part).to(r.f)
    m = part_ok[pidx] & (qty < r.lit(0.2) * avg[pidx])
    val = r.col("lineitem", "l_extendedprice")[m].sum() / r.lit(7.0)
    return Result().num("avg_yearly", val.reshape(1)).host()


def q18(r: Ref, j: _Joins, p: dict):
    oidx = j.li_order()
    n_ord = r.ds.rows("orders")
    qty = r.col("lineitem", "l_quantity")
    per_order = seg_sum(qty, oidx, n_ord)
    big = per_order > r.lit(p["quantity"])
    o = torch.nonzero(big).flatten()
    c = j.order_cust()[o]
    out = (Result()
           .string("c_name", r.col("customer", "c_name")[c], r.dictionary("customer", "c_name"))
           .num("c_custkey", r.col("customer", "c_custkey")[c])
           .num("o_orderkey", r.col("orders", "o_orderkey")[o])
           .date("o_orderdate", r.col("orders", "o_orderdate")[o])
           .num("o_totalprice", r.col("orders", "o_totalprice")[o])
           .num("sum_qty", per_order[o]))
    return out.host([("o_totalprice", True), ("o_orderdate", False),
                     ("o_orderkey", False)], 100)


def q19(r: Ref, j: _Joins, p: dict):
    m0 = (r.isin("lineitem", "l_shipmode", ["AIR", "AIR REG"])
          & r.eq("lineitem", "l_shipinstruct", "DELIVER IN PERSON"))
    pidx = j.li_part()
    qty = r.col("lineitem", "l_quantity")
    brand = r.col("part", "p_brand")[pidx]
    size = r.col("part", "p_size")[pidx]
    cont = r.col("part", "p_container")
    groups = (("SM", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 5),
              ("MED", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"], 10),
              ("LG", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"], 15))
    any_ok = torch.zeros_like(m0)
    for i, (_, conts, max_size) in enumerate(groups, start=1):
        cont_ok = torch.isin(cont, torch.tensor(
            [r.code("part", "p_container", c) for c in conts], device=r.device))[pidx]
        lo, hi = r.lit(p[f"quantity{i}"]), r.lit(p[f"quantity{i}_hi"])
        any_ok |= ((brand == r.code("part", "p_brand", p[f"brand{i}"])) & cont_ok
                   & (qty >= lo) & (qty <= hi) & (size >= 1) & (size <= max_size))
    m = m0 & any_ok
    return Result().num("revenue", _rev(r, m).sum().reshape(1)).host()


def q20(r: Ref, j: _Joins, p: dict):
    part_ok = r.like("part", "p_name", f"{p['color']}%")
    sd = r.col("lineitem", "l_shipdate")
    m = (sd >= _d(p["date"])) & (sd < _d(p["date_end"]))
    psr = _ps_rows(r, r.col("lineitem", "l_partkey")[m], r.col("lineitem", "l_suppkey")[m])
    n_ps = r.ds.rows("partsupp")
    found = psr >= 0
    qty_sum = seg_sum(r.col("lineitem", "l_quantity")[m][found], psr[found], n_ps)
    has = seg_count(psr[found], n_ps) > 0
    ok = (part_ok[j.ps_part()] & has
          & (r.col("partsupp", "ps_availqty").to(r.f) > r.lit(0.5) * qty_sum))
    supp = torch.unique(r.col("partsupp", "ps_suppkey")[ok])
    s_ok = (torch.isin(r.col("supplier", "s_suppkey"), supp)
            & (_nation_name(r, j, r.col("supplier", "s_nationkey"))
               == r.code("nation", "n_name", p["nation"])))
    out = (Result()
           .string("s_name", r.col("supplier", "s_name")[s_ok], r.dictionary("supplier", "s_name"))
           .string("s_address", r.col("supplier", "s_address")[s_ok],
                   r.dictionary("supplier", "s_address")))
    return out.host([("s_name", False)])


def q21(r: Ref, j: _Joins, p: dict):
    late = r.col("lineitem", "l_receiptdate") > r.col("lineitem", "l_commitdate")
    oidx = j.li_order()
    n_ord = r.ds.rows("orders")
    sk = r.col("lineitem", "l_suppkey")
    n_supp = count_distinct(oidx, sk, n_ord)
    n_late = count_distinct(oidx[late], sk[late], n_ord)
    f_ok = r.eq("orders", "o_orderstatus", "F")
    s_ok = _nation_name(r, j, r.col("supplier", "s_nationkey")) == r.code(
        "nation", "n_name", p["nation"])
    m = late & f_ok[oidx] & (n_supp[oidx] > 1) & (n_late[oidx] == 1) & s_ok[j.li_supp()]
    name = r.col("supplier", "s_name")[j.li_supp()[m]]
    gid, n = group([name])
    out = (Result()
           .string("s_name", first(name, gid, n), r.dictionary("supplier", "s_name"))
           .num("numwait", seg_count(gid, n)))
    return out.host([("numwait", True), ("s_name", False)], 100)


def q22(r: Ref, j: _Joins, p: dict):
    codes = [c.strip().strip("'") for c in p["codes"].split(",")]
    cntry, cdict = r.derived_strings("customer", "c_phone", lambda s: s[:2])
    in_list = torch.from_numpy(np.isin(cdict, codes)).to(r.device)[cntry]
    bal = r.col("customer", "c_acctbal")
    pos = in_list & (bal > r.lit("0.00"))
    avg = bal[pos].sum() / pos.sum().to(r.f)
    has = torch.zeros(r.ds.rows("customer"), dtype=torch.bool, device=r.device)
    has[j.order_cust()] = True
    m = in_list & (bal > avg) & ~has
    gid, n = group([cntry[m]])
    out = (Result()
           .string("cntrycode", first(cntry[m], gid, n), cdict)
           .num("numcust", seg_count(gid, n))
           .num("totacctbal", seg_sum(bal[m], gid, n)))
    return out.host([("cntrycode", False)])


QUERIES = {i: globals()[f"q{i}"] for i in range(1, 23)}


class Reference:
    """Runs the reference queries over one dataset; joins are shared."""

    def __init__(self, ds, float_dtype=torch.float64):
        self.r = Ref(ds, float_dtype)
        self.j = _Joins(self.r)

    def run(self, qid, slot_values: dict) -> dict:
        with torch.no_grad():
            return QUERIES[int(qid)](self.r, self.j, slot_values)
