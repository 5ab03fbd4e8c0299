"""The 22 TPC-H queries, frozen: templates whose slots are the
substitution parameters of TPC-H clause 2.4, and their validation values.

The texts are the port's (``repro_torch/data/tpch_queries.py::SQL_QUERIES``
at the time this benchmark was written) with each substitution parameter
turned into a ``{slot}``; filled with ``VALIDATION`` they give those texts
back (a test checks this).  The port's recorded deviations from the spec's
texts stay: tie-breaking ORDER BY keys, Q19's factored form, Q21's
distinct-supplier-count subqueries, Q22's expression group key, Q11's
threshold multiplied inside its subquery.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

from ..datagen import tpch as gen

TEMPLATES = {
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
where l_shipdate <= date '{date}'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey
  and s_suppkey = ps_suppkey
  and p_size = {size}
  and p_type like '%{type}'
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = '{region}'
  and ps_supplycost = (select min(ps_supplycost)
                       from partsupp, supplier, nation, region
                       where p_partkey = ps_partkey
                         and s_suppkey = ps_suppkey
                         and s_nationkey = n_nationkey
                         and n_regionkey = r_regionkey
                         and r_name = '{region}')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
    3: """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{segment}'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '{date}'
  and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate, l_orderkey
limit 10
""",
    4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '{date}'
  and o_orderdate < date '{date}' + interval '3' month
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
  and r_name = '{region}'
  and o_orderdate >= date '{date}'
  and o_orderdate < date '{date_end}'
group by n_name
order by revenue desc
""",
    6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{date}'
  and l_shipdate < date '{date_end}'
  and l_discount between {discount_lo} and {discount_hi}
  and l_quantity < {quantity}
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
        and ((n1.n_name = '{nation1}' and n2.n_name = '{nation2}')
          or (n1.n_name = '{nation2}' and n2.n_name = '{nation1}'))
        and l_shipdate between date '1995-01-01' and date '1996-12-31')
     as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
""",
    8: """
select o_year,
       sum(case when nation = '{nation}' then volume else 0 end)
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
        and r_name = '{region}'
        and s_nationkey = n2.n_nationkey
        and o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p_type = '{type}') as all_nations
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
        and p_name like '%{color}%') as profit
group by nation, o_year
order by nation, o_year desc
""",
    10: """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate >= date '{date}'
  and o_orderdate < date '{date}' + interval '3' month
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
  and n_name = '{nation}'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) >
       (select sum(ps_supplycost * ps_availqty) * {fraction}
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey
          and s_nationkey = n_nationkey
          and n_name = '{nation}')
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
  and l_shipmode in ('{shipmode1}', '{shipmode2}')
  and l_commitdate < l_receiptdate
  and l_shipdate < l_commitdate
  and l_receiptdate >= date '{date}'
  and l_receiptdate < date '{date_end}'
group by l_shipmode
order by l_shipmode
""",
    13: """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders
        on c_custkey = o_custkey
       and o_comment not like '%{word1}%{word2}%'
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
  and l_shipdate >= date '{date}'
  and l_shipdate < date '{date_end}'
""",
    15: """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier,
     (select l_suppkey, sum(l_extendedprice * (1 - l_discount))
          as total_revenue
      from lineitem
      where l_shipdate >= date '{date}'
        and l_shipdate < date '{date_end}'
      group by l_suppkey) as revenue0
where s_suppkey = l_suppkey
  and total_revenue = (select max(total_revenue)
                       from (select l_suppkey,
                                    sum(l_extendedprice * (1 - l_discount))
                                        as total_revenue
                             from lineitem
                             where l_shipdate >= date '{date}'
                               and l_shipdate < date '{date_end}'
                             group by l_suppkey) as revenue1)
order by s_suppkey
""",
    16: """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> '{brand}'
  and p_type not like '{type}%'
  and p_size in ({sizes})
  and ps_suppkey not in (select s_suppkey from supplier
                         where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = '{brand}'
  and p_container = '{container}'
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
                     having sum(l_quantity) > {quantity})
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
  and ((p_brand = '{brand1}'
        and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        and l_quantity between {quantity1} and {quantity1_hi}
        and p_size between 1 and 5)
    or (p_brand = '{brand2}'
        and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        and l_quantity between {quantity2} and {quantity2_hi}
        and p_size between 1 and 10)
    or (p_brand = '{brand3}'
        and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        and l_quantity between {quantity3} and {quantity3_hi}
        and p_size between 1 and 15))
""",
    20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (select ps_suppkey
                    from partsupp
                    where ps_partkey in (select p_partkey from part
                                         where p_name like '{color}%')
                      and ps_availqty > (select 0.5 * sum(l_quantity)
                                         from lineitem
                                         where l_partkey = ps_partkey
                                           and l_suppkey = ps_suppkey
                                           and l_shipdate >= date '{date}'
                                           and l_shipdate < date '{date_end}'))
  and s_nationkey = n_nationkey
  and n_name = '{nation}'
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
  and n_name = '{nation}'
group by s_name
order by numwait desc, s_name
limit 100
""",
    22: """
select substring(c_phone, 1, 2) as cntrycode,
       count(*) as numcust,
       sum(c_acctbal) as totacctbal
from customer
where substring(c_phone, 1, 2) in ({codes})
  and c_acctbal > (select avg(c_acctbal) from customer
                   where c_acctbal > 0.00
                     and substring(c_phone, 1, 2)
                         in ({codes}))
  and not exists (select * from orders where o_custkey = c_custkey)
group by substring(c_phone, 1, 2)
order by cntrycode
""",
}

# clause 2.4's validation values at SF1, as the port's texts carry them
VALIDATION: Dict[int, dict] = {
    1: {"delta": 90},
    2: {"size": 15, "type": "BRASS", "region": "EUROPE"},
    3: {"segment": "BUILDING", "date": "1995-03-15"},
    4: {"date": "1993-07-01"},
    5: {"region": "ASIA", "date": "1994-01-01"},
    6: {"date": "1994-01-01", "discount": 0.06, "quantity": 24},
    7: {"nation1": "FRANCE", "nation2": "GERMANY"},
    8: {"nation": "BRAZIL", "type": "ECONOMY ANODIZED STEEL"},
    9: {"color": "green"},
    10: {"date": "1993-10-01"},
    11: {"nation": "GERMANY", "fraction": 0.0001},
    12: {"shipmode1": "MAIL", "shipmode2": "SHIP", "date": "1994-01-01"},
    13: {"word1": "special", "word2": "requests"},
    14: {"date": "1995-09-01"},
    15: {"date": "1996-01-01"},
    16: {"brand": "Brand#45", "type": "MEDIUM POLISHED",
         "sizes": [49, 14, 23, 45, 19, 3, 36, 9]},
    17: {"brand": "Brand#23", "container": "MED BOX"},
    18: {"quantity": 300},
    19: {"quantity1": 1, "quantity2": 10, "quantity3": 20,
         "brand1": "Brand#12", "brand2": "Brand#23", "brand3": "Brand#34"},
    20: {"color": "forest", "date": "1994-01-01", "nation": "CANADA"},
    21: {"nation": "SAUDI ARABIA"},
    22: {"codes": ["13", "31", "23", "29", "30", "18", "17"]},
}

IDS = tuple(sorted(TEMPLATES))
NATION_REGION = {n: gen.REGIONS[r] for n, r in gen.NATIONS}


def _add_months(date: str, months: int) -> str:
    d = np.datetime64(date, "M") + np.timedelta64(months, "M")
    return f"{d}-{date[8:]}"


def _add_days(date: str, n: int) -> str:
    return str(np.datetime64(date, "D") + np.timedelta64(n, "D"))


def parameters(qid: int, scale: float) -> dict:
    """Clause 2.4's validation values at scale factor ``scale``: Q11's
    FRACTION is 0.0001 / SF (clause 2.4.11.3); the rest hold at every
    scale."""
    p = dict(VALIDATION[qid])
    if qid == 11:
        p["fraction"] = p["fraction"] / scale
    return p


def slots(qid: int, params: dict) -> dict:
    """The template's slot values for ``params`` (derived dates and
    bounds included)."""
    p = dict(params)
    if qid == 1:
        return {"date": _add_days("1998-12-01", -p["delta"])}
    if qid == 5 or qid == 12 or qid == 20:
        p["date_end"] = _add_months(p["date"], 12)
    if qid == 6:
        p["date_end"] = _add_months(p["date"], 12)
        p["discount_lo"] = f"{p['discount'] - 0.01:.2f}"
        p["discount_hi"] = f"{p['discount'] + 0.01:.2f}"
    if qid == 8:
        p["region"] = NATION_REGION[p["nation"]]
    if qid == 11:
        p["fraction"] = np.format_float_positional(p["fraction"])
    if qid == 14:
        p["date_end"] = _add_months(p["date"], 1)
    if qid == 15:
        p["date_end"] = _add_months(p["date"], 3)
    if qid == 16:
        p["sizes"] = ", ".join(str(s) for s in p["sizes"])
    if qid == 19:
        for i in (1, 2, 3):
            p[f"quantity{i}_hi"] = p[f"quantity{i}"] + 10
    if qid == 22:
        p["codes"] = ", ".join(f"'{c}'" for c in p["codes"])
    return p


def text(qid: int, params: dict) -> str:
    return TEMPLATES[qid].format(**slots(qid, params))


def columns(qid: int) -> list:
    """(table, column) pairs the template references: each base-table
    column named in its text, once."""
    words = set(re.findall(r"[a-z_]+", TEMPLATES[qid].lower()))
    return [(t, c) for t, cols in SCHEMA.items() for c in cols if c in words]


SCHEMA = {
    "region": ["r_regionkey", "r_name", "r_comment"],
    "nation": ["n_nationkey", "n_name", "n_regionkey", "n_comment"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
                 "s_acctbal", "s_comment"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
             "p_container", "p_retailprice", "p_comment"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost",
                 "ps_comment"],
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
                 "c_acctbal", "c_mktsegment", "c_comment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
               "o_comment"],
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
                 "l_receiptdate", "l_shipinstruct", "l_shipmode",
                 "l_comment"],
}
