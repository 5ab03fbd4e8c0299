"""Quickstart: drop-in accelerated SQL, from SQL text to device results.

Counterpart of the reference's ``examples/quickstart.py``, step for step:
the paper's single-node lifecycle (§3.3) end to end, with the SQL frontend
as the primary path.  SQL text is parsed, bound against the TPC-H catalog,
lowered to the Substrait-like plan IR, rewritten by the rule-based
optimizer (predicate pushdown, projection pruning, join ordering,
build-side selection), serialized across the host-DB → engine boundary,
and executed with the buffer manager's cached tables and the hand-written
CUDA kernels (``use_kernels=True``).  Hand-built plans remain as the
oracle path, and a plan the device cannot run (here: a table only the host
holds) degrades to the numpy host engine (§3.2.2).

Run on the card:

    PYTHONPATH=src python -m repro_torch.quickstart

``main(device="cpu")`` runs the same steps on the CPU, where every kernel
wrapper runs its plain version.  ``main`` prints as the reference does and
returns a summary: the SQL result's rows, the wire's byte count, Q3's SQL
path against its hand-built plan, the hand-built plan's revenues, the
pipeline compiler's counts, the kernel hits, the fallback's route and
value, and Q6's cold and hot milliseconds.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .core.executor import SiriusEngine
from .core.plan import (
    AggregateRel, JoinRel, ReadRel, Rel, SortRel, explain, plan_from_json,
    plan_to_json,
)
from .data.tpch import generate, load_into_engine
from .data.tpch_queries import QUERIES, SQL_QUERIES
from .relational import AggSpec, Col, SortKey
from .sql import sql_to_plan

SF = 0.01

SQL = """
    select c_mktsegment, sum(o_totalprice) as revenue,
           count(*) as orders
    from orders, customer
    where o_custkey = c_custkey and o_totalprice > 0
    group by c_mktsegment
    order by revenue desc
"""


def revenue_plan() -> Rel:
    """The hand-built plan of ``SQL``'s revenues (no count, no filter)."""
    return SortRel(
        AggregateRel(
            JoinRel(ReadRel("orders"), ReadRel("customer"),
                    ["o_custkey"], ["c_custkey"], "inner"),
            ["c_mktsegment"],
            [AggSpec("sum", Col("o_totalprice"), "revenue")]),
        [SortKey("revenue", ascending=False)])


def fallback_plan() -> Rel:
    """A sum over ``mystery``, a table that only ``host_tables`` holds."""
    return AggregateRel(ReadRel("mystery"), [],
                        [AggSpec("sum", Col("x"), "s")])


def _same(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    return all(
        np.allclose(a[k].astype(float), b[k].astype(float))
        if np.asarray(a[k]).dtype.kind == "f"
        else (np.asarray(a[k]) == np.asarray(b[k])).all()
        for k in a)


def main(device=None) -> Dict:
    print(f"== generating TPC-H (SF {SF}) and cold-loading the cache ==")
    db = generate(SF)
    engine = SiriusEngine(use_kernels=True, device=device)
    load_into_engine(engine, db)
    print("buffer manager:", engine.buffers.stats()["cached_tables"])

    print("\n== the primary path: SQL text in, device table out ==")
    rows = engine.sql(SQL).to_pylist()
    for row in rows:
        print(f"  {row['c_mktsegment']:<12} revenue={row['revenue']:>14,.2f} "
              f"orders={row['orders']}")

    print("\n== what the optimizer did (EXPLAIN, with row estimates) ==")
    naive = sql_to_plan(SQL, optimize=False)
    optimized = sql_to_plan(SQL, optimize=True)
    print("naive plan:")
    print(explain(naive))
    print("optimized plan (filters at scans, pruned reads, build sides):")
    print(explain(optimized))

    print("\n== the plan crosses the Substrait-like wire boundary ==")
    wire = plan_to_json(optimized)          # host DB → engine handoff
    print(f"wire format: {len(wire)} bytes of JSON")
    engine.execute(plan_from_json(wire))

    print("\n== TPC-H Q3: SQL text vs the hand-built oracle plan ==")
    q3_sql = engine.sql(SQL_QUERIES[3]).to_host()
    q3_oracle = engine.execute(QUERIES[3]()).to_host()
    q3_same = _same(q3_sql, q3_oracle)
    q3_rows = len(q3_sql["l_orderkey"])
    print(f"rows: {q3_rows}, SQL path == hand-built plan: {q3_same}")

    print("\n== hand-built plans still work (the fallback/oracle path) ==")
    revenues = engine.execute(revenue_plan()).to_host()["revenue"]
    print(revenues)

    print("\n== compiled pipelines: SiriusEngine(use_kernels=True) timings ==")
    # the first run of a query shape records its fused regions and its
    # executable plan; repeat runs replay them, with one host wait for the
    # result table
    t0 = time.perf_counter()
    engine.sql(SQL_QUERIES[6])
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        engine.sql(SQL_QUERIES[6])
    hot = (time.perf_counter() - t0) / 3
    s = engine.compiler.stats
    compiler = {"regions": len(engine.compiler.cache),
                "traces": s["traces"], "cache_hits": s["cache_hits"],
                "fused_probes": s["fused_probes"]}
    print(f"Q6 cold (record): {cold*1e3:.1f} ms   "
          f"hot (replay): {hot*1e3:.1f} ms")
    print(f"compiled regions: {compiler['regions']}, "
          f"traces: {compiler['traces']}, "
          f"cache hits: {compiler['cache_hits']}, "
          f"fused probes: {compiler['fused_probes']}")

    print("\n== kernel backend usage ==")
    b = engine.backend
    hits = {"filter": b.filter_hits, "probe": b.probe_hits,
            "agg": b.agg_hits}
    print(f"CUDA filter kernel hits: {hits['filter']}, "
          f"probe kernel hits: {hits['probe']}, "
          f"group-by aggregation kernel hits: {hits['agg']}")

    print("\n== graceful fallback (§3.2.2) ==")
    engine.host_tables["mystery"] = {"x": np.arange(4.0)}
    res, path = engine.execute_with_fallback(fallback_plan())
    print(f"executed on: {path}; result={res['s'][0]}")

    return {"rows": rows, "wire_bytes": len(wire), "q3_rows": q3_rows,
            "q3_same": bool(q3_same), "revenues": revenues,
            "compiler": compiler, "hits": hits,
            "fallback": {"route": path, "s": float(res["s"][0]),
                         "queries": engine.executor.fallback_queries},
            "q6_cold_ms": cold * 1e3, "q6_hot_ms": hot * 1e3}


if __name__ == "__main__":
    main()
