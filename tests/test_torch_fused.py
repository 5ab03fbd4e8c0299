"""Fused pipeline regions on the port: ``tests/test_fused.py``'s contracts,
on the CPU, against the JAX package.

1. **No device→host copies inside pipelines** on a warm SQL run of
   ``RESIDENCY_QIDS``, with and without kernels (``track_transfers("cpu")``
   counts on CPU tensors the copies a card run would make).
2. **Regions are cached across queries**: a second run traces nothing, a
   cold re-lowering reuses the regions, and the region traces and region
   cache hits of each SQL query equal the reference engine's.
3. The aggregation kernel route, the probe variants (inner / semi / anti /
   mark) against the numpy oracle, a regrown build table in a cached
   region, duplicate build keys and an unfusable probe key falling back to
   eager ops, and ``profile=True``.
Float results are held with the suite's rtol 1e-6, other columns row-exact.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.executor import SiriusEngine as RefEngine
from repro.core.fallback import FallbackEngine
from repro.core.plan import JoinRel as RefJoinRel, ReadRel as RefReadRel
from repro.data.tpch import load_into_engine as ref_load
from repro.relational.table import Table as RefTable
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.plan import AggregateRel, JoinRel, ReadRel
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import QUERIES, SQL_QUERIES
from repro_torch.relational.aggregate import AggSpec
from repro_torch.relational.expressions import Col
from repro_torch.relational.table import Table

from conftest import assert_tables_equal

torch.set_num_threads(1)

RESIDENCY_QIDS = (1, 3, 6, 13, 16, 22)
STATS = ("traces", "cache_hits")


def _engine(db, **kw):
    eng = SiriusEngine(device="cpu", **kw)
    load_into_engine(eng, db)
    return eng


@pytest.fixture(scope="module")
def fused_engine(tpch_db):
    return _engine(tpch_db)


@pytest.fixture(scope="module")
def kernel_engine(tpch_db):
    return _engine(tpch_db, use_kernels=True)


def _sql_stats(eng):
    """Per RESIDENCY_QIDS query in order, twice over: the region traces and
    cache hits each SQL run adds."""
    out = []
    for _ in range(2):
        for qid in RESIDENCY_QIDS:
            s0 = dict(eng.compiler.stats)
            eng.sql(SQL_QUERIES[qid])
            out.append({k: eng.compiler.stats[k] - s0[k] for k in STATS})
    return out


@pytest.fixture(scope="module")
def reference_sql_stats(tpch_db):
    out = {}
    for uk in (False, True):
        eng = RefEngine(use_kernels=uk)
        ref_load(eng, tpch_db)
        out[uk] = _sql_stats(eng)
    return out


# ---------------------------------------------------------------------------
# 1. device residency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qid", RESIDENCY_QIDS)
def test_no_host_transfers_inside_pipelines(qid, fused_engine):
    fused_engine.sql(SQL_QUERIES[qid])          # cold: record
    with instrument.track_transfers("cpu") as counter:
        res = fused_engine.sql(SQL_QUERIES[qid])
    assert counter.in_pipeline == 0, (
        f"Q{qid}: {counter.in_pipeline} device→host copies inside pipelines")
    with instrument.track_transfers("cpu") as counter:
        res.to_host()
    assert counter.total > 0, "sanity: the counter must detect real copies"


@pytest.mark.parametrize("qid", RESIDENCY_QIDS)
def test_no_host_transfers_with_kernels(qid, kernel_engine):
    kernel_engine.sql(SQL_QUERIES[qid])
    with instrument.track_transfers("cpu") as counter:
        kernel_engine.sql(SQL_QUERIES[qid])
    assert counter.in_pipeline == 0


# ---------------------------------------------------------------------------
# 2. region cache
# ---------------------------------------------------------------------------


def test_second_run_compiles_nothing(fused_engine):
    fused_engine.sql(SQL_QUERIES[3])
    stats0 = dict(fused_engine.compiler.stats)
    fused_engine.sql(SQL_QUERIES[3])
    stats1 = dict(fused_engine.compiler.stats)
    assert stats1["traces"] == stats0["traces"], "rerun must not retrace"
    assert fused_engine.executor.last_plan_cache_hit
    # a cold re-lowering (plan cache dropped) reuses the regions
    fused_engine.executor.plan_cache.clear()
    fused_engine.sql(SQL_QUERIES[3])
    stats2 = dict(fused_engine.compiler.stats)
    assert stats2["traces"] == stats1["traces"], "regions must be reused"
    assert stats2["cache_hits"] > stats1["cache_hits"]
    assert stats2["region_calls"] > stats1["region_calls"]


def test_regions_cached_across_distinct_queries(fused_engine):
    for qid in RESIDENCY_QIDS:
        fused_engine.sql(SQL_QUERIES[qid])
    traces0 = fused_engine.compiler.stats["traces"]
    for qid in RESIDENCY_QIDS:
        fused_engine.sql(SQL_QUERIES[qid])
    assert fused_engine.compiler.stats["traces"] == traces0


@pytest.mark.parametrize("use_kernels", [False, True])
def test_region_traces_and_cache_hits_match_reference(use_kernels, tpch_db,
                                                      reference_sql_stats):
    """Fresh engines, the same SQL queries in the same order, twice: every
    cold run adds the reference's region traces and region cache hits, and
    so does every warm run with kernels (both packages replay the closure
    loop there).  Without kernels the reference replays one compiled
    program, which consults no region, where the port on the CPU replays
    the closure loop: those warm runs trace nothing in either."""
    mine = _sql_stats(_engine(tpch_db, use_kernels=use_kernels))
    ref = reference_sql_stats[use_kernels]
    n = len(RESIDENCY_QIDS)
    assert mine[:n] == ref[:n]
    if use_kernels:
        assert mine[n:] == ref[n:]
    else:
        assert all(s["traces"] == 0 for s in mine[n:] + ref[n:])
    assert sum(s["traces"] for s in mine) > 0


# ---------------------------------------------------------------------------
# 3. routes and degradation
# ---------------------------------------------------------------------------


def test_agg_kernel_fires_and_matches_oracle(kernel_engine, tpch_db):
    hits0 = kernel_engine.backend.agg_hits
    res = kernel_engine.execute(QUERIES[1]()).to_host()
    assert kernel_engine.backend.agg_hits > hits0
    from repro.data.tpch_queries import QUERIES as REF_QUERIES
    assert_tables_equal(res, FallbackEngine(tpch_db).execute(REF_QUERIES[1]()))


def test_agg_kernel_minmax_and_strings(kernel_engine, tpch_db):
    from repro.core.plan import AggregateRel as RefAgg
    from repro.relational.aggregate import AggSpec as RefSpec
    from repro.relational.expressions import Col as RefCol

    specs = [("min", "o_totalprice", "mn"), ("max", "o_totalprice", "mx"),
             ("avg", "o_totalprice", "av"), ("count_star", None, "n")]
    plan = AggregateRel(ReadRel("orders"), ["o_orderpriority"], [
        AggSpec(fn, Col(c) if c else None, name) for fn, c, name in specs])
    ref_plan = RefAgg(RefReadRel("orders"), ["o_orderpriority"], [
        RefSpec(fn, RefCol(c) if c else None, name) for fn, c, name in specs])
    hits0 = kernel_engine.backend.agg_hits
    res = kernel_engine.execute(plan).to_host()
    assert kernel_engine.backend.agg_hits > hits0
    assert_tables_equal(res, FallbackEngine(tpch_db).execute(ref_plan))


def test_agg_kernel_declines_float_keys(kernel_engine):
    t = Table.from_pydict({"g": np.array([0.5, 0.5, 1.5]),
                           "v": np.array([1.0, 2.0, 3.0])})
    out = kernel_engine.backend.try_aggregate(
        t, ["g"], [AggSpec("sum", Col("v"), "s")])
    assert out is None


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("how", ["inner", "semi", "anti", "mark"])
def test_fused_probe_variants_match(how, use_kernels, tpch_db):
    eng = _engine(tpch_db, use_kernels=use_kernels)
    plan = JoinRel(ReadRel("orders"), ReadRel("customer"),
                   ["o_custkey"], ["c_custkey"], how)
    res = eng.execute(plan).to_host()
    ref = FallbackEngine(tpch_db).execute(
        RefJoinRel(RefReadRel("orders"), RefReadRel("customer"),
                   ["o_custkey"], ["c_custkey"], how))
    assert_tables_equal(res, ref)
    assert eng.compiler.stats["fused_probes"] >= 1
    # the replay gives the same rows
    assert_tables_equal(eng.execute(plan).to_host(), ref)
    assert eng.executor.last_plan_cache_hit


def test_cached_region_with_regrown_build_table():
    """A cached region run with a *larger* build table in the same padding
    bucket must gather the new rows, not clamp to the old row count."""
    eng = SiriusEngine(device="cpu")

    def tables(n_build):
        eng.buffers.cache_table("probe", Table.from_pydict(
            {"k": np.arange(n_build + 20, dtype=np.int64)}))
        eng.buffers.cache_table("build", Table.from_pydict(
            {"k": np.arange(n_build, dtype=np.int64),
             "v": np.arange(n_build, dtype=np.int64) * 10}))

    def plan():
        return JoinRel(ReadRel("probe"), ReadRel("build"), ["k"], ["k"],
                       "inner")

    tables(100)                 # caches the region (bucket 128)
    eng.execute(plan())
    tables(120)                 # same bucket, 20 more rows
    out = eng.execute(plan()).to_host()
    assert not eng.executor.last_plan_cache_hit    # the epochs moved
    assert len(out["k"]) == 120
    assert (out["v"] == out["k"] * 10).all()


def test_duplicate_build_keys_degrade_to_eager(tpch_db):
    eng = _engine(tpch_db)
    plan = JoinRel(ReadRel("customer"), ReadRel("orders"),
                   ["c_custkey"], ["o_custkey"], "inner")
    res = eng.execute(plan).to_host()
    ref = FallbackEngine(tpch_db).execute(
        RefJoinRel(RefReadRel("customer"), RefReadRel("orders"),
                   ["c_custkey"], ["o_custkey"], "inner"))
    assert_tables_equal(res, ref)
    assert eng.compiler.stats["eager_ops"] >= 1


def test_unfusable_probe_key_declines_and_runs_eagerly():
    """A float probe key against an integer build key is the reference's
    deliberate trace abort: the region declines (counted) and its ops run
    eagerly, with the reference's rows; the decline sticks to the region."""
    probe = {"k": np.array([1.0, 2.5, 3.0, 7.0, 3.0]),
             "pv": np.arange(5, dtype=np.int64)}
    build = {"k": np.array([3, 1, 9], dtype=np.int64),
             "bv": np.array([30, 10, 90], dtype=np.int64)}
    eng = SiriusEngine(device="cpu")
    ref = RefEngine()
    for name, data in (("p", probe), ("b", build)):
        eng.register(name, Table.from_pydict(data))
        ref.register(name, RefTable.from_pydict(data))
    want = ref.execute(RefJoinRel(RefReadRel("p"), RefReadRel("b"),
                                  ["k"], ["k"], "inner")).to_host()
    for _ in range(2):
        got = eng.execute(JoinRel(ReadRel("p"), ReadRel("b"),
                                  ["k"], ["k"], "inner")).to_host()
        assert_tables_equal(got, want)
    assert eng.compiler.stats["declines"] == 1
    assert eng.compiler.stats["fused_probes"] == 1


def test_profile_mode_records_op_times(tpch_db):
    eng = _engine(tpch_db, profile=True)
    res = eng.execute(QUERIES[6]()).to_host()
    from repro.data.tpch_queries import QUERIES as REF_QUERIES
    assert_tables_equal(res, FallbackEngine(tpch_db).execute(REF_QUERIES[6]()))
    assert sum(eng.executor.op_times.values()) > 0
    assert not eng.executor.last_plan_cache_hit
