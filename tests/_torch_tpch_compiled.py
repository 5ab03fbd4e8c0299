"""Shared by ``test_torch_tpch_compiled*.py``: the 22 hand-built TPC-H plans
cold, in order 1..22, on one default engine of each package (the reference's
``SiriusEngine(use_kernels=...)`` and the port's), per query: the result,
the kernel hits, the region stat deltas and whether the entry compiled a
replay."""
from repro.core.executor import SiriusEngine as RefEngine
from repro.data.tpch import load_into_engine as ref_load
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import QUERIES

from conftest import assert_tables_equal

QIDS = sorted(QUERIES)
# group-bys with a count distinct a query runs: the port's kernel backend
# takes them, the reference's declines them
DISTINCT_GROUPBYS = {16: 1, 21: 2}
STATS = ("traces", "cache_hits", "region_calls", "fused_probes", "eager_ops")


def _run_all(eng, queries, compiled_entry):
    out = {}
    for qid in QIDS:
        hits0 = eng.backend.hit_counts() if eng.backend is not None else None
        stats0 = dict(eng.compiler.stats)
        res = eng.execute(queries[qid]()).to_host()
        hits = None
        if hits0 is not None:
            after = eng.backend.hit_counts()
            hits = {k: after[k] - hits0[k] for k in after}
        stats = {k: eng.compiler.stats[k] - stats0[k] for k in STATS}
        out[qid] = (res, hits, stats, compiled_entry(eng))
    return out


def _ref_compiled(eng):
    ex = eng.executor
    return ex.plan_cache._entries[ex.last_plan_signature].compiled is not None


def reference_runs(db, use_kernels: bool):
    eng = RefEngine(use_kernels=use_kernels)
    ref_load(eng, db)
    return _run_all(eng, REF_QUERIES, _ref_compiled)


def port_runs(db, use_kernels: bool):
    """(the port's default engine, its per-query cold runs)."""
    eng = SiriusEngine(device="cpu", use_kernels=use_kernels)
    assert eng.executor.compile_pipelines    # the reference's default
    load_into_engine(eng, db)
    return eng, _run_all(eng, QUERIES, lambda e: None)


def check_cold_run(qid, port, reference):
    res, hits, stats, _ = port[1][qid]
    want, want_hits, want_stats, _ = reference[qid]
    assert_tables_equal(res, want)
    if hits is not None and want_hits is not None:
        want_hits = {**want_hits,
                     "agg": want_hits["agg"] + DISTINCT_GROUPBYS.get(qid, 0)}
    assert hits == want_hits
    assert stats == want_stats


def check_warm_run(qid, port, reference):
    """The second run of each query is a replay: no region trace, no scalar
    pull, one barrier, no first-call time, and the reference's result."""
    eng = port[0]
    traces = eng.compiler.stats["traces"]
    syncs = instrument.scalar_syncs.value
    barriers = instrument.sync_barriers.value
    got = eng.execute(QUERIES[qid]()).to_host()
    assert eng.executor.last_plan_cache_hit
    assert eng.executor.last_replay_mode == "closure"      # no card here
    assert eng.compiler.stats["traces"] == traces
    assert instrument.scalar_syncs.value == syncs
    assert instrument.sync_barriers.value - barriers == 1
    assert eng.executor.last_compile_seconds == 0.0
    assert_tables_equal(got, reference[qid][0])
