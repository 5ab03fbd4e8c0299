"""The executable-plan cache on the port: ``tests/test_plan_cache.py``'s
contracts (the Substrait wire cache aside, which
``tests/test_torch_substrait.py`` holds), plan JSON, and
``tests/test_join_sync.py``'s warm join queries, on the CPU.

* Signatures: stable across fresh plan objects, distinct across the 22
  queries, and equal to the reference's ``plan_signature`` string for each;
  ``plan_to_json`` byte-identical to the reference's, round-tripping, and
  ``walk_deep`` / ``rel_exprs`` visiting what the reference's visit.
* Invalidation: ``register`` clears the cache, a direct ``cache_table``
  bumps the table's epoch, a poisoned recording raises ``ReplayMismatch``
  and re-runs cold, and any other error in a replay raises.
* Front door: the normalized SQL text skips the parser.
* ``PlanCache``: LRU eviction, invalidate and clear.
* ``JOIN_QUERIES`` on the warm path, row-exact (rtol 1e-6 for floats)
  against the numpy oracle, with no scalar sync.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.fallback import FallbackEngine
from repro.core.plan import plan_to_json as ref_plan_to_json
from repro.core.plan import rel_exprs as ref_rel_exprs
from repro.core.plan import walk_deep as ref_walk_deep
from repro.core.plan_cache import plan_signature as ref_plan_signature
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro_torch import sql as port_sql
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.plan import plan_from_json, plan_to_json, rel_exprs, walk_deep
from repro_torch.core.plan_cache import ExecutablePlan, PlanCache, plan_signature
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.relational.table import Table

from conftest import assert_tables_equal
from test_join_sync import JOIN_QUERIES

torch.set_num_threads(1)

QIDS = sorted(QUERIES)


def _engine(db, **kw):
    eng = SiriusEngine(device="cpu", **kw)
    load_into_engine(eng, db)
    return eng


@pytest.fixture(scope="module")
def engines(tpch_db):
    return {uk: _engine(tpch_db, use_kernels=uk) for uk in (False, True)}


# ---------------------------------------------------------------------------
# signatures and plan JSON, all 22 plans
# ---------------------------------------------------------------------------


def test_signature_stable_across_fresh_plan_objects():
    assert plan_signature(QUERIES[3]()) == plan_signature(QUERIES[3]())


def test_signature_distinguishes_queries():
    sigs = {plan_signature(QUERIES[qid]()) for qid in QIDS}
    assert len(sigs) == len(QUERIES)


@pytest.mark.parametrize("qid", QIDS)
def test_signature_equals_reference(qid):
    assert plan_signature(QUERIES[qid]()) == ref_plan_signature(
        REF_QUERIES[qid]())


@pytest.mark.parametrize("qid", QIDS)
def test_plan_json_equals_reference_and_round_trips(qid):
    text = plan_to_json(QUERIES[qid]())
    assert text == ref_plan_to_json(REF_QUERIES[qid]())
    back = plan_from_json(text)
    assert plan_to_json(back) == text
    assert plan_signature(back) == plan_signature(QUERIES[qid]())


@pytest.mark.parametrize("qid", QIDS)
def test_walk_deep_and_rel_exprs_match_reference(qid):
    mine = [(type(r).__name__, len(rel_exprs(r)))
            for r in walk_deep(QUERIES[qid]())]
    ref = [(type(r).__name__, len(ref_rel_exprs(r)))
           for r in ref_walk_deep(REF_QUERIES[qid]())]
    assert mine == ref


# ---------------------------------------------------------------------------
# first-call time attribution
# ---------------------------------------------------------------------------


def test_cold_run_attributes_compile_time(tpch_db):
    eng = _engine(tpch_db)
    eng.execute(QUERIES[3]())                      # q3 builds fused regions
    assert eng.executor.last_compile_seconds > 0.0
    assert not eng.executor.last_plan_cache_hit
    eng.execute(QUERIES[3]())
    assert eng.executor.last_compile_seconds == 0.0


# ---------------------------------------------------------------------------
# invalidation: register(), direct re-caches, poisoned recordings, errors
# ---------------------------------------------------------------------------


def test_register_clears_cache(tpch_db):
    eng = _engine(tpch_db)
    eng.execute(QUERIES[6]())
    eng.execute(QUERIES[6]())
    assert eng.executor.last_plan_cache_hit
    assert len(eng.executor.plan_cache) > 0
    eng.sql("select count(*) as c from nation")
    assert eng._sql_plan_sigs
    eng.register("lineitem", Table.from_pydict(tpch_db["lineitem"]))
    assert len(eng.executor.plan_cache) == 0
    assert not eng._sql_plan_sigs
    eng.execute(QUERIES[6]())
    assert not eng.executor.last_plan_cache_hit


def test_direct_recache_bumps_epoch_and_invalidates(tpch_db):
    eng = _engine(tpch_db)
    cold = eng.execute(QUERIES[6]()).to_host()
    eng.execute(QUERIES[6]())
    assert eng.executor.last_plan_cache_hit
    epoch = eng.buffers.table_epochs["lineitem"]
    eng.buffers.cache_table("lineitem", eng.buffers.get("lineitem"))
    assert eng.buffers.table_epochs["lineitem"] == epoch + 1
    inval0 = eng.executor.plan_cache.stats["invalidations"]
    again = eng.execute(QUERIES[6]()).to_host()
    assert not eng.executor.last_plan_cache_hit
    assert eng.executor.plan_cache.stats["invalidations"] == inval0 + 1
    assert_tables_equal(again, cold)
    eng.execute(QUERIES[6]())
    assert eng.executor.last_plan_cache_hit


@pytest.mark.parametrize("use_kernels", [False, True])
def test_replay_mismatch_falls_back_to_cold_run(use_kernels, tpch_db):
    """A recorded device scalar changed by one: the replay's flag is set,
    ``ReplayMismatch`` invalidates the entry and a cold run answers."""
    eng = _engine(tpch_db, use_kernels=use_kernels)
    cold = eng.execute(QUERIES[3]()).to_host()
    entry = eng.executor.plan_cache._entries[eng.executor.last_plan_signature]
    rp = next(rp for rp in entry.pipelines if rp.must_run and rp.values)
    rp.values[0] = rp.values[0] + 1
    mism0 = eng.executor.plan_cache.stats["replay_mismatches"]
    out = eng.execute(QUERIES[3]()).to_host()
    assert eng.executor.plan_cache.stats["replay_mismatches"] == mism0 + 1
    assert not eng.executor.last_plan_cache_hit
    assert_tables_equal(out, cold)
    eng.execute(QUERIES[3]())                      # the re-recorded entry
    assert eng.executor.last_plan_cache_hit


def test_replay_with_a_pull_too_many_is_a_mismatch(tpch_db):
    """A recording with a value the replay never asks for is stale too."""
    eng = _engine(tpch_db)
    eng.execute(QUERIES[6]())
    entry = eng.executor.plan_cache._entries[eng.executor.last_plan_signature]
    entry.pipelines[-1].values.append(0)
    mism0 = eng.executor.plan_cache.stats["replay_mismatches"]
    eng.execute(QUERIES[6]())
    assert eng.executor.plan_cache.stats["replay_mismatches"] == mism0 + 1
    assert not eng.executor.last_plan_cache_hit


def test_other_replay_errors_raise(tpch_db, monkeypatch):
    """Only ``ReplayMismatch`` sends a replay back to a cold run (unlike the
    reference, which re-runs cold after any error): a launch or build error
    in a replay raises, and the entry stays."""
    eng = _engine(tpch_db)
    eng.execute(QUERIES[6]())

    def broken(entry, flags):
        raise RuntimeError("a kernel launch failed")

    monkeypatch.setattr(eng.executor, "_replay_core", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.execute(QUERIES[6]())
    assert eng.executor.plan_cache.stats["replay_mismatches"] == 0
    assert len(eng.executor.plan_cache) == 1


# ---------------------------------------------------------------------------
# front door: SQL text
# ---------------------------------------------------------------------------

_SQL = ("SELECT l_returnflag, sum(l_quantity) AS sum_qty FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sql_text_cache_skips_parser(use_kernels, engines, monkeypatch):
    eng = engines[use_kernels]
    cold = eng.sql(_SQL).to_host()
    traces0 = eng.compiler.stats["traces"]
    parses = []
    run_sql = port_sql.run_sql
    monkeypatch.setattr(port_sql, "run_sql",
                        lambda *a, **k: parses.append(1) or run_sql(*a, **k))
    # different whitespace and a trailing semicolon: the same entry
    warm = eng.sql("  " + _SQL.replace(" FROM", "\n  FROM") + " ;").to_host()
    assert eng.executor.last_plan_cache_hit
    assert parses == []
    assert eng.compiler.stats["traces"] == traces0
    assert_tables_equal(warm, cold)


# ---------------------------------------------------------------------------
# PlanCache unit behaviour
# ---------------------------------------------------------------------------


def test_plan_cache_lru_eviction():
    cache = PlanCache(max_entries=2)
    for sig in ("a", "b", "c"):
        cache.store(sig, ExecutablePlan([], None))
    assert len(cache) == 2
    assert cache.stats["evictions"] == 1
    assert cache.lookup("a") is None
    assert cache.lookup("c") is not None
    assert cache.stats == dict(cache.stats, hits=1, misses=1, inserts=3)


def test_plan_cache_invalidate_and_clear():
    cache = PlanCache()
    cache.store("x", ExecutablePlan([], None))
    cache.invalidate("x", mismatch=True)
    assert cache.stats["invalidations"] == 1
    assert cache.stats["replay_mismatches"] == 1
    cache.invalidate("x")
    assert cache.stats["invalidations"] == 1
    cache.store("y", ExecutablePlan([], None))
    cache.store("z", ExecutablePlan([], None))
    cache.clear()
    assert len(cache) == 0
    assert cache.stats["invalidations"] == 3


# ---------------------------------------------------------------------------
# join-bearing queries on the warm path (tests/test_join_sync.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", JOIN_QUERIES)
def test_tpch_join_queries_row_exact_on_warm_path(qid, use_kernels, engines,
                                                  tpch_db):
    eng = engines[use_kernels]
    eng.execute(QUERIES[qid]())                    # record
    syncs0 = instrument.scalar_syncs.value
    warm = eng.execute(QUERIES[qid]())             # replay, sync-free
    assert eng.executor.last_plan_cache_hit
    assert instrument.scalar_syncs.value == syncs0
    ref = FallbackEngine(tpch_db).execute(REF_QUERIES[qid]())
    assert_tables_equal(warm.to_host(), ref)


def test_buffer_manager_needs_a_device():
    from repro_torch.buffer.manager import BufferManager
    with pytest.raises(TypeError):
        BufferManager(1 << 20, 1 << 20)
    assert BufferManager(1 << 20, 1 << 20, "cpu").table_epochs == {}
    np.testing.assert_equal(
        SiriusEngine(device="cpu").buffers.device.type, "cpu")


@pytest.mark.parametrize("on_before", [True, False])
def test_collector_stays_off_until_the_last_capture_ends(on_before):
    """A graph capture turns the cyclic collector off for the process; two
    captures that overlap on two threads keep it off until the second
    ends, and then leave it as it was before the first began."""
    import gc
    import threading
    from repro_torch.core import executor
    was = gc.isenabled()
    (gc.enable if on_before else gc.disable)()
    first_in, second_in, first_out = (threading.Event() for _ in range(3))
    seen = {}

    def first():
        with executor._collector_off():
            first_in.set()
            second_in.wait(5)
        first_out.set()

    def second():
        first_in.wait(5)
        with executor._collector_off():
            second_in.set()
            first_out.wait(5)
            seen["after_first"] = gc.isenabled()
        seen["after_second"] = gc.isenabled()

    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert first_out.is_set() and second_in.is_set()
        assert seen == {"after_first": False, "after_second": on_before}
        assert executor._collector["captures"] == 0
    finally:
        (gc.enable if was else gc.disable)()
