"""The port's distributed engine against the JAX reference (``device="cpu"``).

* At 8 logical shards, TPC-H Q1, Q3, Q6, Q12 and Q18 at SF0.005: results,
  ``exchange_summary()`` and fragment names equal the reference engine's
  on 8 forced host devices (``tests/_torch_dist_ref_worker.py``, one
  subprocess for the module).  Integer, date and string columns exact,
  floats within the suite's rtol 1e-6 (``conftest.assert_tables_equal``);
  the summaries exactly.
* Sweeps, row-exact against both packages' ``FallbackEngine``: the 22
  TPC-H plans at SF0.004 and the 15 ClickBench queries at 2,000 rows, on
  2 shards, with ``tests/_dist_worker.py``'s tolerance (floats rtol 2e-5,
  atol 1e-6: partial aggregates re-associate float sums across shards).
* The five fault scenarios of ``tests/_dist_worker.py`` (node failure and
  elastic recovery, straggler speculation, checkpoint resume, shuffle
  overflow retry, prime row counts) in-process on logical shards, with the
  worker's own assertions; every in-process case of
  ``tests/test_distributed.py`` and the distributed case of
  ``tests/test_journal.py``.
* A registry checkpoint written by either package loads in the other.
* The two departures: a shard degrades to the host only on
  ``PlanNotLowerable``, and a late speculative primary never runs.
"""
import threading
import time

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import _torch_dist_ref_worker as ref_worker
from conftest import assert_tables_equal
from repro.core.fallback import FallbackEngine as RefFallbackEngine
from repro.data import clickbench as ref_cb
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.runtime.checkpoint import RegistryCheckpointer as RefCheckpointer
from repro.sql import sql_to_plan as ref_sql_to_plan
from repro_torch.core.distributed import (
    DistributedEngine, ExchangeOverflow, key_to_int64,
)
from repro_torch.core.executor import PlanNotLowerable
from repro_torch.core.fallback import FallbackEngine
from repro_torch.core.plan import AggregateRel, ReadRel, SortRel
from repro_torch.data import clickbench as cb
from repro_torch.data.tpch import generate
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.observability.dist import exchange_report, verify_tree
from repro_torch.observability.journal import JOURNAL
from repro_torch.observability.metrics import METRICS
from repro_torch.relational.aggregate import AggSpec
from repro_torch.relational.expressions import Col
from repro_torch.relational.sort import SortKey
from repro_torch.runtime.checkpoint import RegistryCheckpointer
from repro_torch.runtime.control import (
    FaultInjector, FaultPlan, HeartbeatMonitor, SpeculativeRunner,
)
from repro_torch.sql import sql_to_plan

torch.set_num_threads(1)

REF_QIDS = (1, 3, 6, 12, 18)


def canon(v):
    v = np.asarray(v)
    if v.dtype.kind == "M":
        return v.astype("datetime64[D]").astype("int64")
    if v.dtype.kind in "UO":
        return np.asarray(v, "U")
    return v


def tables_match(got, ref):
    """``tests/_dist_worker.py``'s comparison: row-exact, floats at rtol
    2e-5 / atol 1e-6."""
    if set(got) != set(ref):
        return False, f"columns {sorted(got)} vs {sorted(ref)}"
    for k in got:
        a, b = canon(got[k]), canon(ref[k])
        if len(a) != len(b):
            return False, f"{k}: rows {len(a)} vs {len(b)}"
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(a.astype(float), b.astype(float),
                               rtol=2e-5, atol=1e-6):
                return False, f"{k}: values"
        elif not (a == b).all():
            return False, f"{k}: values"
    return True, ""


def mid_fragment(eng, qid):
    names = eng.program_names(qid)
    return names[-2] if len(names) > 1 else names[0], names


@pytest.fixture(scope="module")
def db():
    return generate(0.005)


# ---------------------------------------------------------------------------
# 8 logical shards against the reference on 8 host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs():
    return ref_worker.run("distributed", {"sf": 0.005, "n": 8,
                                          "qids": REF_QIDS})


@pytest.fixture(scope="module")
def eng8(db):
    return DistributedEngine(db, n_shards=8, device="cpu")


@pytest.mark.parametrize("qid", REF_QIDS)
def test_eight_shards_equal_the_reference(ref_runs, eng8, qid):
    got = eng8.run_query(qid)
    want = ref_runs[qid]
    assert_tables_equal(got, want["rows"])
    summary = [{k: v for k, v in s.items() if k != "wall_s"}
               for s in eng8.exchange_summary()]
    assert summary == want["exchanges"]
    assert eng8.program_names(qid) == want["names"]


def test_distributed_correctness_matches_the_oracle(db, eng8):
    """The worker's ``correctness`` scenario: Q1, Q3, Q6, Q12 on 8 shards
    against the host oracle."""
    fb = FallbackEngine(db)
    for qid in (1, 3, 6, 12):
        ok, why = tables_match(eng8.run_query(qid), fb.execute(QUERIES[qid]()))
        assert ok, f"Q{qid} {why}"


# ---------------------------------------------------------------------------
# sweeps: 22 TPC-H and 15 ClickBench on 2 shards, against both oracles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch2():
    sdb = generate(0.004)
    return (DistributedEngine(sdb, n_shards=2, device="cpu"),
            FallbackEngine(sdb), RefFallbackEngine(sdb))


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_sweep_two_shards_row_exact(tpch2, qid):
    eng, fb, ref_fb = tpch2
    got = eng.run_plan(QUERIES[qid]())
    for oracle in (fb.execute(QUERIES[qid]()),
                   ref_fb.execute(REF_QUERIES[qid]())):
        ok, why = tables_match(got, oracle)
        assert ok, f"Q{qid} {why}"


@pytest.fixture(scope="module")
def cb2():
    n_rows = 2000
    cdb = cb.generate(n_rows)
    return (DistributedEngine(cdb, n_shards=2, device="cpu"),
            FallbackEngine(cdb), RefFallbackEngine(cdb),
            cb.clickbench_catalog(n_rows), ref_cb.clickbench_catalog(n_rows))


@pytest.mark.parametrize("qid", sorted(cb.CLICKBENCH_QUERIES))
def test_clickbench_sweep_two_shards_row_exact(cb2, qid):
    eng, fb, ref_fb, cat, ref_cat = cb2
    sql = cb.CLICKBENCH_QUERIES[qid]
    got = eng.run_plan(sql_to_plan(sql, catalog=cat))
    for oracle in (fb.execute(sql_to_plan(sql, catalog=cat)),
                   ref_fb.execute(ref_sql_to_plan(sql, catalog=ref_cat))):
        ok, why = tables_match(got, oracle)
        assert ok, f"{qid} {why}"


# ---------------------------------------------------------------------------
# the fault scenarios of tests/_dist_worker.py, in-process
# ---------------------------------------------------------------------------


def test_node_failure_triggers_elastic_recovery(db):
    eng = DistributedEngine(db, n_shards=8, device="cpu")
    target, _ = mid_fragment(eng, 3)
    inj = FaultInjector([FaultPlan(fragment=target, node=3, times=1)])
    eng.injector = inj
    got = eng.run_query(3)
    ok, why = tables_match(got, FallbackEngine(db).execute(QUERIES[3]()))
    assert ok, why
    assert eng.recoveries == 1 and eng.n_shards == 7
    assert inj.tripped == [target]
    assert eng.mesh.size == 7 and eng.heartbeat.live_nodes() == list(range(7))


def test_straggler_speculative_reexecution(db):
    eng = DistributedEngine(db, n_shards=8, device="cpu")
    target, _ = mid_fragment(eng, 3)
    inj = FaultInjector([FaultPlan(fragment=target, node=2, times=1,
                                   delay_s=30.0)])
    eng.injector = inj
    eng.run_query(3)  # warm (history for budget)
    got = eng.run_query(3)
    ok, why = tables_match(got, FallbackEngine(db).execute(QUERIES[3]()))
    assert ok, why
    assert target in eng.speculative.speculated


def test_checkpoint_restart_resumes_after_last_fragment(db, tmp_path):
    eng = DistributedEngine(db, n_shards=8, checkpoint_dir=str(tmp_path),
                            device="cpu")
    _, names = mid_fragment(eng, 3)
    ref_out = eng.run_query(3)
    # a new engine resumes from the snapshot taken after the second-to-last
    # fragment: only the final fragment re-executes
    eng2 = DistributedEngine(db, n_shards=8, checkpoint_dir=str(tmp_path),
                             device="cpu")
    got = eng2.run_query(3, resume=True)
    ok, why = tables_match(got, ref_out)
    assert ok, why
    assert eng2.timers.get("resumed_from") == len(names) - 1


def test_shuffle_overflow_retry_end_to_end():
    """Real undersized exchange buckets (slack 0.01) overflow and converge."""
    rng = np.random.default_rng(7)
    n = 20_000
    sdb = {"t": {"k": rng.integers(0, 9973, n),
                 "p": rng.integers(0, 1 << 30, n),
                 "v": rng.normal(size=n)}}
    plan = SortRel(AggregateRel(ReadRel("t"), ["k"],
                                [AggSpec("sum", Col("v"), "s")]),
                   [SortKey("k", True)])
    eng = DistributedEngine(sdb, n_shards=4, shuffle_slack=0.01,
                            partition_keys={"t": "p"}, device="cpu")
    got = eng.run_plan(plan)
    ok, why = tables_match(got, FallbackEngine(sdb).execute(plan))
    assert ok, why
    assert eng.shuffle_slack > 0.01
    # the summary keeps the retried shuffle's last commit only
    frags = [s["fragment"] for s in eng.exchange_summary()]
    assert len(frags) == len(set(frags))


def test_prime_sized_tables_partition_exactly(db):
    primes = {"lineitem": 9973, "orders": 2503, "customer": 251,
              "part": 331, "supplier": 13, "partsupp": 1327}
    pdb = {t: {c: v[:primes.get(t, len(v))] for c, v in cols.items()}
           for t, cols in db.items()}
    pfb = FallbackEngine(pdb)
    eng = DistributedEngine(pdb, n_shards=8, device="cpu")
    for qid in (1, 3, 6, 12, 18):
        ok, why = tables_match(eng.run_query(qid), pfb.execute(QUERIES[qid]()))
        assert ok, f"Q{qid} {why}"


# ---------------------------------------------------------------------------
# in-process cases of tests/test_distributed.py
# ---------------------------------------------------------------------------


def test_shuffle_overflow_retries_with_bigger_buckets():
    """The coordinator doubles bucket slack and retries the fragment in
    place (a stub fragment raises ExchangeOverflow until slack grows)."""
    eng = DistributedEngine(generate(0.002), n_shards=1, shuffle_slack=0.25,
                            device="cpu")
    calls = {"n": 0}

    def fake_program():
        def frag(registry):
            calls["n"] += 1
            if eng.shuffle_slack < 1.0:
                raise ExchangeOverflow
            return {"ok": np.ones(1)}
        return [("fake_frag", frag)]

    eng._program_q6 = fake_program
    out = eng.run_query(6)
    assert out["ok"][0] == 1
    assert eng.shuffle_slack >= 1.0            # 0.25 → 0.5 → 1.0
    assert calls["n"] == 3


def test_key_to_int64_is_value_deterministic():
    a = key_to_int64(np.array(["x", "abc", "x", ""], "U"))
    b = key_to_int64(np.array(["abc", "", "x"], "U"))
    assert a[1] == b[0] and a[0] == b[2] and a[3] == b[1]
    assert a[0] == a[2]
    f = key_to_int64(np.array([0.0, -0.0]))
    assert f[0] == f[1]
    d = key_to_int64(np.array(["1970-01-03"], "datetime64[D]"))
    assert d[0] == 2


def test_exchange_placement_cuts_stable_fragments():
    eng = DistributedEngine(generate(0.002), n_shards=1, device="cpu")
    names = eng.program_names(3)
    assert len(names) >= 2                      # at least one exchange + root
    assert names[-1].endswith("final")
    assert names == eng.program_names(3)        # deterministic re-cut


def test_registry_checkpoint_roundtrips_decoded_columns(tmp_path):
    cp = RegistryCheckpointer(str(tmp_path))
    reg = {"t": {"rows": {
        "s": np.array(["a", "bb", ""], "U"),
        "d": np.array(["1995-03-15"] * 3, "datetime64[D]"),
        "x": np.arange(3.0)}, "partition_key": "s"}}
    cp.save("frag1", reg)
    _, loaded = cp.load_latest(["frag1"])
    assert (loaded["t"]["rows"]["s"] == reg["t"]["rows"]["s"]).all()
    assert (loaded["t"]["rows"]["d"] == reg["t"]["rows"]["d"]).all()


def test_registry_checkpoint_roundtrip(tmp_path):
    cp = RegistryCheckpointer(str(tmp_path))
    reg = {"t": {"rows": {"a": np.arange(5), "b": np.ones(5)},
                 "partition_key": "a"}}
    cp.save("frag1", reg)
    frag, loaded = cp.load_latest(["frag1", "frag2"])
    assert frag == "frag1"
    assert (loaded["t"]["rows"]["a"] == np.arange(5)).all()
    assert loaded["t"]["partition_key"] == "a"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_registry_checkpoint_crosses_packages(tmp_path, writer):
    """A snapshot written by one package loads in the other, bit for bit."""
    reg = {"__dist_frag0": {"rows": {
        "s": np.array(["a", "bb", ""], "U"),
        "d": np.array(["1995-03-15", "1970-01-01", "2001-12-31"],
                      "datetime64[D]"),
        "x": np.array([1.5, -0.0, np.inf]),
        "k": np.array([2**40, -1, 0], np.int64)}, "partition_key": "k"}}
    w, r = ((RegistryCheckpointer, RefCheckpointer) if writer == "port"
            else (RefCheckpointer, RegistryCheckpointer))
    w(str(tmp_path)).save("f0_shuffle", reg)
    frag, loaded = r(str(tmp_path)).load_latest(["f0_shuffle", "f1_final"])
    assert frag == "f0_shuffle"
    assert loaded["__dist_frag0"]["partition_key"] == "k"
    for c, v in reg["__dist_frag0"]["rows"].items():
        got = loaded["__dist_frag0"]["rows"][c]
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), c


def test_heartbeat_failure_detector():
    hb = HeartbeatMonitor(4, timeout_s=60)
    assert hb.live_nodes() == [0, 1, 2, 3]
    hb.kill(2)
    assert hb.live_nodes() == [0, 1, 3]
    hb.revive_all()
    assert hb.live_nodes() == [0, 1, 2, 3]


def test_speculative_runner_prefers_backup_for_stragglers():
    sr = SpeculativeRunner(min_budget_s=0.1)
    out, who = sr.run("frag", lambda: 42, injected_delay_s=2.0)
    assert out == 42
    assert who == "backup"
    assert sr.speculated == ["frag"]
    out, who = sr.run("frag", lambda: 43)
    assert (out, who) == (43, "primary")


def test_predicate_transfer_q3_matches_oracle():
    """Predicate transfer must not change results: Q3 (at 1 and 4 shards
    its placement has no shuffle join to pre-filter) and Q10 (at 4 shards
    its lineitem shuffle is pruned by the date-filtered orders keys)."""
    db = generate(0.004)
    fb = FallbackEngine(db)
    pruned = METRICS.counter("distributed.predicate_transfer_rows_pruned")
    for n, qid, prunes in ((1, 3, False), (4, 3, False), (4, 10, True)):
        eng = DistributedEngine(db, n_shards=n, predicate_transfer=True,
                                device="cpu")
        before = pruned.value
        ok, why = tables_match(eng.run_query(qid),
                               fb.execute(QUERIES[qid]()))
        assert ok, (n, qid, why)
        assert (pruned.value > before) == prunes, (n, qid)


def test_distributed_journal_tree_and_compile_attribution():
    """tests/test_journal.py's distributed case: one verified tree per
    query, fragment/shard/exchange spans present, timers self-consistent."""
    eng = DistributedEngine(generate(0.002), n_shards=1, device="cpu")
    # suppress speculative backups, as the reference's test does
    eng.speculative.min_budget_s = 1e9
    eng.run_plan(QUERIES[3]())                # cold
    eng.run_plan(QUERIES[3]())                # warm — the run under test
    qid = eng.last_query_id
    assert qid is not None
    evs = JOURNAL.events(qid)
    cats = {e["cat"] for e in evs}
    assert {"query", "fragment", "attempt", "shard", "engine"} <= cats
    assert verify_tree(evs, qid) == []
    root = next(e for e in evs if e["parent_id"] is None)
    assert root["name"] == "distributed.query"
    assert root["attrs"]["shards"] == 1
    t = eng.timers
    assert t["compute"] + t["exchange"] + t["compile"] + t["other"] \
        <= t["total"] + 1e-6
    ex = exchange_report(evs, qid)
    summary = eng.exchange_summary()
    if summary:                               # Q3 always exchanges
        assert ex, "exchange spans missing from the journal"
        assert all(r["skew_ratio"] >= 1.0 for r in summary)
        assert all(isinstance(b, int)
                   for r in summary for b in r["bytes_per_shard"])


def test_multi_shard_journal_has_collective_spans(eng8):
    eng8.run_query(3)
    evs = JOURNAL.events(eng8.last_query_id)
    assert verify_tree(evs, eng8.last_query_id) == []
    coll = [e for e in evs if e["cat"] == "collective"]
    assert coll and all(e["attrs"]["shards"] == 8 for e in coll)
    assert {e["name"] for e in evs if e["cat"] == "shard"} >= {
        f"{n}@shard{s}" for n in eng8.program_names(3)[:1] for s in range(8)}


# ---------------------------------------------------------------------------
# devices and the two departures from the reference
# ---------------------------------------------------------------------------


def test_no_device_means_the_card_or_an_error(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine(db, n_shards=2)
    eng = DistributedEngine(db, n_shards=2, device="cpu")
    assert eng.device.type == "cpu" and eng.mesh.size == 2
    assert all(t["master"].device.type == "cpu" for t in eng.tables.values())


def test_explicit_device_list_bounds_the_shards(db):
    eng = DistributedEngine(db, device=["cpu", "cpu", "cpu"])
    assert eng.n_shards == 3
    with pytest.raises(ValueError, match="exceeds device count"):
        DistributedEngine(db, n_shards=4, device=["cpu", "cpu"])


def test_shard_errors_propagate_and_only_unlowerable_plans_fall_back(
        db, monkeypatch):
    """The reference degrades a shard to the host on any exception; the
    port only on ``PlanNotLowerable`` — a kernel or CUDA error raises and
    counts no shard fallback."""
    from repro_torch.core.executor import SiriusEngine
    eng = DistributedEngine(db, n_shards=2, device="cpu")
    fallbacks = METRICS.counter("distributed.shard_fallbacks")
    before = fallbacks.value

    def broken(self, plan, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(SiriusEngine, "execute", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run_query(6)
    assert fallbacks.value == before

    def unlowerable(self, plan, **kw):
        raise PlanNotLowerable("cannot lower WindowRel")
    monkeypatch.setattr(SiriusEngine, "execute", unlowerable)
    got = eng.run_query(6)
    ok, why = tables_match(got, FallbackEngine(db).execute(QUERIES[6]()))
    assert ok, why
    assert fallbacks.value > before


def test_late_speculative_primary_never_runs_the_body():
    """The reference's primary runs the fragment after its injected delay
    even when the backup's result was taken; the port's returns."""
    sr = SpeculativeRunner(min_budget_s=0.05)
    calls, lock = [], threading.Lock()

    def body():
        with lock:
            calls.append(threading.current_thread().name)
        return 7

    out, who = sr.run("frag", body, injected_delay_s=0.3)
    assert (out, who) == (7, "backup")
    time.sleep(0.6)                 # well past the primary's wake-up
    assert len(calls) == 1          # the backup only


def test_replicas_run_their_bodies_one_at_a_time():
    """A primary slow in its body and the backup started beside it never
    overlap: the backup waits on the runner's lock, then finds the result
    taken."""
    sr = SpeculativeRunner(min_budget_s=0.05)
    active, peak, calls = [0], [0], []
    lock = threading.Lock()

    def body():
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            calls.append(1)
        time.sleep(0.3)
        with lock:
            active[0] -= 1
        return 1

    assert sr.run("slow", body) == (1, "primary")
    assert sr.speculated == ["slow"]
    time.sleep(0.1)
    assert peak[0] == 1 and len(calls) == 1


@pytest.mark.parametrize("values", [
    np.array(["MAIL", "SHIP"], "U7"), np.array(["", ""], "U3"),
    np.array([], "U5"), np.array(["a", "bbb"], object)])
def test_string_dictionaries_take_the_reference_width(values):
    """The reference's dictionary is as wide as its longest value, whatever
    the input array's width; a wider one changed decoded dtypes and the
    exchange summary's byte counts (Q12's ``l_shipmode``)."""
    from repro.relational.table import Column as RefColumn
    from repro_torch.relational.table import Column
    got = Column.from_numpy(values).dictionary
    want = RefColumn.from_numpy(values).dictionary
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()


def test_encode_host_table_equals_the_reference():
    from repro.core.distributed import encode_host_table as ref_encode
    from repro_torch.core.distributed import encode_host_table
    cols = {"s": np.array(["b", "a", "b", ""], "U"),
            "d": np.array(["1995-03-15", "1970-01-02", "1969-12-31",
                           "2001-01-01"], "datetime64[D]"),
            "x": np.array([1.5, 2.0, -0.0, 3.0])}
    (enc, dicts), (ref_enc, ref_dicts) = encode_host_table(cols), ref_encode(cols)
    assert list(enc) == list(ref_enc) and list(dicts) == list(ref_dicts)
    for c in enc:
        assert enc[c].dtype == ref_enc[c].dtype
        np.testing.assert_array_equal(enc[c], ref_enc[c])
    np.testing.assert_array_equal(dicts["s"], ref_dicts["s"])
