"""The query journal on the port: ``tests/test_journal.py``'s cases on
``repro_torch`` (``device="cpu"``), and the engine's spans against the
reference's.

* ``TraceContext`` round trip and cross-thread propagation; spans outside
  a query dropped; the bounded ring; the JSONL sink; the disabled journal;
  the environment variables the reference reads.
* Attributes are host-plain: numpy scalars by value, arrays by repr, and a
  tensor by its shape, dtype and device, never read.
* Chrome export lanes; skew; per-engine metrics registries mirrored into
  the process-wide one.
* The engine: concurrent mixed queries give one clean tree each; the
  front doors (``sql``, ``accelerate``, ``execute``) root query trees whose
  spans (``engine.execute``, ``plan_cache.record`` / ``replay`` /
  ``poison``) pass ``verify_tree`` and name the reference's tree; warm
  replays keep one barrier and no host copy with the journal on, and its
  cost stays within 5% (+2 ms) of off, read on interleaved medians.
* ``scripts/profile_diff.py``'s gates fed from the port's runs.

The reference's distributed-journal case waits for the port's
distributed tier (ROADMAP queue 1, item 8).
"""
import importlib.util
import json
import os
import statistics
import threading
import time

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.executor import SiriusEngine as RefEngine
from repro.data.tpch import load_into_engine as ref_load
from repro.observability.journal import JOURNAL as REF_JOURNAL
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.data import clickbench as cb
from repro_torch.data.tpch import generate, load_into_engine
from repro_torch.data.tpch_queries import QUERIES, SQL_QUERIES
from repro_torch.observability.dist import (
    exchange_report, query_wall, render_timeline, render_top_operators,
    skew_ratio, span_tree, top_operators, verify_tree)
from repro_torch.observability.journal import (
    JOURNAL, JOURNAL_SCHEMA_VERSION, QueryJournal, TraceContext, load_jsonl,
    to_chrome)
from repro_torch.observability.metrics import (
    METRICS, MetricsRegistry, aggregate_labeled)
from repro_torch.sql import sql_to_plan, sql_to_wire

from conftest import USE_KERNELS

torch.set_num_threads(1)

SF = 0.002
CB_ROWS = 2_000


@pytest.fixture(scope="module")
def small_db():
    return generate(SF)


def _engine(db, **kw):
    eng = SiriusEngine(device="cpu", **kw)
    load_into_engine(eng, db)
    return eng


def _tree(events, query_id):
    """(name, category, depth) of each span and instant, depth first."""
    out = []

    def walk(node, depth):
        out.append((node.name, node.event["cat"], depth))
        for c in node.children:
            walk(c, depth + 1)
    for root in span_tree(events, query_id):
        walk(root, 0)
    return out


# ---------------------------------------------------------------------------
# context primitives
# ---------------------------------------------------------------------------


def test_trace_context_roundtrip():
    ctx = TraceContext(query_id="q1-7", span_id=42)
    assert TraceContext.from_dict(ctx.to_dict()) == ctx
    assert TraceContext.from_dict({"query_id": "q"}).span_id is None


def test_span_outside_query_context_is_dropped():
    j = QueryJournal(capacity=64)
    with j.span("orphan", "engine"):
        pass
    j.event("orphan_instant", "engine")
    assert j.events() == []


def test_query_span_roots_tree_and_nests():
    j = QueryJournal(capacity=64)
    with j.query_span("sql", text="select 1") as root:
        qid = root.query_id
        with j.span("child", "engine", depth=1) as c:
            assert c.query_id == qid
            j.event("mark", "cache")
    evs = j.events(qid)
    assert {e["name"] for e in evs} == {"sql", "child", "mark"}
    by_name = {e["name"]: e for e in evs}
    assert by_name["child"]["parent_id"] == by_name["sql"]["span_id"]
    assert by_name["mark"]["parent_id"] == by_name["child"]["span_id"]
    assert by_name["sql"]["parent_id"] is None
    roots = span_tree(evs, qid)
    assert len(roots) == 1 and roots[0].name == "sql"


def test_activate_propagates_context_across_threads():
    j = QueryJournal(capacity=64)
    with j.query_span("engine.query") as root:
        ctx = j.current_context()

        def worker():
            with j.activate(ctx):
                with j.span("fragment@thread", "fragment"):
                    pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    evs = j.events(root.query_id)
    frag = next(e for e in evs if e["name"] == "fragment@thread")
    assert frag["query_id"] == root.query_id
    assert frag["parent_id"] == root.span_id
    assert verify_tree(evs, root.query_id) == []


def test_ring_capacity_bounds_and_counts_drops():
    j = QueryJournal(capacity=8)
    with j.query_span("q"):
        for i in range(20):
            j.event(f"e{i}")
    assert len(j.events()) == 8
    assert j.dropped > 0
    assert j.summary()["dropped"] == j.dropped
    j.clear()
    assert j.events() == [] and j.dropped == 0


def test_jsonl_sink_roundtrip(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = QueryJournal(capacity=64)
    j.attach_sink(path)
    with j.query_span("sql") as root:
        j.event("mark", "cache", n=3)
    j.detach_sink()
    lines = load_jsonl(path)
    assert len(lines) == 2
    assert all(line["schema_version"] == JOURNAL_SCHEMA_VERSION
               for line in lines)
    assert {line["name"] for line in lines} == {"sql", "mark"}
    assert all(line["query_id"] == root.query_id for line in lines)


def test_disabled_journal_is_noop():
    j = QueryJournal(capacity=64, enabled=False)
    with j.query_span("sql") as sp:
        assert sp.query_id is None
        j.event("mark")
    assert j.events() == []


def test_query_ids_carry_the_process_id(monkeypatch):
    """The reference's format, ``q<pid>-<n>``; the pid is read once and
    again in a forked child (``os.register_at_fork``), never per query."""
    from repro_torch.observability import journal as journal_mod
    j = QueryJournal(capacity=8)
    assert [j.new_query_id() for _ in range(2)] == \
        [f"q{os.getpid()}-1", f"q{os.getpid()}-2"]
    calls = []
    monkeypatch.setattr(os, "getpid", lambda: calls.append(1) or 4242)
    try:
        assert j.new_query_id("x") == f"x{journal_mod._PID}-3"
        assert calls == []
        journal_mod._refresh_pid()           # what a forked child runs
        assert j.new_query_id() == "q4242-4"
    finally:
        monkeypatch.undo()
        journal_mod._refresh_pid()
    assert journal_mod._PID == os.getpid()


def test_environment_configures_the_journal(tmp_path, monkeypatch):
    """The reference's variables, read the same way."""
    sink = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("REPRO_JOURNAL_CAPACITY", "16")
    monkeypatch.setenv("REPRO_JOURNAL_SINK", sink)
    j = QueryJournal()
    assert j.capacity == 16 and j.enabled
    with j.query_span("sql"):
        pass
    j.detach_sink()
    assert [e["name"] for e in load_jsonl(sink)] == ["sql"]
    monkeypatch.setenv("REPRO_JOURNAL_DISABLE", "1")
    monkeypatch.delenv("REPRO_JOURNAL_SINK")
    assert not QueryJournal().enabled


def test_attrs_cleaned_to_host_plain():
    j = QueryJournal(capacity=64)
    with j.query_span("q", np_scalar=np.int64(7), arr=np.arange(3)) as sp:
        qid = sp.query_id
    ev = j.events(qid)[0]
    assert ev["attrs"]["np_scalar"] == 7
    assert isinstance(ev["attrs"]["arr"], str)
    json.dumps(ev)


def test_tensor_attrs_are_described_never_read():
    """A tensor attribute (even 0-d, which the reference's ``item()`` rule
    would read) becomes its shape, dtype and device: no copy to the host,
    no read of its data."""
    j = QueryJournal(capacity=64)
    big, scalar = torch.arange(1000, dtype=torch.int64), torch.tensor(3.5)
    with instrument.track_transfers("cpu") as counter:
        with j.query_span("q", cols=big, k=scalar) as sp:
            j.event("mark", n=scalar)
            qid = sp.query_id
    assert counter.total == 0
    attrs = {e["name"]: e["attrs"] for e in j.events(qid)}
    assert attrs["q"]["cols"] == \
        "Tensor(shape=(1000,), dtype=torch.int64, device=cpu)"
    assert attrs["q"]["k"] == "Tensor(shape=(), dtype=torch.float32, device=cpu)"
    assert attrs["mark"]["n"] == attrs["q"]["k"]
    json.dumps(j.events(qid))


# ---------------------------------------------------------------------------
# skew + chrome export
# ---------------------------------------------------------------------------


def test_skew_ratio_math():
    assert skew_ratio([]) == 1.0
    assert skew_ratio([0, 0]) == 1.0
    assert skew_ratio([100, 100, 100, 100]) == 1.0
    assert skew_ratio([400, 0, 0, 0]) == 4.0
    assert abs(skew_ratio([300, 100]) - 1.5) < 1e-12


def test_chrome_export_shape():
    j = QueryJournal(capacity=64)
    with j.query_span("engine.query") as root:
        with j.span("f0@shard1", "shard", shard=1):
            with j.span("engine.execute", "engine"):
                pass
        j.event("speculative_backup", "recovery")
    d = to_chrome(j.events(root.query_id), epoch=j.epoch)
    evs = d["traceEvents"]
    assert d["otherData"]["schema_version"] == JOURNAL_SCHEMA_VERSION
    assert {e["ph"] for e in evs} == {"X", "i", "M"}
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert lanes == {"coordinator", "shard 1"}
    engine_ev = next(e for e in evs if e["name"] == "engine.execute")
    assert engine_ev["pid"] == 2
    assert all(e["dur"] > 0 for e in evs if e["ph"] == "X")


# ---------------------------------------------------------------------------
# per-engine metrics scoping
# ---------------------------------------------------------------------------


def test_metrics_registry_scoping_mirrors_and_aggregates():
    parent = MetricsRegistry()
    shard0 = MetricsRegistry(parent=parent, label="pool.shard0")
    shard1 = MetricsRegistry(parent=parent, label="pool.shard1")
    shard0.counter("plan_cache.hits").inc(3)
    shard1.counter("plan_cache.hits").inc(5)
    shard0.histogram("query_seconds").observe(0.5)
    shard1.histogram("query_seconds").observe(1.5)
    assert shard0.snapshot()["plan_cache.hits"] == 3
    assert shard1.snapshot()["plan_cache.hits"] == 5
    snap = parent.snapshot()
    assert snap["pool.shard0.plan_cache.hits"] == 3
    assert snap["pool.shard1.plan_cache.hits"] == 5
    agg = aggregate_labeled(snap, "pool.shard")
    assert agg["plan_cache.hits"] == 8
    assert agg["query_seconds.count"] == 2
    assert agg["query_seconds.max"] == pytest.approx(1.5)


def test_metrics_registry_label_requires_parent():
    with pytest.raises(ValueError):
        MetricsRegistry(label="pool.shard0")
    with pytest.raises(ValueError):
        MetricsRegistry(parent=MetricsRegistry())


def test_engine_metrics_registry_mirrors_into_the_process_one(small_db):
    reg = MetricsRegistry(parent=METRICS, label="journal_test.engine0")
    eng = _engine(small_db, metrics=reg)
    assert eng.metrics is reg and eng.executor.plan_cache.metrics is reg
    for _ in range(3):
        eng.execute(QUERIES[6]())
    assert reg.snapshot()["plan_cache.hits"] == 2
    assert reg.snapshot()["executor.query_seconds.count"] == 3
    snap = METRICS.snapshot()
    assert snap["journal_test.engine0.plan_cache.hits"] == 2
    assert snap["journal_test.engine0.plan_cache.inserts"] == 1


# ---------------------------------------------------------------------------
# engine integration: trees, concurrency, overhead
# ---------------------------------------------------------------------------


def test_front_doors_root_query_trees(small_db):
    """``sql`` roots ``engine.execute`` → ``plan_cache.record`` cold and
    ``engine.execute`` → ``plan_cache.replay`` warm; ``accelerate`` roots
    ``wire``; an analyzed run records nothing in the cache; every tree
    passes ``verify_tree`` and the root's wall bounds its children."""
    eng = _engine(small_db, use_kernels=USE_KERNELS)
    text = SQL_QUERIES[6]
    eng.sql(text)
    cold = eng.last_query_id
    eng.sql(text)
    warm = eng.last_query_id
    eng.accelerate(sql_to_wire(text))
    wire = eng.last_query_id
    eng.execute(QUERIES[3](), analyze=True)
    analyzed = eng.last_query_id
    assert len({cold, warm, wire, analyzed}) == 4
    evs = JOURNAL.events()
    assert _tree(evs, cold) == [("sql", "query", 0),
                                ("engine.execute", "engine", 1),
                                ("plan_cache.record", "cache", 2)]
    assert _tree(evs, warm) == [("sql", "query", 0),
                                ("engine.execute", "engine", 1),
                                ("plan_cache.replay", "cache", 2)]
    assert _tree(evs, wire)[0] == ("wire", "query", 0)
    assert ("engine.execute", "engine", 1) in _tree(evs, wire)
    assert _tree(evs, analyzed) == [("engine.execute", "query", 0)]
    for qid in (cold, warm, wire, analyzed):
        assert verify_tree(evs, qid) == []
        wall, root = query_wall(evs, qid)
        assert wall > 0 and root["parent_id"] is None
    replay = next(e for e in JOURNAL.events(warm)
                  if e["name"] == "plan_cache.replay")
    assert replay["attrs"]["mode"] in ("closure", "graph")
    root = next(e for e in JOURNAL.events(warm) if e["name"] == "sql")
    assert root["attrs"]["text"] == " ".join(text.split())[:200]
    execute = next(e for e in JOURNAL.events(warm)
                   if e["name"] == "engine.execute")
    assert execute["attrs"]["plan_cache_hit"] is True
    assert execute["attrs"]["compile_seconds"] == 0.0
    assert "host_transfer_bytes" in execute["attrs"]
    assert "plan_cache.replay" in render_timeline(evs, warm)
    assert "sql" in render_top_operators(top_operators(evs, warm))
    assert exchange_report(evs, warm) == []


def test_trees_name_the_references(small_db, tpch_db):
    """The same SQL, cold then warm, on both packages: the same span names,
    categories and nesting."""
    text = SQL_QUERIES[6]
    ref = RefEngine(use_kernels=USE_KERNELS)
    ref_load(ref, tpch_db)
    port = _engine(tpch_db, use_kernels=USE_KERNELS)
    for _ in range(2):
        ref.sql(text)
        port.sql(text)
        assert _tree(JOURNAL.events(), port.last_query_id) == \
            _tree(REF_JOURNAL.events(), ref.last_query_id)


def test_replay_mismatch_is_a_poison_event(small_db):
    eng = _engine(small_db)
    eng.execute(QUERIES[3]())
    entry = eng.executor.plan_cache._entries[eng.executor.last_plan_signature]
    rp = next(rp for rp in entry.pipelines if rp.must_run and rp.values)
    rp.values[0] = rp.values[0] + 1
    eng.execute(QUERIES[3]())
    assert not eng.executor.last_plan_cache_hit
    tree = _tree(JOURNAL.events(), eng.last_query_id)
    assert [n for n, _, _ in tree] == ["engine.execute", "plan_cache.replay",
                                       "plan_cache.poison",
                                       "plan_cache.record"]
    assert verify_tree(JOURNAL.events(), eng.last_query_id) == []


def test_chrome_trace_of_an_engine_query(small_db):
    eng = _engine(small_db)
    eng.sql(SQL_QUERIES[3])
    d = to_chrome(JOURNAL.events(eng.last_query_id), epoch=JOURNAL.epoch)
    spans = [e for e in d["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} >= {"sql", "engine.execute",
                                          "plan_cache.record"}
    assert all(e["dur"] > 0 and e["pid"] == 0 for e in spans)
    lanes = [e["args"]["name"] for e in d["traceEvents"] if e["ph"] == "M"]
    assert lanes == ["coordinator"]
    json.dumps(d)


def test_concurrent_queries_journal_isolated(small_db):
    """N threads × mixed TPC-H/ClickBench on per-thread engines: every
    query's events form one clean tree under its own query ID."""
    cdb = cb.generate(CB_ROWS)
    cat = cb.clickbench_catalog(CB_ROWS)
    n_threads = 4
    qids_per_thread = [[] for _ in range(n_threads)]
    errors = []

    def worker(i):
        try:
            eng = SiriusEngine(device="cpu", use_kernels=USE_KERNELS)
            if i % 2 == 0:
                load_into_engine(eng, small_db)
                for qid in (1, 6):
                    eng.execute(QUERIES[qid]())
                    qids_per_thread[i].append(eng.last_query_id)
            else:
                cb.load_into_engine(eng, cdb)
                for q in ("q1", "q12"):
                    eng.execute(sql_to_plan(cb.CLICKBENCH_QUERIES[q], cat))
                    qids_per_thread[i].append(eng.last_query_id)
        except Exception as e:           # surface, don't deadlock the join
            errors.append(f"thread {i}: {e!r}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors

    all_qids = [q for qs in qids_per_thread for q in qs]
    assert all(q is not None for q in all_qids)
    assert len(set(all_qids)) == len(all_qids), "query IDs must be unique"
    for qid in all_qids:
        evs = JOURNAL.events(qid)
        assert evs, f"no events for {qid}"
        assert all(e["query_id"] == qid for e in evs)
        span_ids = [e["span_id"] for e in evs]
        assert len(set(span_ids)) == len(span_ids)
        for e in evs:
            pid = e.get("parent_id")
            if pid is not None and any(o["span_id"] == pid for o in evs):
                parent = next(o for o in evs if o["span_id"] == pid)
                assert parent["query_id"] == qid
        assert len(span_tree(evs, qid)) >= 1
        assert verify_tree(evs, qid) == []


def test_journal_overhead_and_sync_contract(small_db):
    """Always-on means cheap: warm replays with the journal on keep one
    barrier, no scalar sync, no host copy inside a pipeline and no
    buffer-ledger transfer, and their median time stays within 5% (+2 ms)
    of off.  On and off alternate run by run (which goes first alternates
    too), so load on the machine falls on both medians alike."""
    eng = _engine(small_db, use_kernels=USE_KERNELS)
    plan = QUERIES[6]
    eng.execute(plan())
    eng.execute(plan())                       # warm the plan cache
    repeats = 15
    times = {True: [], False: []}
    per_run = {True: set(), False: set()}
    try:
        for i in range(repeats):
            for enabled in ((True, False) if i % 2 == 0 else (False, True)):
                (JOURNAL.enable if enabled else JOURNAL.disable)()
                syncs0 = instrument.sync_barriers.value
                scalars0 = instrument.scalar_syncs.value
                xfer0 = eng.buffers.host_transfer_bytes
                with instrument.track_transfers("cpu") as counter:
                    t0 = time.perf_counter()
                    eng.execute(plan())
                    dt = time.perf_counter() - t0
                times[enabled].append(dt)
                per_run[enabled].add((
                    instrument.sync_barriers.value - syncs0,
                    instrument.scalar_syncs.value - scalars0,
                    eng.buffers.host_transfer_bytes - xfer0,
                    counter.in_pipeline, eng.executor.last_plan_cache_hit))
    finally:
        JOURNAL.enable()
    assert per_run[True] == per_run[False] == {(1, 0, 0, 0, True)}, per_run
    t_on = statistics.median(times[True])
    t_off = statistics.median(times[False])
    assert t_on <= t_off * 1.05 + 0.002, \
        f"journal overhead: {t_on*1e3:.3f} ms on vs {t_off*1e3:.3f} ms off"


# ---------------------------------------------------------------------------
# profile_diff gates, fed from the port's runs
# ---------------------------------------------------------------------------


def _load_profile_diff():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_diff.py")
    spec = importlib.util.spec_from_file_location("profile_diff", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_diff_kernel_hits_gate(small_db):
    """The port's per-query kernel hits (its profiles' ``kernel.*_hits``
    deltas on the kernel engine) against a synthetic collapse of Q3."""
    pd = _load_profile_diff()
    eng = _engine(small_db, use_kernels=True)
    per_query = {}
    for qid in (3, 6):
        eng.execute(QUERIES[qid](), analyze=True)
        m = eng.last_profile.metrics
        per_query[f"q{qid}"] = {k[len("kernel."):-len("_hits")]: int(v)
                                for k, v in m.items()
                                if k.startswith("kernel.")}
        per_query[f"q{qid}"]["fallback"] = 0
    assert per_query["q3"]["probe"] > 0 and per_query["q6"]["filter"] > 0
    old = {"kernel_hits": {"per_query": per_query}}
    new = json.loads(json.dumps(old))
    new["kernel_hits"]["per_query"]["q3"] = {
        k: (1 if k == "fallback" else 0) for k in per_query["q3"]}
    regressions, report = pd._diff_kernel_hits(old, new)
    assert regressions == ["q3"]
    assert any("q3" in line for line in report)
    assert pd._diff_kernel_hits(old, old)[0] == []
    assert pd._diff_kernel_hits(new, new)[0] == []


def test_profile_diff_dispatch_budget_gate(small_db):
    """The port's warm dispatch (barriers and transfer bytes a warm run)
    passes the budgets; a synthetic break of each fails them."""
    pd = _load_profile_diff()
    eng = _engine(small_db, use_kernels=USE_KERNELS)
    queries = {}
    for qid in (1, 6):
        eng.execute(QUERIES[qid]())
        syncs0 = instrument.sync_barriers.value
        xfer0 = eng.buffers.host_transfer_bytes
        eng.execute(QUERIES[qid]())
        queries[f"q{qid}"] = {"dispatch": {
            "syncs_per_query": float(instrument.sync_barriers.value - syncs0),
            "transfer_bytes_per_query": eng.buffers.host_transfer_bytes
            - xfer0}}
    regressions, _ = pd._check_dispatch_budgets({"queries": queries})
    assert regressions == []
    dirty = json.loads(json.dumps(queries))
    dirty["q1"]["dispatch"]["syncs_per_query"] = 3.0
    dirty["q6"]["dispatch"]["transfer_bytes_per_query"] = 4096
    regressions, report = pd._check_dispatch_budgets({"queries": dirty})
    assert set(regressions) == {"q1", "q6"}
    assert len(report) == 2


def test_profile_diff_skew_table_rendering():
    """Exchange spans in the port's journal → ``exchange_report`` rows →
    the CLI's skew table."""
    pd = _load_profile_diff()
    j = QueryJournal(capacity=64)
    with j.query_span("engine.query") as root:
        with j.span("f1_shuffle", "exchange", fragment="f1_shuffle",
                    kind="shuffle", bytes_per_shard=[300, 100],
                    skew_ratio=skew_ratio([300, 100])):
            pass
    rows = exchange_report(j.events(), root.query_id)
    assert len(rows) == 1 and rows[0]["skew_ratio"] == 1.5
    lines = pd._render_skew_table({"queries": {"q3": {"exchanges": rows}}})
    assert lines and "f1_shuffle" in "\n".join(lines)
    assert pd._render_skew_table({"queries": {"q3": {}}}) == []
