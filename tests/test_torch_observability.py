"""EXPLAIN ANALYZE and telemetry on the port: ``tests/test_observability.py``'s
cases on ``repro_torch`` engines (``device="cpu"``), and the port's profiles
against the reference's.

* Span tracer, metrics registry and ``track_transfers``: nesting, thread
  safety, no torn counts.
* ``QueryProfile``: the schema's key sets on Q1/Q6/Q13, monotonic timings,
  the last sink's rows equal to the result's, the metric families; JSON
  round trip and ``pretty``; fused regions carry ``est_flops`` /
  ``est_bytes``; ``analyze=False`` keeps one barrier a query.
* Row-exactness: ``analyze=True`` returns the plain run's rows on all 22
  TPC-H and 15 ClickBench queries.
* Front doors: ``EXPLAIN ANALYZE`` through ``sql``, ``sql(analyze=True)``,
  ``run_sql``'s refusal on host data, ``accelerate(analyze=True)`` on an
  all-device wire and on a hybrid plan.
* The plan cache: an analyzed run neither records nor drops an entry, and
  the next plain run is still a replay.
* Against the reference: its ``validate_profile`` accepts the port's
  profile of each of the 22 TPC-H queries at SF0.01; on Q1, Q3, Q6, Q13,
  Q18, Q21, Q22 (a scalar subquery, recorded into the enclosing profile)
  and ClickBench q1 and q8, with and without kernels, the pipelines and
  the operators' names, categories and rows equal its analyzed profile of
  the same plan, and so do the ``kernel.*_hits`` deltas, but for the
  group-bys with a count distinct, which only the port's kernel backend
  takes (Q21's two, q8's); its
  ``scripts/profile_diff.py`` reads the port's profile JSON and exits
  nonzero on a synthetic slowdown.
"""
import copy
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from repro.core.executor import SiriusEngine as RefEngine
from repro.data import clickbench as ref_cb
from repro.data.tpch import load_into_engine as ref_load
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.observability import validate_profile as ref_validate_profile
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.fallback import FallbackEngine
from repro_torch.core.plan import AggregateRel, SetRel, ReadRel
from repro_torch.data import clickbench as cb
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.observability import (
    MetricsRegistry, QueryProfile, SpanTracer, diff_profiles, validate_profile,
)
from repro_torch.observability.profile import _OP_KEYS, _PIPELINE_KEYS, _TOP_KEYS
from repro_torch.relational.aggregate import AggSpec
from repro_torch.relational.expressions import Col, Lit
from repro_torch.sql import SqlError, run_sql, sql_to_wire

from conftest import USE_KERNELS, assert_tables_equal

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CB_ROWS = 10_000
QIDS = sorted(QUERIES)
# the cross-package cases: Q22 adds a scalar subquery, whose pipelines the
# enclosing profile records
CROSS_QIDS = (1, 3, 6, 13, 18, 21, 22)
CROSS_CB = ("q1", "q8")
# group-bys with a count distinct: the port's kernel backend takes them
DISTINCT_GROUPBYS = {21: 2, "q8": 1}

Q6_SQL = ("select sum(l_extendedprice * l_discount) as revenue from lineitem "
          "where l_shipdate >= date '1994-01-01' "
          "and l_shipdate < date '1995-01-01' "
          "and l_discount between 0.05 and 0.07 and l_quantity < 24")


def _engine(db, **kw):
    eng = SiriusEngine(device="cpu", **kw)
    load_into_engine(eng, db)
    return eng


@pytest.fixture(scope="module")
def engine(tpch_db):
    return _engine(tpch_db, use_kernels=USE_KERNELS)


@pytest.fixture(scope="module")
def cb_db():
    return ref_cb.generate(CB_ROWS)


@pytest.fixture(scope="module")
def cb_catalog():
    return cb.clickbench_catalog(CB_ROWS)


@pytest.fixture(scope="module")
def cb_engines(cb_db):
    out = {}
    for uk in (False, True):
        eng = SiriusEngine(device="cpu", use_kernels=uk)
        cb.load_into_engine(eng, cb_db)
        out[uk] = eng
    return out


@pytest.fixture(scope="module")
def analyzed(engine):
    """Per TPC-H query: (plain result, analyzed result, profile dict)."""
    out = {}
    for qid in QIDS:
        plain = engine.execute(QUERIES[qid]()).to_host()
        res = engine.execute(QUERIES[qid](), analyze=True,
                             query_text=f"tpch q{qid}").to_host()
        out[qid] = (plain, res, engine.last_profile.to_dict())
    return out


def _shape(d):
    """What the port's profile must share with the reference's: pipelines
    (pid, source, deps) and each operator's name, category and rows."""
    return [(p["pid"], p["source"], p["deps"],
             [(o["name"], o["category"], o["rows_in"], o["rows_out"])
              for o in p["operators"]]) for p in d["pipelines"]]


def _kernel_deltas(d):
    return {k: v for k, v in d["metrics"].items() if k.startswith("kernel.")}


def _port_deltas(rd, qid, use_kernels):
    """The reference profile's kernel deltas, with the agg hits of the
    group-bys with a count distinct added where the port has kernels."""
    want = _kernel_deltas(rd)
    if use_kernels:
        want["kernel.agg_hits"] += DISTINCT_GROUPBYS.get(qid, 0)
    return want


# ---------------------------------------------------------------------------
# span tracer, metrics registry, transfer counter
# ---------------------------------------------------------------------------


def test_span_tracer_nests_and_records():
    tr = SpanTracer()
    tr.enable()
    with tr.span("query", category="executor") as q:
        with tr.span("pipeline", category="executor") as p:
            p.set(rows=42)
        q.set(qid=6)
    done = tr.finished()
    assert [s.name for s in done] == ["pipeline", "query"]
    pipeline, query = done
    assert pipeline.parent is query
    assert pipeline.attrs == {"rows": 42}
    assert query.attrs == {"qid": 6}
    assert pipeline.seconds >= 0 and query.seconds >= pipeline.seconds
    assert pipeline.to_dict()["parent"] == "query"


def test_span_tracer_disabled_is_noop():
    tr = SpanTracer()
    with tr.span("x") as s:
        s.set(ignored=True)
    assert tr.finished() == []


def test_span_tracer_thread_stacks_are_independent():
    tr = SpanTracer()
    tr.enable()
    errors = []

    def worker(i):
        try:
            with tr.span(f"w{i}"):
                with tr.span(f"w{i}-inner") as inner:
                    assert inner.parent.name == f"w{i}"
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(tr.finished()) == 16


def test_metrics_registry_concurrent_increments_are_exact():
    reg = MetricsRegistry()
    n_threads, n_incs = 16, 500

    def worker():
        c = reg.counter("test.hits")
        for _ in range(n_incs):
            c.inc()
        reg.histogram("test.lat").observe(0.5)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    snap = reg.snapshot()
    assert snap["test.hits"] == n_threads * n_incs
    assert snap["test.lat.count"] == n_threads
    assert snap["test.lat.sum"] == pytest.approx(0.5 * n_threads)
    assert MetricsRegistry.delta({"test.hits": 1000}, snap)["test.hits"] == \
        n_threads * n_incs - 1000


def test_transfer_counter_concurrent_queries_no_torn_counts():
    arr = torch.arange(16)
    n_threads, n_calls = 8, 200
    with instrument.track_transfers("cpu") as counter:
        def worker():
            for _ in range(n_calls):
                arr.numpy()

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert counter.total == n_threads * n_calls
    assert counter.in_pipeline == 0


# ---------------------------------------------------------------------------
# QueryProfile schema (Q1 / Q6 / Q13)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qid", [1, 6, 13])
def test_profile_schema_golden(qid, analyzed):
    plain, res, d = analyzed[qid]
    assert validate_profile(d) == []
    assert tuple(sorted(d)) == tuple(sorted(_TOP_KEYS))
    for p in d["pipelines"]:
        assert tuple(sorted(p)) == tuple(sorted(_PIPELINE_KEYS))
        for op in p["operators"]:
            assert tuple(sorted(op)) == tuple(sorted(_OP_KEYS))
    assert d["schema_version"] == 1
    assert d["query"] == f"tpch q{qid}"
    assert d["total_seconds"] > 0
    assert 0 <= d["compile_seconds"] <= d["total_seconds"]
    op_sum = sum(op["seconds"] for p in d["pipelines"]
                 for op in p["operators"])
    assert 0 < op_sum <= d["total_seconds"] * 1.001
    final_sink = d["pipelines"][-1]["operators"][-1]
    assert final_sink["rows_out"] == len(next(iter(res.values())))
    for key in ("compiler.traces", "compiler.declines", "kernel.filter_hits",
                "kernel.expand_hits", "kernel.topk_hits",
                "plan_cache.hits", "plan_cache.replay_mismatches",
                "buffers.cold_copy_bytes", "executor.sync_barriers",
                "executor.scalar_syncs", "strings.host_passes"):
        assert key in d["metrics"], f"missing metric family {key}"


def test_profile_json_roundtrip(engine):
    engine.execute(QUERIES[6](), analyze=True)
    prof = engine.last_profile
    restored = QueryProfile.from_json(prof.to_json())
    assert restored.to_json() == prof.to_json()
    text = prof.pretty()
    assert "EXPLAIN ANALYZE" in text
    assert "pipeline 0" in text


def test_fused_region_reports_cost_estimates(engine):
    engine.execute(QUERIES[3]())
    engine.execute(QUERIES[3](), analyze=True)
    d = engine.last_profile.to_dict()
    fused = [op for p in d["pipelines"] for op in p["operators"]
             if op["category"] == "fused"]
    assert fused, "expected at least one fused region in Q3's profile"
    costed = [op for op in fused if "est_flops" in op["attrs"]]
    assert costed, "no fused region reported est_flops"
    for op in costed:
        assert op["attrs"]["est_flops"] > 0
        assert op["attrs"]["est_bytes"] > 0
        assert isinstance(op["attrs"]["cache_hit"], bool)
    assert "est_flops=" in engine.last_profile.pretty()


def test_cost_summary_counts_the_region_items():
    """A fused filter + project region: bytes are its input columns read
    plus its output written, FLOPs the rows times the expression nodes."""
    from repro_torch.core.executor import FilterOp, ProjectOp
    from repro_torch.core.pipeline_compiler import PipelineCompiler
    from repro_torch.relational.expressions import BinOp
    from repro_torch.relational.table import NUMERIC, Column, Table
    (seg,) = PipelineCompiler().prepare([
        FilterOp(BinOp("<", Col("a"), Lit(5))),
        ProjectOp([("b", BinOp("*", Col("a"), Lit(2)))])])
    t = Table({"a": Column(torch.arange(10, dtype=torch.int64), NUMERIC),
               "c": Column(torch.ones(10, dtype=torch.float32), NUMERIC)})
    assert seg(t).num_rows == 5
    info = seg.last_call_info
    assert info["cache_hit"] is False and info["degraded"] is False
    assert info["cost_args"][:2] == (10, 5)
    cost = info["region"].cost_summary(*info["cost_args"])
    # rows in: a int64 + c float32; rows out: b int64; 3 + 3 nodes a row
    assert cost == {"est_flops": 10.0 * 6, "est_bytes": 10.0 * 12 + 5 * 8}
    assert seg.describe() == "FusedRegion[filter+project]"


# ---------------------------------------------------------------------------
# overhead guard and the plan cache
# ---------------------------------------------------------------------------


def test_default_path_adds_zero_extra_syncs(engine):
    plan = QUERIES[6]
    engine.execute(plan())
    before = instrument.sync_barriers.value
    for _ in range(3):
        engine.execute(plan())
    assert instrument.sync_barriers.value - before == 3, \
        "analyze=False must issue exactly one barrier per query"
    before = instrument.sync_barriers.value
    engine.execute(plan(), analyze=True)
    assert instrument.sync_barriers.value - before > 1


@pytest.mark.parametrize("use_kernels", [False, True])
def test_analyzed_run_leaves_the_plan_cache_alone(use_kernels, tpch_db):
    """An analyzed run neither records nor drops an entry, and the next
    plain run is still a replay with one barrier and no scalar sync."""
    eng = _engine(tpch_db, use_kernels=use_kernels)
    eng.execute(QUERIES[3]())
    eng.execute(QUERIES[3]())
    assert eng.executor.last_plan_cache_hit
    stats0 = dict(eng.executor.plan_cache.stats)
    n0 = len(eng.executor.plan_cache)
    eng.execute(QUERIES[3](), analyze=True)
    eng.sql(Q6_SQL, analyze=True)
    assert dict(eng.executor.plan_cache.stats) == stats0
    assert len(eng.executor.plan_cache) == n0
    syncs, barriers = instrument.scalar_syncs.value, instrument.sync_barriers.value
    eng.execute(QUERIES[3]())
    assert eng.executor.last_plan_cache_hit
    assert (instrument.scalar_syncs.value - syncs,
            instrument.sync_barriers.value - barriers) == (0, 1)


def test_profile_mode_records_a_profile(tpch_db):
    eng = _engine(tpch_db, use_kernels=True, profile=True)
    out = eng.execute(QUERIES[3]())
    d = eng.last_profile.to_dict()
    assert validate_profile(d) == []
    assert d["engine"]["profile_mode"] is True
    assert d["pipelines"][-1]["operators"][-1]["rows_out"] == out.num_rows
    assert sum(eng.executor.op_times.values()) > 0
    assert {op["category"] for p in d["pipelines"]
            for op in p["operators"]} >= {"scan", "join", "groupby"}


# ---------------------------------------------------------------------------
# row-exactness: all 22 TPC-H + 15 ClickBench queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qid", QIDS)
def test_analyze_row_exact_tpch(qid, analyzed):
    plain, res, d = analyzed[qid]
    assert_tables_equal(res, plain)
    assert validate_profile(d) == []


@pytest.mark.parametrize("qid", QIDS)
def test_reference_validate_profile_accepts_the_port_profile(qid, analyzed):
    d = analyzed[qid][2]
    assert ref_validate_profile(d) == []
    assert ref_validate_profile(json.loads(json.dumps(d))) == []


@pytest.mark.parametrize("qid", sorted(cb.CLICKBENCH_QUERIES))
def test_analyze_row_exact_clickbench(qid, cb_engines, cb_catalog):
    eng = cb_engines[USE_KERNELS]
    sql = cb.CLICKBENCH_QUERIES[qid]
    plain = eng.sql(sql, catalog=cb_catalog).to_host()
    res = eng.sql(sql, catalog=cb_catalog, analyze=True).to_host()
    assert_tables_equal(res, plain)
    assert validate_profile(eng.last_profile.to_dict()) == []


# ---------------------------------------------------------------------------
# the port's profiles against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_engines(tpch_db):
    out = {}
    for uk in (False, True):
        eng = RefEngine(use_kernels=uk)
        ref_load(eng, tpch_db)
        out[uk] = eng
    return out


@pytest.fixture(scope="module")
def port_engines(tpch_db):
    return {uk: _engine(tpch_db, use_kernels=uk) for uk in (False, True)}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", CROSS_QIDS)
def test_profile_equals_reference_tpch(qid, use_kernels, ref_engines,
                                       port_engines):
    ref = ref_engines[use_kernels]
    port = port_engines[use_kernels]
    want = ref.execute(REF_QUERIES[qid](), analyze=True).to_host()
    got = port.execute(QUERIES[qid](), analyze=True).to_host()
    assert_tables_equal(got, want)
    rd, pd = ref.last_profile.to_dict(), port.last_profile.to_dict()
    assert _shape(pd) == _shape(rd)
    assert _kernel_deltas(pd) == _port_deltas(rd, qid, use_kernels)
    assert set(pd["metrics"]) == set(rd["metrics"]) | {"compiler.declines"}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", CROSS_CB)
def test_profile_equals_reference_clickbench(qid, use_kernels, cb_db,
                                             cb_engines, cb_catalog):
    ref = RefEngine(use_kernels=use_kernels)
    ref_cb.load_into_engine(ref, cb_db)
    text = cb.CLICKBENCH_QUERIES[qid]
    want = ref.sql(text, catalog=ref_cb.clickbench_catalog(CB_ROWS),
                   analyze=True).to_host()
    port = cb_engines[use_kernels]
    got = port.sql(text, catalog=cb_catalog, analyze=True).to_host()
    assert_tables_equal(got, want)
    rd, pd = ref.last_profile.to_dict(), port.last_profile.to_dict()
    assert _shape(pd) == _shape(rd)
    assert _kernel_deltas(pd) == _port_deltas(rd, qid, use_kernels)


# ---------------------------------------------------------------------------
# SQL front door: EXPLAIN ANALYZE
# ---------------------------------------------------------------------------


def test_explain_analyze_sql_returns_profile(engine):
    prof = engine.sql("EXPLAIN ANALYZE " + Q6_SQL)
    assert isinstance(prof, QueryProfile)
    assert prof is engine.last_profile
    assert validate_profile(prof.to_dict()) == []
    assert prof.query.startswith("select sum")
    prof2 = engine.sql("  explain   analyze " + Q6_SQL)
    assert isinstance(prof2, QueryProfile)
    assert run_sql("EXPLAIN ANALYZE " + Q6_SQL, engine) is engine.last_profile


def test_run_sql_explain_analyze_requires_engine(tpch_db):
    with pytest.raises(SqlError, match="EXPLAIN ANALYZE"):
        run_sql("EXPLAIN ANALYZE " + Q6_SQL, tpch_db)
    with pytest.raises(SqlError, match="FallbackEngine"):
        run_sql("EXPLAIN ANALYZE " + Q6_SQL, FallbackEngine(tpch_db))


def test_sql_analyze_kwarg_returns_rows_and_profile(engine):
    out = engine.sql(Q6_SQL, analyze=True)
    ref = engine.sql(Q6_SQL)
    assert_tables_equal(out.to_host(), ref.to_host())
    assert isinstance(engine.last_profile, QueryProfile)
    assert engine.last_profile.query == Q6_SQL


# ---------------------------------------------------------------------------
# profile diffing
# ---------------------------------------------------------------------------


def _mini_profile(sink_seconds: float) -> dict:
    return {
        "schema_version": 1, "query": "q", "engine": {},
        "total_seconds": 0.01 + sink_seconds, "compile_seconds": 0.0,
        "execute_seconds": 0.01 + sink_seconds,
        "pipelines": [{"pid": 0, "source": "scan:lineitem", "deps": [],
                       "operators": [
                           {"name": "scan:lineitem", "category": "scan",
                            "rows_in": 100, "rows_out": 100,
                            "seconds": 0.01, "attrs": {}},
                           {"name": "AggSink", "category": "groupby",
                            "rows_in": 100, "rows_out": 1,
                            "seconds": sink_seconds, "attrs": {}}]}],
        "operator_totals": {"scan": 0.01, "groupby": sink_seconds},
        "metrics": {}, "plan": "", "fragments": [],
    }


def test_diff_profiles_flags_synthetic_slowdown():
    old, new = _mini_profile(0.004), _mini_profile(0.100)
    assert validate_profile(old) == [] and validate_profile(new) == []
    regressions, report = diff_profiles(old, new)
    assert regressions, "25x sink slowdown must regress"
    assert any("AggSink" in r for r in regressions)
    assert diff_profiles(old, old) == ([], [])


def _slowed(d: dict, name: str, extra_s: float) -> dict:
    """``d`` with operator ``name`` (its last occurrence) ``extra_s`` slower."""
    d = copy.deepcopy(d)
    op = [o for p in d["pipelines"] for o in p["operators"]
          if o["name"] == name][-1]
    op["seconds"] += extra_s
    d["operator_totals"][op["category"]] += extra_s
    d["total_seconds"] += extra_s
    d["execute_seconds"] += extra_s
    return d


def test_profile_diff_cli_reads_port_profiles(engine, tmp_path):
    """The reference's CLI on two of the port's profile JSONs: a synthetic
    slowdown of Q6's aggregate sink exits 1 and names it; the same profile
    twice exits 0."""
    engine.execute(QUERIES[6](), analyze=True)
    old = json.loads(engine.last_profile.to_json())
    new = _slowed(old, "AggSink", 0.5)
    assert ref_validate_profile(new) == []
    pa, pb = tmp_path / "old.json", tmp_path / "new.json"
    pa.write_text(engine.last_profile.to_json())
    pb.write_text(json.dumps(new))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "profile_diff.py"),
         str(pa), str(pb)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "REGRESSION" in proc.stdout and "AggSink" in proc.stdout
    clean = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "profile_diff.py"),
         str(pa), str(pa)], capture_output=True, text=True, timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr


def test_validate_profile_rejects_drift():
    d = _mini_profile(0.004)
    d["surprise"] = 1
    assert any("unknown top-level" in e for e in validate_profile(d))
    d2 = _mini_profile(0.004)
    del d2["metrics"]
    assert any("missing top-level" in e for e in validate_profile(d2))
    d3 = _mini_profile(0.004)
    d3["pipelines"][0]["operators"][0]["category"] = "mystery"
    assert any("unknown category" in e or "mystery" in e
               for e in validate_profile(d3))
    d4 = _mini_profile(0.004)
    d4["pipelines"][0]["operators"][0]["seconds"] = 99.0
    assert any("sum" in e for e in validate_profile(d4))


# ---------------------------------------------------------------------------
# accelerate(analyze=True)
# ---------------------------------------------------------------------------


def test_accelerate_analyze_merges_fragment_profiles(engine):
    out = engine.accelerate(sql_to_wire(Q6_SQL), analyze=True)
    prof = engine.last_profile
    assert isinstance(prof, QueryProfile)
    assert validate_profile(prof.to_dict()) == []
    assert ref_validate_profile(prof.to_dict()) == []
    assert prof.fragments, "accelerate profile must carry fragment entries"
    for frag in prof.fragments:
        assert "_profile" not in frag
        assert frag["seconds"] >= 0
    for frag in engine.last_accelerate_report["fragments"]:
        assert "_profile" not in frag
    assert prof.engine.get("accelerate") is True
    assert out.num_rows == 1
    assert all(p.source.startswith("frag0:") for p in prof.pipelines)


def test_accelerate_analyze_on_a_hybrid_plan(engine, tpch_db):
    """A UNION ALL (host-only SetRel): two device fragments with their
    pipelines, the host fragment as one ``HostFragment`` operator."""
    from repro_torch.substrait import emit
    from repro_torch.sql.binder import DEFAULT_CATALOG
    halves = [ReadRel("orders", ["o_orderkey", "o_totalprice"], filter=cond)
              for cond in (Col("o_orderkey") <= Lit(1000),
                           Col("o_orderkey") > Lit(1000))]
    plan = AggregateRel(SetRel(halves), [],
                        [AggSpec("count_star", None, "n"),
                         AggSpec("sum", Col("o_totalprice"), "s")])
    out = engine.accelerate(emit(plan, DEFAULT_CATALOG), analyze=True)
    prof = engine.last_profile
    assert validate_profile(prof.to_dict()) == []
    assert [f["placement"] for f in prof.fragments] == \
        ["device", "device", "host", "device"]
    host = [p for p in prof.pipelines if p.source.endswith(":host")]
    assert len(host) == 1 and host[0].operators[0].name == "HostFragment"
    n_orders = len(tpch_db["orders"]["o_orderkey"])
    assert host[0].operators[0].rows_out == n_orders      # the union's rows
    assert int(out.to_host()["n"][0]) == n_orders
