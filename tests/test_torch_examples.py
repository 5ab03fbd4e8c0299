"""The port's entry points against the reference's examples, on the CPU.

* Graceful fallback for a table only the host holds: the quickstart's plan
  over ``host_tables["mystery"]`` runs on the host as the reference's
  does, and is counted; a table neither side holds still raises; a failed
  plan leaves nothing in the plan cache or the SQL text cache, and a
  dropped table is not replayed from a stale entry.
* ``repro_torch.quickstart.main(device="cpu")`` against the reference's
  ``examples/quickstart.py`` run in this process (its engine records its
  results; the rest is read from its printed lines) at SF 0.01.
* ``repro_torch.distributed_query.main(device="cpu")`` against the
  reference's ``FallbackEngine`` and the reference example's recovery
  line (the example itself spawns 8 forced host devices and is not run).
* ``repro_torch.trace_report`` on 4 shards and on a journal sink.
"""
import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core.fallback import FallbackEngine as RefFallbackEngine
from repro.core.plan import AggregateRel as RefAggregateRel
from repro.core.plan import ReadRel as RefReadRel
from repro.data.tpch import generate as ref_generate
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.relational import AggSpec as RefAggSpec
from repro.relational import Col as RefCol
from repro_torch import distributed_query, quickstart, trace_report
from repro_torch.buffer import manager
from repro_torch.core.executor import PlanNotLowerable, SiriusEngine
from repro_torch.core.plan import AggregateRel, ReadRel
from repro_torch.core.plan_cache import plan_signature
from repro_torch.data.tpch import generate, load_into_engine
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.observability.journal import JOURNAL
from repro_torch.relational import AggSpec, Col, Table

from conftest import assert_tables_equal

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MYSTERY = {"x": np.arange(4.0)}


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# graceful fallback for a table only the host holds
# ---------------------------------------------------------------------------


def test_host_only_table_falls_back_as_the_reference_does():
    eng = SiriusEngine(use_kernels=True, device="cpu")
    eng.host_tables["mystery"] = dict(MYSTERY)
    got, route = eng.execute_with_fallback(quickstart.fallback_plan())
    ref = ref_executor.SiriusEngine(use_kernels=True)
    ref.host_tables["mystery"] = dict(MYSTERY)
    want, ref_route = ref.execute_with_fallback(RefAggregateRel(
        RefReadRel("mystery"), [], [RefAggSpec("sum", RefCol("x"), "s")]))
    assert (route, ref_route) == ("fallback", "fallback")
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(got["s"], [6.0])
    assert eng.executor.fallback_queries == ref.executor.fallback_queries == 1
    assert eng.backend.hit_counts() == dict.fromkeys(eng.backend.hit_counts(), 0)


def test_execute_of_a_host_only_table_raises_before_any_kernel():
    eng = SiriusEngine(use_kernels=True, device="cpu")
    eng.host_tables["mystery"] = dict(MYSTERY)
    with pytest.raises(PlanNotLowerable, match="mystery"):
        eng.execute(quickstart.fallback_plan())
    assert eng.executor.fallback_queries == 0


def test_a_table_neither_side_holds_still_raises():
    eng = SiriusEngine(use_kernels=True, device="cpu")
    eng.host_tables["mystery"] = dict(MYSTERY)
    plan = AggregateRel(ReadRel("nowhere"), [], [AggSpec("sum", Col("x"), "s")])
    with pytest.raises(manager.BufferError, match="nowhere"):
        eng.execute_with_fallback(plan)
    assert eng.executor.fallback_queries == 0


def test_failed_plan_is_not_cached_and_runs_on_the_device_once_registered():
    eng = SiriusEngine(use_kernels=True, device="cpu")
    eng.host_tables["mystery"] = dict(MYSTERY)
    _, route = eng.execute_with_fallback(quickstart.fallback_plan())
    assert route == "fallback"
    assert eng.executor.plan_cache.lookup(
        plan_signature(quickstart.fallback_plan())) is None
    eng.register("mystery", Table.from_pydict(MYSTERY), host_data=MYSTERY)
    out, route = eng.execute_with_fallback(quickstart.fallback_plan())
    assert route == "accelerator"
    np.testing.assert_array_equal(out.to_host()["s"], [6.0])
    assert eng.executor.fallback_queries == 1


def test_a_dropped_table_is_not_replayed_and_its_sql_is_not_keyed():
    db = generate(0.002)
    eng = SiriusEngine(device="cpu")
    load_into_engine(eng, db)
    text = "select count(*) as n from nation"
    want = eng.sql(text).to_host()
    eng.sql(text)
    assert eng.executor.last_plan_cache_hit
    (sig,) = eng._sql_plan_sigs.values()
    eng.buffers.drop("nation")
    with pytest.raises(PlanNotLowerable, match="nation"):
        eng.sql(text)
    assert eng.executor.plan_cache.lookup(sig) is None
    with pytest.raises(PlanNotLowerable, match="nation"):
        eng.sql("select count(*) as m from nation")
    assert list(eng._sql_plan_sigs.values()) == [sig]
    got, route = eng.execute_with_fallback(QUERIES[2]())
    assert route == "fallback"
    assert_tables_equal(got, RefFallbackEngine(db).execute(REF_QUERIES[2]()))
    eng.register("nation", Table.from_pydict(db["nation"]),
                 host_data=db["nation"])
    assert_tables_equal(eng.sql(text).to_host(), want)
    assert eng.executor.fallback_queries == 1


# ---------------------------------------------------------------------------
# the quickstart against the reference's example
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_quickstart():
    """Run ``examples/quickstart.py``'s ``main`` with an engine that keeps
    its SQL and plan results (``sql_results``, ``plan_results``); returns
    the engine and the printed text."""
    spec = importlib.util.spec_from_file_location(
        "_ref_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    engines = []

    class Recording(ref_executor.SiriusEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sql_results, self.plan_results = [], []
            engines.append(self)

        def sql(self, text, *a, **kw):
            out = super().sql(text, *a, **kw)
            self.sql_results.append(out.to_host())
            return out

        def execute(self, plan, *a, **kw):
            out = super().execute(plan, *a, **kw)
            self.plan_results.append(out.to_host())
            return out

    mod.SiriusEngine = Recording
    _, text = _quiet(mod.main)
    return engines[0], text


@pytest.fixture(scope="module")
def port_quickstart():
    return _quiet(quickstart.main, device="cpu")


def _rows(rows):
    return {k: np.array([r[k] for r in rows]) for k in rows[0]}


def _printed(pattern, text):
    m = re.search(pattern, text)
    assert m, pattern
    return m.groups()


def test_quickstart_sql_rows_equal_the_reference(ref_quickstart, port_quickstart):
    eng, _ = ref_quickstart
    (summary, _), want = port_quickstart, eng.sql_results[0]
    got = _rows(summary["rows"])
    assert list(got) == list(want) == ["c_mktsegment", "revenue", "orders"]
    assert_tables_equal(got, want)
    assert len(summary["rows"]) == 5


def test_quickstart_wire_and_q3_equal_the_reference(ref_quickstart, port_quickstart):
    _, text = ref_quickstart
    summary, printed = port_quickstart
    (wire,) = _printed(r"wire format: (\d+) bytes", text)
    assert summary["wire_bytes"] == int(wire) == 1077
    q3_rows, same = _printed(r"rows: (\d+), SQL path == hand-built plan: (\w+)", text)
    assert (summary["q3_rows"], summary["q3_same"]) == (int(q3_rows), same == "True")
    assert summary["q3_same"]
    assert f"wire format: {summary['wire_bytes']} bytes" in printed


def test_quickstart_hand_built_revenues_equal_the_reference(ref_quickstart,
                                                           port_quickstart):
    eng, _ = ref_quickstart
    want = [r for r in eng.plan_results
            if list(r) == ["c_mktsegment", "revenue"]]
    assert len(want) == 1
    np.testing.assert_allclose(port_quickstart[0]["revenues"],
                               want[0]["revenue"], rtol=1e-6)


def test_quickstart_compiler_counts_and_hits_equal_the_reference(
        ref_quickstart, port_quickstart):
    _, text = ref_quickstart
    summary, printed = port_quickstart
    want = tuple(map(int, _printed(
        r"compiled regions: (\d+), traces: (\d+), cache hits: (\d+), "
        r"fused probes: (\d+)", text)))
    c = summary["compiler"]
    assert (c["regions"], c["traces"], c["cache_hits"], c["fused_probes"]) \
        == want == (9, 9, 5, 6)
    hits = tuple(map(int, _printed(
        r"filter kernel hits: (\d+), probe kernel hits: (\d+), "
        r"MXU aggregation hits: (\d+)", text)))
    h = summary["hits"]
    assert (h["filter"], h["probe"], h["agg"]) == hits == (10, 6, 9)
    assert "Pallas" not in printed and "MXU" not in printed


def test_quickstart_fallback_equals_the_reference(ref_quickstart, port_quickstart):
    eng, text = ref_quickstart
    summary, printed = port_quickstart
    route, value = _printed(r"executed on: (\w+); result=([\d.]+)", text)
    assert summary["fallback"] == {"route": route, "s": float(value),
                                   "queries": eng.executor.fallback_queries}
    assert summary["fallback"] == {"route": "fallback", "s": 6.0, "queries": 1}
    assert "executed on: fallback; result=6.0" in printed
    assert summary["q6_cold_ms"] > 0 and summary["q6_hot_ms"] > 0


def test_quickstart_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _quiet(quickstart.main)


# ---------------------------------------------------------------------------
# the distributed example and the trace report
# ---------------------------------------------------------------------------


def test_distributed_query_equals_the_fallback_and_recovers():
    summary, printed = _quiet(distributed_query.main, device="cpu")
    db = ref_generate(distributed_query.SF)
    fb = RefFallbackEngine(db)
    rows = {qid: len(next(iter(fb.execute(REF_QUERIES[qid]()).values())))
            for qid in distributed_query.QIDS}
    assert {q: s["rows"] for q, s in summary["queries"].items()} == rows \
        == {1: 4, 3: 10, 6: 1, 12: 2}
    for s in summary["queries"].values():
        assert {"compute", "exchange", "other"} <= set(s["timers"])
    rec = summary["recovered"]
    np.testing.assert_allclose(rec["revenue"], np.asarray(
        fb.execute(REF_QUERIES[3]())["revenue"], float), rtol=1e-6)
    assert rec["identical"] and rec["recoveries"] == 0
    assert rec["live_nodes"] == list(range(8))
    # the reference example's recovery lines
    assert ("node 5 killed during q3_join → recovered on 8 shards; "
            "result identical: True") in printed
    assert "recoveries=0, live nodes=[0, 1, 2, 3, 4, 5, 6, 7]" in printed


def test_trace_report_on_four_shards_exits_zero(tmp_path):
    chrome = tmp_path / "q3.json"
    out, printed = _quiet(trace_report.run, ["--shards", "4", "--device", "cpu",
                                             "--chrome", str(chrome)])
    assert out["code"] == 0, out["failures"]
    assert "OK: journal tree verified" in printed
    assert trace_report.close_enough(out["root_s"], out["total_s"])
    assert trace_report.close_enough(out["span_s"], out["profile_s"])
    events = json.loads(chrome.read_text())["traceEvents"]
    assert {e["pid"] for e in events} >= {0, 1, 2, 3, 4}


def test_trace_report_reads_a_journal_sink(tmp_path):
    from repro_torch.core.distributed import DistributedEngine
    sink = tmp_path / "journal.jsonl"
    eng = DistributedEngine(generate(0.002), n_shards=2, device="cpu")
    JOURNAL.attach_sink(str(sink))
    try:
        eng.run_plan(QUERIES[6]())
    finally:
        JOURNAL.detach_sink()
    code, printed = _quiet(trace_report.main, ["--jsonl", str(sink),
                                               "--query-id", eng.last_query_id])
    assert code == 0
    assert f"verify_tree({eng.last_query_id}): ok" in printed
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    code, _ = _quiet(trace_report.main, ["--jsonl", str(empty)])
    assert code == 2
