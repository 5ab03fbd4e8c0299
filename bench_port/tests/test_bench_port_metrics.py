"""The metric arithmetic: union of device intervals, the 95th percentile
over every query, span self times, counter ratios and ``query_mfu``'s
byte counts."""
import numpy as np
import pytest

from bench_port.harness import spec, stats
from bench_port.harness.cell import WindowRun
from bench_port.harness.spans import outermost, self_time
from bench_port.harness.trace import Trace, _Innermost, merged, union_seconds
from bench_port.queries import tpch as q


def test_union_of_intervals():
    assert union_seconds([]) == 0
    assert union_seconds([(0, 10), (5, 20), (30, 40), (31, 35)]) == pytest.approx(30e-9)
    assert merged([(5, 20), (0, 10), (30, 40)]) == [(0, 20), (30, 40)]


def test_innermost_interval():
    x = _Innermost([(0, 100, "a"), (10, 20, "b"), (30, 90, "c"), (40, 50, "d")])
    assert [x.at(t) for t in (5, 15, 25, 45, 60, 95, 150)] == \
        ["a", "b", "a", "d", "c", "a", None]


def test_p95_is_over_every_query():
    lat = list(np.random.default_rng(1).exponential(size=401))
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile([3.0], 95) == 3.0


def _span(i, name, parent, dur):
    return {"span_id": i, "name": name, "parent_id": parent, "dur": dur}


def test_span_self_time_and_outermost():
    spans = [_span(1, "sql", None, 0.010), _span(2, "engine.execute", 1, 0.007),
             _span(3, "plan_cache.record", 2, 0.006), _span(4, "engine.execute", 3, 0.002),
             _span(5, "plan_cache.record", 4, 0.001), _span(6, "sql", None, 0.004),
             _span(7, "engine.execute", 6, 0.001), _span(8, "plan_cache.replay", 7, 0.0009)]
    assert self_time(spans, "sql", "engine.execute") == pytest.approx([0.003, 0.003])
    assert [s["span_id"] for s in outermost(spans, "plan_cache.record")] == [3]
    run = WindowRun()
    run.spans = spans
    run.records = [{"qid": 1, "ok": True}, {"qid": 6, "ok": True}]
    assert spec.metric_reader("frontend_ms")(run) == pytest.approx(3.0)
    assert spec.metric_reader("replay_ms")(run) == pytest.approx(0.9)


def test_counter_metrics():
    run = WindowRun()
    run.records = [{"qid": 1, "ok": True}] * 4 + [{"qid": 1, "ok": False}]
    run.counters_before = {"plan_cache.hits": 10, "plan_cache.misses": 5,
                           "executor.scalar_syncs": 100, "kernel.launches": 7}
    run.counters_after = {"plan_cache.hits": 13, "plan_cache.misses": 6,
                          "executor.scalar_syncs": 120, "kernel.launches": 47}
    assert spec.metric_reader("plan_cache_hit_share")(run) == pytest.approx(0.75)
    assert spec.metric_reader("scalar_syncs_per_query")(run) == pytest.approx(5.0)
    assert spec.metric_reader("kernel_launches_per_query")(run) == pytest.approx(10.0)
    run.counters_after = dict(run.counters_before)
    assert spec.metric_reader("plan_cache_hit_share")(run) is None


def test_query_mfu_counts_each_referenced_column_once():
    run = WindowRun()
    run.queries = q
    rows = {"lineitem": 60_000_000}
    for t, c in [(t, c) for t, cols in q.SCHEMA.items() for c in cols]:
        n = rows.get(t, 1000)
        run.column_bytes[(t, c)] = n * (4 if c.endswith("date") else 8)
    run.records = [{"qid": 6, "ok": True}, {"qid": 6, "ok": False}]
    run.window_s = 1.0
    q6_bytes = 60_000_000 * (8 + 8 + 8 + 4)
    want = 100 * q6_bytes / stats.HBM_BYTES_PER_S
    assert spec.metric_reader("query_mfu")(run) == pytest.approx(want)
    run.records = []
    assert spec.metric_reader("query_mfu")(run) is None


class _FakeTrace(Trace):
    def __init__(self, device):
        self.device = device
        self.host = []
        self.offset_ns = 0


def test_idle_share_and_breakdown():
    tr = _FakeTrace([(0, 2_000_000, "k1"), (1_000_000, 3_000_000, "k2"),
                     (6_000_000, 7_000_000, "k1")])
    run = WindowRun()
    run.trace, run.t0, run.t1, run.window_s = tr, 0.0, 0.010, 0.010
    assert spec.metric_reader("device_idle_share")(run) == pytest.approx(0.6)
    spans = [{"name": "sql", "ts": 0.0035, "dur": 0.002}]
    b = tr.breakdown(0.0, 0.010, spans)
    assert b["device_ops"][0] == ["k1", pytest.approx(0.003)]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "sql|python": pytest.approx(0.003), "client|python": pytest.approx(0.003)}
