"""Device time put down to journal spans (``harness/attribution.py``) and
the three readers of it, on synthetic spans and a fake kineto event list:
a kernel launched inside a group-by sink, one inside a fused probe region,
two under one graph launch, one launched on another thread, one before
the window and one after it, a ring that dropped spans, and runtime
events on a clock of their own, tied to the journal at the barrier."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench_port.harness import attribution, spec
from bench_port.harness.cell import WindowRun
from bench_port.harness.trace import MARKER, Trace

CLIENT, OTHER = 7, 9
OFFSET_NS = 1_000_000_000       # the kineto clock runs 1 s ahead of perf


class _Event:
    def __init__(self, name, start_s, dur_s=0.0, corr=0, tid=CLIENT,
                 device=DeviceType.CPU, annotation=False, skew_ns=0):
        self._name, self._corr, self._tid = name, corr, tid
        self._start = int(start_s * 1e9) + OFFSET_NS + skew_ns
        self._dur = int(dur_s * 1e9)
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


def _kernel(start_s, dur_s, corr, name="kernel"):
    return _Event(name, start_s, dur_s, corr, tid=0, device=DeviceType.CUDA)


class _Trace(Trace):
    def __init__(self, events):
        self.prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))
        self.offset_ns = OFFSET_NS
        self.device, self.host = [], []


def _span(sid, name, parent, ts, end, **attrs):
    return {"span_id": sid, "name": name, "parent_id": parent, "ts": ts,
            "dur": end - ts, "attrs": attrs}


# two warm queries: a closure replay with operator spans, then a graph
# replay (one launch, no operator spans)
SPANS = [
    _span(1, "sql", None, 10.000, 10.050),
    _span(2, "engine.execute", 1, 10.0005, 10.0495),
    _span(3, "plan_cache.replay", 2, 10.001, 10.049, mode="closure"),
    _span(4, "pipeline", 3, 10.002, 10.030, index=0, source="lineitem",
          sink="AggSink"),
    _span(5, "op.scan", 4, 10.002, 10.004),
    _span(6, "op.fused", 4, 10.005, 10.010, op="FusedRegion[filter+probe]"),
    _span(7, "sink.groupby", 4, 10.011, 10.029, op="AggSink"),
    _span(8, "executor.barrier", 3, 10.031, 10.049),
    _span(11, "sql", None, 10.060, 10.090),
    _span(12, "engine.execute", 11, 10.0605, 10.0895),
    _span(13, "plan_cache.replay", 12, 10.061, 10.089, mode="graph"),
    _span(14, "executor.barrier", 13, 10.070, 10.089),
]

EVENTS = [
    _Event(MARKER, 10.000, 0.1, annotation=True),
    _Event("cudaLaunchKernel", 10.006, 1e-6, corr=101),   # in the probe
    _kernel(10.020, 0.002, 101),                           # runs late
    _Event("aten::mm", 10.040, 1e-6, corr=101),    # a torch op's own id
    _Event("cudaLaunchKernel", 10.015, 1e-6, corr=102),   # in the group-by
    _kernel(10.032, 0.003, 102, "groupby_sum_kernel"),
    _Event("cudaDeviceSynchronize", 10.031, 0.018, corr=110),
    _Event("cudaGraphLaunch", 10.065, 1e-6, corr=103),    # the graph's
    _kernel(10.066, 0.001, 103),
    _kernel(10.068, 0.001, 103),
    _Event("cudaLaunchKernel", 9.990, 1e-6, corr=104),    # before the window
    _kernel(9.995, 0.008, 104),                            # 3 ms inside it
    _Event("cudaLaunchKernel", 10.095, 1e-6, corr=105),
    _kernel(10.200, 0.010, 105),                           # after the window
    _Event("cudaLaunchKernel", 10.012, 1e-6, corr=106, tid=OTHER),
    _kernel(10.013, 0.001, 106),                           # another thread's
    _Event("gpu annotation", 10.001, 0.05, device=DeviceType.CUDA,
           annotation=True),
]


def _skewed(events, skew_ns):
    """The runtime's events (launches, synchronize) ``skew_ns`` off the
    marker's tie; device ops and host operators keep it."""
    out = []
    for e in events:
        if e.name().startswith("cu"):
            e = _Event(e.name(), (e._start - OFFSET_NS) / 1e9, e._dur / 1e9,
                       e._corr, e._tid, skew_ns=skew_ns)
        out.append(e)
    return out


def _run(spans=SPANS, n_records=2, events=EVENTS):
    run = WindowRun()
    run.spans = list(spans)
    run.records = [{"qid": 1, "ok": True}] * n_records
    run.trace = _Trace(events)
    run.t0, run.t1 = 10.0, 10.1
    run.window_s = 0.1
    return run


def test_device_seconds_go_to_the_span_open_at_the_launch():
    by_span = attribution.device_by_span(_run())
    assert by_span.keys() == {6, 7, 13, None}
    assert by_span[6] == pytest.approx(0.002)       # probe, though it ran late
    assert by_span[7] == pytest.approx(0.003)
    assert by_span[13] == pytest.approx(0.002)      # both graph kernels
    # launched before the window (clipped to its 3 ms inside) or elsewhere
    assert by_span[None] == pytest.approx(0.004)


def test_launches_are_tied_to_the_journal_at_the_barriers():
    """6 ms off the marker, the probe's launch would fall in the group-by
    and the graph's in the barrier; the synchronize inside the first
    barrier span ties them back."""
    want = attribution.device_by_span(_run())
    skewed = _skewed(EVENTS, 6_000_000)
    assert attribution.device_by_span(_run(events=skewed)) == \
        pytest.approx(want)
    untied = [e for e in skewed if e.name() != "cudaDeviceSynchronize"]
    assert 6 not in attribution.device_by_span(_run(events=untied))


def test_join_and_groupby_device_ms_per_query():
    run = _run()
    assert spec.metric_reader("join_device_ms")(run) == pytest.approx(1.0)
    assert spec.metric_reader("groupby_device_ms")(run) == pytest.approx(1.5)
    # a span nested under a join counts as the join's
    nested = SPANS + [_span(20, "op.inner", 6, 10.0055, 10.0065)]
    run = _run(nested)
    assert attribution.device_by_span(run)[20] == pytest.approx(0.002)
    assert spec.metric_reader("join_device_ms")(run) == pytest.approx(1.0)


def test_replay_dispatch_ms_reads_up_to_the_first_barrier():
    # closure replay 30 ms before its barrier, graph replay 9 ms
    assert spec.metric_reader("replay_dispatch_ms")(_run()) == \
        pytest.approx(19.5)


@pytest.mark.parametrize("name", ["replay_dispatch_ms", "join_device_ms",
                                  "groupby_device_ms"])
def test_readers_find_nothing_where_the_window_cannot_say(name):
    read = spec.metric_reader(name)
    # the ring dropped the first query's spans: three queries, two trees
    assert read(_run(n_records=3)) is None
    # a program with neither operator nor barrier spans
    bare = [s for s in SPANS if not s["name"].startswith(
        ("pipeline", "op.", "sink.", "executor.barrier"))]
    assert read(_run(bare)) is None
    if name != "replay_dispatch_ms":
        run = _run()
        run.trace = None                   # an untraced run
        assert read(run) is None
        run = _run()
        run.records = [{"qid": 1, "ok": False}] * 2
        run.spans = SPANS
        assert read(run) is None           # no completed query


def test_attribution_is_worked_out_once_a_run():
    run = _run()
    first = attribution.device_by_span(run)
    run.trace = _Trace([])
    assert attribution.device_by_span(run) is first
