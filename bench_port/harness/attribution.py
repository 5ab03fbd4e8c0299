"""Device time put down to the program's journal spans.

Kineto gives each device operation of the traced window the correlation
id of the runtime call that launched it (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...).  That call ran on a host
thread; on the client's thread, the innermost journal span open at that
instant is the operator that launched the work.  The launch and the span
are both host times, tied by the trace's one marker (``Trace.offset_ns``),
so the device queue's lag does not enter: a kernel that runs long after
its launch is still put down to the operator that launched it.

The marker's tie is only as close as the marker's start to the clock
reading it is tied to: on an H100 it read 0.75 ms late, longer than many
an operator's span.  So the launches are tied to the journal where both
record one thing: each ``executor.barrier`` span holds the query's one
``cudaDeviceSynchronize``.  A launch takes the offset of the barrier
nearest to it, which follows any drift as well.

The readers of ``metrics/`` sum a span's seconds where it, or a span it
is nested in, is one they count, per completed query.  Each returns None
where the journal's ring dropped part of the window (fewer outermost
``sql`` spans than queries), where there is no trace, or where no span of
its kind was open (a program without operator spans).
"""
from __future__ import annotations

import bisect
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from .spans import outermost
from .trace import MARKER, _Innermost, _ns

# WindowRun → its device seconds by span, worked out once for all readers
_BY_RUN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def complete(run) -> bool:
    """Whether the client's journal spans cover every query of the window:
    the ring drops its oldest events when it is full."""
    return len(outermost(run.spans, "sql")) >= len(run.records)


def _ties(spans, syncs, offset_ns: int) -> List[Tuple[int, int]]:
    """(journal ns, runtime ns − journal ns) at each barrier: the centre of
    each client ``cudaDeviceSynchronize`` (runtime ns) against the centre
    of the ``executor.barrier`` span nearest to it by the marker's tie.
    Queries lie far further apart than the marker's error, so the nearest
    barrier is the call's own."""
    bars = sorted((int(s["ts"] * 1e9), int((s["ts"] + s["dur"]) * 1e9))
                  for s in spans if s["name"] == "executor.barrier")
    starts = [a for a, _ in bars]
    ties = []
    for a, b in syncs:
        t = a - offset_ns
        i = bisect.bisect_left(starts, t)
        near = [j for j in (i - 1, i) if 0 <= j < len(bars)]
        if near:
            s0, s1 = bars[min(near, key=lambda j: abs(starts[j] - t))]
            ties.append(((s0 + s1) // 2, (a + b) // 2 - (s0 + s1) // 2))
    return sorted(ties)


def device_by_span(run) -> Optional[Dict[Optional[int], float]]:
    """Device seconds inside the window (each op clipped to ``[t0, t1]``)
    by the ``span_id`` of the innermost client span open at the op's
    launch; key None for ops whose launch is not on the client's thread,
    not in the trace, or under no span.  None without a trace."""
    if run.trace is None:
        return None
    if run in _BY_RUN:
        return _BY_RUN[run]
    from torch.autograd import DeviceType
    tr = run.trace
    lo, hi = tr.to_trace_ns(run.t0), tr.to_trace_ns(run.t1)
    events = tr.prof.profiler.kineto_results.events()
    client = None
    launches: Dict[int, tuple] = {}     # correlation id → (start ns, thread)
    device = []                         # (correlation id, seconds)
    syncs = []                          # (start ns, end ns, thread)
    for e in events:
        name = e.name()
        if name == MARKER:
            client = e.start_thread_id()
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        start = _ns(e, "start")
        if e.device_type() == DeviceType.CUDA:
            end = start + int(e.duration_ns()) if hasattr(e, "duration_ns") \
                else _ns(e, "end")
            if end > lo and start < hi:
                device.append((e.correlation_id(),
                               (min(end, hi) - max(start, lo)) / 1e9))
        elif name.startswith("cu"):     # cudaLaunchKernel, cuLaunchKernel, ...
            launches[e.correlation_id()] = (start, e.start_thread_id())
            if name == "cudaDeviceSynchronize":
                syncs.append((start, start + int(e.duration_ns()),
                              e.start_thread_id()))
    ties = _ties(run.spans, [(a, b) for a, b, t in syncs if t == client],
                 tr.offset_ns)
    at_ns = [t for t, _ in ties]

    def journal_ns(runtime_ns: int) -> int:
        t = runtime_ns - tr.offset_ns
        if not ties:
            return t
        i = bisect.bisect_left(at_ns, t)
        near = min((j for j in (i - 1, i) if 0 <= j < len(ties)),
                   key=lambda j: abs(at_ns[j] - t))
        return runtime_ns - ties[near][1]

    span_at = _Innermost([(int(s["ts"] * 1e9), int((s["ts"] + s["dur"]) * 1e9),
                           s["span_id"]) for s in run.spans])
    out: Dict[Optional[int], float] = {}
    for corr, seconds in device:
        at = launches.get(corr)
        sid = None
        if at is not None and at[1] == client:
            sid = span_at.at(journal_ns(at[0]))
        out[sid] = out.get(sid, 0.0) + seconds
    _BY_RUN[run] = out
    return out


def seconds_under(run, counts: Callable[[dict], bool]) -> Optional[float]:
    """Device seconds launched inside a span for which ``counts(span)``
    holds, or inside a span nested in one; None where the window cannot
    say (see the module's docstring)."""
    if not complete(run):
        return None
    by_span = device_by_span(run)
    if by_span is None or not any(counts(s) for s in run.spans):
        return None
    by_id = {s["span_id"]: s for s in run.spans}
    total = 0.0
    for sid, seconds in by_span.items():
        s = by_id.get(sid)
        while s is not None and not counts(s):
            s = by_id.get(s["parent_id"])
        if s is not None:
            total += seconds
    return total


def ms_per_query(run, counts: Callable[[dict], bool]) -> Optional[float]:
    """``seconds_under`` in ms per completed query of the window."""
    n = len(run.completed)
    seconds = seconds_under(run, counts) if n else None
    return None if seconds is None else seconds / n * 1e3
