"""The traced window: ``torch.profiler`` over it, then its device
intervals, the union of them (device busy time, the arithmetic of the
port's ``profile_tpch.py``), and the breakdown of where the device's time
and its idle gaps went.

Kineto's clock and ``time.perf_counter`` are tied by one marker: a
``record_function`` opened at a known ``perf_counter`` time.  Journal
spans (``perf_counter`` seconds) are moved onto the trace's clock by it, so
an idle gap is named by the journal span open on the client's thread and
the innermost host operator running there.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

MARKER = "bench_port.window"


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    """Length of the union of ``(start_ns, end_ns)`` intervals, seconds."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is not None and b <= end:
            continue
        total += b - (a if end is None else max(a, end))
        end = b
    return total / 1e9


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """Profiles the window; ``marker()`` is entered at the window's start."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.device = []      # (start_ns, end_ns, name)
        self.host = []        # (start_ns, end_ns, name) on the client thread
        self.offset_ns = 0    # kineto ns - perf_counter ns
        self.t0_perf = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def marker(self):
        self.t0_perf = time.perf_counter()
        return self.torch.profiler.record_function(MARKER)

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        mark = [e for e in events if e.name() == MARKER]
        if not mark:
            raise RuntimeError("the profiler lost the window's marker")
        main_tid = mark[0].start_thread_id()
        self.offset_ns = _ns(mark[0], "start") - int(self.t0_perf * 1e9)
        for e in events:
            start = _ns(e, "start")
            end = start + int(e.duration_ns()) if hasattr(e, "duration_ns") \
                else _ns(e, "end")
            if e.name() == MARKER or (hasattr(e, "is_user_annotation")
                                      and e.is_user_annotation()):
                continue
            if e.device_type() == DeviceType.CUDA:
                self.device.append((start, end, e.name()))
            elif e.start_thread_id() == main_tid:
                self.host.append((start, end, e.name()))
        return False

    def to_trace_ns(self, perf_s: float) -> int:
        return int(perf_s * 1e9) + self.offset_ns

    def busy_seconds(self, t0: float, t1: float) -> float:
        """Device busy seconds inside ``[t0, t1]`` (perf_counter seconds)."""
        lo, hi = self.to_trace_ns(t0), self.to_trace_ns(t1)
        clipped = [(max(a, lo), min(b, hi)) for a, b, _ in self.device
                   if b > lo and a < hi]
        return union_seconds(clipped)

    def breakdown(self, t0: float, t1: float, spans: List[dict],
                  top: int = 10) -> Dict[str, list]:
        """Device time by operation, and idle time by what the client
        thread was doing: ``<journal span>|<host operator>``."""
        lo, hi = self.to_trace_ns(t0), self.to_trace_ns(t1)
        by_op: Dict[str, float] = defaultdict(float)
        inside = []
        for a, b, name in self.device:
            if b > lo and a < hi:
                a, b = max(a, lo), min(b, hi)
                by_op[name[:120]] += (b - a) / 1e9
                inside.append((a, b))
        gaps, cursor = [], lo
        for a, b in merged(inside):
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            gaps.append((cursor, hi))
        span_iv = [(self.to_trace_ns(s["ts"]),
                    self.to_trace_ns(s["ts"] + s["dur"]), s["name"])
                   for s in spans]
        by_gap: Dict[str, float] = defaultdict(float)
        span_at = _Innermost(span_iv)
        host_at = _Innermost([(a, b, n) for a, b, n in self.host])
        for a, b in gaps:
            mid = (a + b) // 2
            label = (f"{span_at.at(mid) or 'client'}|"
                     f"{host_at.at(mid) or 'python'}")
            by_gap[label[:160]] += (b - a) / 1e9

        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(by_op), "idle_gaps": head(by_gap)}


class _Innermost:
    """Name of the innermost interval containing a point, for intervals
    that nest (spans and operators of one thread)."""

    def __init__(self, intervals: Sequence[Tuple[int, int, str]]):
        self.iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.iv]
        self.parent = []
        stack: List[int] = []
        for i, (a, b, _) in enumerate(self.iv):
            while stack and self.iv[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.iv[i][1] < t:
            i = self.parent[i]
        return self.iv[i][2] if i >= 0 else None
