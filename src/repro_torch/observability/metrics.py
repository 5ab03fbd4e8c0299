"""Process-wide metrics registry: counters, gauges, histograms.

This is the single sink for the instrumentation that previously lived as
scattered ad-hoc dicts and attributes: the pipeline compiler's
signature-cache hits/misses and trace wall time, the kernel backend's
kernel-vs-fallback hit counts, ``instrument``'s host-transfer and
sync-barrier counts, the buffer manager's cold/boundary byte ledgers, the
hybrid router's fragment placements, and the distributed runner's phase
timers.  Those subsystems keep their cheap per-object counters (tests
assert on them per-engine) and *publish* into this registry, which is what
``QueryProfile`` snapshots per query and what a future serving layer will
scrape.

All three instrument types are thread-safe (one lock per instrument; the
registry itself locks only on instrument creation) and support ``float``
increments, so wall-clock seconds can accumulate in counters.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing value (int or float)."""

    def __init__(self, name: str, mirror: Optional["Counter"] = None):
        self.name = name
        self.mirror = mirror
        self._lock = threading.Lock()
        self._value: Number = 0

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n
        if self.mirror is not None:
            self.mirror.inc(n)

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins value."""

    def __init__(self, name: str, mirror: Optional["Gauge"] = None):
        self.name = name
        self.mirror = mirror
        self._lock = threading.Lock()
        self._value: Number = 0

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v
        if self.mirror is not None:
            self.mirror.set(v)

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value


class Histogram:
    """Streaming summary (count/sum/min/max) — enough for latency telemetry
    without bucket-boundary bikeshedding; percentiles belong to the future
    serving layer's scraper."""

    def __init__(self, name: str, mirror: Optional["Histogram"] = None):
        self.name = name
        self.mirror = mirror
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: Number) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
        if self.mirror is not None:
            self.mirror.observe(v)

    def summary(self) -> Dict[str, Number]:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max}


class MetricsRegistry:
    """Create-or-get instruments by dotted name (``compiler.cache_hits``).

    A registry may be **scoped**: constructed with a ``parent`` registry
    and a ``label`` prefix, every instrument mirrors its updates into the
    parent under ``<label>.<name>``.  The distributed runner gives each
    pooled shard engine its own registry labeled ``distributed.shard<i>``
    so shard metrics stop colliding in one flat namespace, while the
    process-global view survives as labeled series in ``METRICS`` that
    ``aggregate_labeled`` can roll back up."""

    def __init__(self, parent: Optional["MetricsRegistry"] = None,
                 label: Optional[str] = None):
        if (parent is None) != (label is None):
            raise ValueError("parent and label must be given together")
        self.parent = parent
        self.label = label
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _mirror_name(self, name: str) -> str:
        return f"{self.label}.{name}"

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                mirror = (self.parent.counter(self._mirror_name(name))
                          if self.parent is not None else None)
                c = self._counters[name] = Counter(name, mirror=mirror)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                mirror = (self.parent.gauge(self._mirror_name(name))
                          if self.parent is not None else None)
                g = self._gauges[name] = Gauge(name, mirror=mirror)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                mirror = (self.parent.histogram(self._mirror_name(name))
                          if self.parent is not None else None)
                h = self._histograms[name] = Histogram(name, mirror=mirror)
            return h

    def snapshot(self) -> Dict[str, Number]:
        """Flat point-in-time view: counters/gauges by name, histograms
        expanded to ``name.count`` / ``name.sum`` / ``name.min`` / ``name.max``."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        out: Dict[str, Number] = {}
        for name, c in counters:
            out[name] = c.value
        for name, g in gauges:
            out[name] = g.value
        for name, h in hists:
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out

    @staticmethod
    def delta(before: Dict[str, Number],
              after: Dict[str, Number]) -> Dict[str, Number]:
        """Per-interval view of two snapshots (new keys count from zero).
        Gauges come through as differences too — snapshot pairs are a
        counter-oriented tool; read gauges from ``snapshot`` directly."""
        return {k: v - before.get(k, 0) for k, v in after.items()}

    def reset_for_tests(self) -> None:
        """Drop every instrument (tests only — production metrics are
        append-only by design)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def aggregate_labeled(snapshot: Dict[str, Number], family: str,
                      sep: str = ".") -> Dict[str, Number]:
    """Roll labeled series back up into one process-global view.

    Given a snapshot containing mirrored keys like
    ``distributed.shard0.compute_seconds`` / ``...shard1...``, an
    aggregation over family ``"distributed.shard"`` sums every
    ``<family><i>.<metric>`` into ``<metric>`` (histogram ``.min`` /
    ``.max`` take min/max instead of summing)."""
    import re

    pat = re.compile(rf"^{re.escape(family)}(\d+){re.escape(sep)}(.+)$")
    out: Dict[str, Number] = {}
    for key, v in snapshot.items():
        m = pat.match(key)
        if m is None:
            continue
        metric = m.group(2)
        if metric.endswith(".min"):
            out[metric] = min(out.get(metric, float("inf")), v)
        elif metric.endswith(".max"):
            out[metric] = max(out.get(metric, float("-inf")), v)
        else:
            out[metric] = out.get(metric, 0) + v
    return out


# The process-wide registry every subsystem publishes into.
METRICS = MetricsRegistry()
