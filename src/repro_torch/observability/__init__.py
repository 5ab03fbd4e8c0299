"""Query telemetry for the port — counterpart of ``repro/observability``.

* ``journal`` + ``dist`` — the always-on, query-ID-keyed event journal
  (thread-safe ring buffer, JSONL sink, trace-context propagation, Chrome
  trace export) and the span-tree tools over its events;
* ``tracer`` — nested context-manager spans, a no-op when disabled;
* ``metrics`` — the process-wide registry of counters, gauges and
  histograms;
* ``profile`` — the ``QueryProfile`` an analyzed query leaves
  (``engine.execute(plan, analyze=True)``, ``engine.sql(q, analyze=True)``,
  ``EXPLAIN ANALYZE``, ``engine.accelerate(wire, analyze=True)``): per
  pipeline and operator wall time and rows, the compile/execute split,
  per-query counter deltas, versioned JSON and diffing.  Its schema is the
  reference's, so the reference's tools read it unchanged.
"""
from .journal import (
    JOURNAL, JOURNAL_SCHEMA_VERSION, JournalSpan, QueryJournal, TraceContext,
    to_chrome,
)
from .metrics import METRICS, MetricsRegistry, aggregate_labeled
from .profile import (
    PROFILE_SCHEMA_VERSION, OperatorProfile, PipelineProfile, ProfileBuilder,
    QueryProfile, diff_profiles, validate_profile,
)
from .tracer import TRACER, Span, SpanTracer

__all__ = [
    "JOURNAL", "JOURNAL_SCHEMA_VERSION", "JournalSpan", "METRICS",
    "MetricsRegistry", "OperatorProfile", "PROFILE_SCHEMA_VERSION",
    "PipelineProfile", "ProfileBuilder", "QueryJournal", "QueryProfile",
    "Span", "SpanTracer", "TRACER", "TraceContext", "aggregate_labeled",
    "diff_profiles", "to_chrome", "validate_profile",
]
