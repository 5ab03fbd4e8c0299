"""Executable-plan cache: the warm path — counterpart of ``repro/core/plan_cache.py``.

Cold execution of a plan pays for work that has nothing to do with the data:
plan lowering, probe lowering (device-side build + eligibility pulls),
region first calls, and a host scalar sync for every dynamic cardinality
(filter counts, join output sizes, group counts).  For the steady-state
workload the paper targets — the same dashboard queries over registered,
immutable data — all of that is warm-path tax.

This module caches, per structural plan signature, an **executable plan**:
the lowered pipelines in topological order, each with its already-prepared
stage list (fused regions with build tables baked in as arguments) and the
sequence of scalar values the cold run pulled.  A warm run is then a loop
over closures: fetch source, run the prepared stages, finalize the sink —
with every ``pull_scalar`` served from the recording instead of a host
sync (see ``core.instrument``).  On the card, where no kernel backend is
attached, that loop is captured once as a CUDA graph and a warm run
replays the graph (``ExecutablePlan.compiled``).  The single host wait
left is the query's final barrier, after which the executor reads the
folded device-side ``value != recorded`` flags; any set flag (or a
structural ``ReplayMismatch``) invalidates the entry and re-runs cold.

Safety contract: registered data is immutable between ``register()`` calls,
and ``SiriusEngine.register`` clears this cache — so replayed cardinalities
are exact and the flags are a safety net, not a branch.  Pipelines whose
results are consumed *only* as fused-probe build arguments (captured into
region closures at prepare time) are skipped entirely on replay — re-running
them would produce tensors nothing reads.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

from ..observability.metrics import METRICS


# ---------------------------------------------------------------------------
# structural plan signatures
# ---------------------------------------------------------------------------


def _render(v, emit) -> None:
    # Generic structural rendering: covers Rel, Expr, AggSpec, SortKey and
    # ScalarSubquery uniformly (anything dataclass-shaped).  Never compares
    # with ``==`` — Expr.__eq__ builds BinOp nodes.
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        emit(type(v).__name__)
        emit("(")
        for f in dataclasses.fields(v):
            emit(f.name)
            emit("=")
            _render(getattr(v, f.name), emit)
            emit(",")
        emit(")")
    elif isinstance(v, (list, tuple)):
        emit("[" if isinstance(v, list) else "(")
        for x in v:
            _render(x, emit)
            emit(",")
        emit("]" if isinstance(v, list) else ")")
    elif isinstance(v, dict):
        emit("{")
        for k, x in sorted(v.items(), key=lambda kv: repr(kv[0])):
            emit(repr(k))
            emit(":")
            _render(x, emit)
            emit(",")
        emit("}")
    else:
        emit(repr(v))


def plan_signature(plan) -> str:
    """Deterministic structural key for a Rel tree (pre-``_prepare``).

    Computed over the *unprepared* plan: ``_prepare`` resolves scalar
    subqueries in place, and callers (benchmarks, ``engine.sql``) hand the
    executor fresh plan objects per run — the signature must match across
    them, so it is purely structural, never identity- or text-based.
    """
    parts: List[str] = []
    _render(plan, parts.append)
    return "".join(parts)


# ---------------------------------------------------------------------------
# cache entries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecordedPipeline:
    """One pipeline's precomputed dispatch slot in an executable plan.

    ``stages`` is the prepared callable list (fused regions + eager ops)
    from the cold run; ``values`` the scalar-pull recording; ``must_run``
    False marks dead replay work (results only live inside region
    closures); ``spans`` the journal span names of a run, named once."""

    pipeline: object              # core.executor.Pipeline
    stages: List
    values: List
    fuse_scan_filter: bool
    spans: object                 # core.executor._PipelineSpans
    must_run: bool = True


class ExecutablePlan:
    """A cached, replayable lowering of one plan (topological order)."""

    def __init__(self, pipelines: List[RecordedPipeline], final):
        self.pipelines = pipelines
        self.final = final            # the Pipeline owning the result sink
        self.hits = 0
        # whole-query replay as one CUDA graph
        # (PipelineExecutor._compile_replay), or None — on the CPU, with a
        # kernel backend, or where the capture failed — and the closure
        # loop then serves warm runs
        self.compiled = None
        # table-name → BufferManager epoch at record time; a replay is only
        # valid while every scanned table is still the recorded generation
        # (direct ``buffers.cache_table`` re-caches bump the epoch without
        # going through ``register``'s cache clear)
        self.epochs: Dict[str, int] = {}
        self._mark_must_run()

    def _mark_must_run(self) -> None:
        """Dead-work elimination for replay: a pipeline must run iff a
        *live* consumer reads its sink result at call time — as a pipeline
        source, or through an eager (unfused) ProbeOp's build_ref.  Fused
        probes captured the padded build arrays at prepare time, so their
        build pipelines are pure dead work warm.  Processed in reverse
        topological order so skipping propagates upstream."""
        from .executor import ProbeOp

        producer: Dict[int, int] = {
            id(rp.pipeline.sink.result): i
            for i, rp in enumerate(self.pipelines)}
        for rp in self.pipelines:
            rp.must_run = rp.pipeline is self.final
        for i in range(len(self.pipelines) - 1, -1, -1):
            rp = self.pipelines[i]
            if not rp.must_run:
                continue
            j = producer.get(id(rp.pipeline.source))
            if j is not None:
                self.pipelines[j].must_run = True
            for stage in rp.stages:
                if isinstance(stage, ProbeOp):
                    j = producer.get(id(stage.build_ref))
                    if j is not None:
                        self.pipelines[j].must_run = True


class PlanCache:
    """LRU map: plan signature → ExecutablePlan (cleared on register())."""

    def __init__(self, max_entries: int = 256, metrics=None):
        self.max_entries = max_entries
        # instance-scoped registry (a per-engine one, mirrored into the
        # process-global METRICS); defaults to METRICS itself
        self.metrics = metrics if metrics is not None else METRICS
        self._entries: "OrderedDict[str, ExecutablePlan]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
                      "invalidations": 0, "replay_mismatches": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, sig: str) -> Optional[ExecutablePlan]:
        entry = self._entries.get(sig)
        if entry is None:
            self.stats["misses"] += 1
            self.metrics.counter("plan_cache.misses").inc()
            return None
        self._entries.move_to_end(sig)
        self.stats["hits"] += 1
        entry.hits += 1
        self.metrics.counter("plan_cache.hits").inc()
        return entry

    def store(self, sig: str, entry: ExecutablePlan) -> None:
        self._entries[sig] = entry
        self._entries.move_to_end(sig)
        self.stats["inserts"] += 1
        self.metrics.counter("plan_cache.inserts").inc()
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats["evictions"] += 1
            self.metrics.counter("plan_cache.evictions").inc()

    def invalidate(self, sig: str, mismatch: bool = False) -> None:
        if self._entries.pop(sig, None) is not None:
            self.stats["invalidations"] += 1
            self.metrics.counter("plan_cache.invalidations").inc()
        if mismatch:
            self.stats["replay_mismatches"] += 1
            self.metrics.counter("plan_cache.replay_mismatches").inc()

    def clear(self) -> None:
        if self._entries:
            self.stats["invalidations"] += len(self._entries)
            self.metrics.counter("plan_cache.invalidations").inc(
                len(self._entries))
        self._entries.clear()
