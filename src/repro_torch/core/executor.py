"""Push-based pipeline executor (paper §3.2.2) — counterpart of ``repro/core/executor.py``.

The plan is decomposed into **pipelines** at breakers (join build side,
aggregation, sort).  Each pipeline is a task on a global queue; worker
threads pull tasks whose dependencies have completed and drive them.
Within a pipeline execution is **push-based**: the executor owns all state
(build tables, partial agg inputs) and pushes morsels into stateless
operator callables.

Execution modes, as the reference has them:

* **default** (``compile_pipelines=True``) — the executable-plan cache
  (``core.plan_cache``) owns the path.  A cold run lowers the plan, fuses
  each pipeline's Filter/Select/Project/Probe chain into mask-mode regions
  (``core.pipeline_compiler``), runs the pipelines in topological order on
  the calling thread and records every scalar it pulls.  A warm run
  replays the recording: no lowering, no probe builds, no scalar syncs,
  one barrier.  Where no kernel backend is attached, the warm replay on the
  card is one CUDA graph, captured at record time (the reference compiles
  it into one XLA program); elsewhere the closure loop replays it;
* **compile_pipelines=False**, or ``morsel_rows`` — the uncached path:
  worker threads run the pipelines (fused regions when compiling, every
  operator eagerly otherwise) and the query's one barrier is at the final
  sink;
* **analyze=True** (per call) — the same fused regions on the uncached
  path, with a barrier and a timer after every stage, so each stage's wall
  time and rows in and out land in a ``QueryProfile``
  (``executor.last_profile``).  Pipelines run one at a time, so operator
  wall clocks never overlap and sum to at most the query's total; the
  plan cache is bypassed and no entry is recorded or dropped;
* **profile=True** (per engine) — every operator eagerly, with a barrier
  and a timer after each, accumulated per category in ``op_times`` for the
  Figure-5 breakdown and recorded into a ``QueryProfile`` as well.

Every call lands in the query journal (``observability.journal``): a
top-level call roots a query tree, a nested one (a scalar subquery, a call
under ``sql`` or ``accelerate``) is a child span, and the plan cache's
record, replay and poisoning are spans and events of it.  The drop-in
front door ``SiriusEngine.accelerate`` takes a Substrait-style wire plan
(``repro_torch.substrait``).  All worker threads launch on the device's
current stream, so the device runs their work in submission order.
Unlike the reference, a warm replay that fails with anything but
``ReplayMismatch`` raises instead of re-running cold, and
``execute_with_fallback`` degrades to the host only when the plan cannot
be lowered (``PlanNotLowerable``): a launch or build error is never
hidden.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..buffer.manager import BufferManager
from ..kernels import build as kbuild
from ..observability import (
    JOURNAL, METRICS, OperatorProfile, PipelineProfile, ProfileBuilder,
    QueryProfile,
)
from ..relational.aggregate import group_aggregate
from ..relational.expressions import Expr, Lit, evaluate
from ..relational.join import hash_join
from ..relational.sort import sort_table
from ..relational.table import Column, Table
from . import instrument
from .pipeline_compiler import FusedSegment, PipelineCompiler
from .plan_cache import ExecutablePlan, PlanCache, RecordedPipeline, plan_signature
from .plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SortRel, explain, walk,
)


# ---------------------------------------------------------------------------
# operators (stateless; executor pushes morsels through them)
# ---------------------------------------------------------------------------


class _Op:
    category = "other"

    def __call__(self, t: Table) -> Table:  # pragma: no cover - interface
        raise NotImplementedError


class FilterOp(_Op):
    category = "filter"

    def __init__(self, cond: Expr, backend=None):
        self.cond = cond
        self.backend = backend

    def __call__(self, t: Table) -> Table:
        if self.backend is not None:
            out = self.backend.try_filter(self.cond, t)
            if out is not None:
                return out
        mask = evaluate(self.cond, t)
        return t.filter_mask(mask.data)


class ProjectOp(_Op):
    category = "project"

    def __init__(self, exprs, keep_input=False):
        self.exprs = exprs
        self.keep_input = keep_input

    def __call__(self, t: Table) -> Table:
        cols = dict(t.columns) if self.keep_input else {}
        for name, e in self.exprs:
            cols[name] = evaluate(e, t)
        return Table(cols)


class SelectOp(_Op):
    """Column pruning as a pipeline op (deferred ReadRel projection: the
    scan keeps filter columns alive until the fused filter consumed them)."""

    category = "project"

    def __init__(self, columns):
        self.columns = list(columns)

    def __call__(self, t: Table) -> Table:
        return t.select([c for c in self.columns if c in t])


class ProbeOp(_Op):
    """Probe side of a hash join; the build table is executor state."""

    category = "join"

    def __init__(self, rel: JoinRel, build_ref: "_Result", backend=None):
        self.rel = rel
        self.build_ref = build_ref
        self.backend = backend

    def __call__(self, t: Table) -> Table:
        out = None
        if self.backend is not None:
            out = self.backend.try_probe(
                t, self.build_ref.table, self.rel.probe_keys,
                self.rel.build_keys, self.rel.how)
        if out is None:
            out = hash_join(
                t, self.build_ref.table, self.rel.probe_keys,
                self.rel.build_keys, self.rel.how, self.rel.mark_name,
                backend=self.backend,
            )
        if self.rel.post_filter is not None:
            mask = evaluate(self.rel.post_filter, out)
            out = out.filter_mask(mask.data)
        return out


# ---------------------------------------------------------------------------
# sinks (pipeline breakers)
# ---------------------------------------------------------------------------


class _Result:
    """Cross-pipeline handle for a breaker's materialized output."""

    def __init__(self):
        self.table: Optional[Table] = None


class _Sink:
    category = "other"

    def __init__(self, result: _Result):
        self.result = result
        self.parts: List[Table] = []

    def push(self, t: Table) -> None:
        self.parts.append(t)

    def reset(self) -> None:
        """Clear pushed parts for a plan-cache replay; the ``_Result``
        handle keeps its identity (downstream pipelines hold references)."""
        self.parts = []

    def _gathered(self) -> Table:
        return self.parts[0] if len(self.parts) == 1 else Table.concat(self.parts)

    def finalize(self) -> None:
        self.result.table = self._gathered()


class BuildSink(_Sink):
    category = "join"


class AggSink(_Sink):
    category = "groupby"

    def __init__(self, result: _Result, rel: AggregateRel, backend=None):
        super().__init__(result)
        self.rel = rel
        self.backend = backend

    def finalize(self) -> None:
        t = self._gathered()
        out = None
        if self.backend is not None:
            out = self.backend.try_aggregate(t, self.rel.group_keys,
                                             self.rel.aggs)
        if out is None:
            out = group_aggregate(t, self.rel.group_keys, self.rel.aggs)
        if self.rel.having is not None:
            mask = evaluate(self.rel.having, out)
            out = out.filter_mask(mask.data)
        self.result.table = out


class SortSink(_Sink):
    category = "orderby"

    def __init__(self, result: _Result, rel: SortRel, backend=None):
        super().__init__(result)
        self.rel = rel
        self.backend = backend

    def finalize(self) -> None:
        t = self._gathered()
        out = None
        if self.backend is not None:
            out = self.backend.try_topk(t, self.rel.keys, self.rel.limit)
        if out is None:
            out = sort_table(t, self.rel.keys, self.rel.limit)
        self.result.table = out


class FetchSink(_Sink):
    def __init__(self, result: _Result, count: int):
        super().__init__(result)
        self.count = count

    def finalize(self) -> None:
        self.result.table = self._gathered().head(self.count)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


class PlanNotLowerable(TypeError):
    """The device engine has no pipeline operator for a rel (WindowRel,
    SetRel).  Raised by ``PlanLowering`` before any pipeline of the plan
    runs; the only error ``execute_with_fallback`` degrades on."""


@dataclasses.dataclass
class Pipeline:
    pid: int
    source: object                 # ReadRel | _Result
    ops: List[_Op]
    sink: _Sink
    deps: List[int]


class PlanLowering:
    """Decompose a Rel tree into pipelines (breaker analysis)."""

    def __init__(self, backend=None):
        self.pipelines: List[Pipeline] = []
        self.backend = backend

    def new_pipeline(self, source, deps) -> Pipeline:
        p = Pipeline(len(self.pipelines), source, [], None, list(deps))
        self.pipelines.append(p)
        return p

    def lower(self, rel: Rel) -> Pipeline:
        """Returns the pipeline whose sink produces ``rel``'s output."""
        p = self._stream(rel)
        if p.sink is None:
            p.sink = _Sink(_Result())
        return p

    def _stream(self, rel: Rel) -> Pipeline:
        if isinstance(rel, ReadRel):
            return self.new_pipeline(rel, [])
        if isinstance(rel, FilterRel):
            p = self._stream(rel.input)
            p.ops.append(FilterOp(rel.condition, self.backend))
            return p
        if isinstance(rel, ProjectRel):
            p = self._stream(rel.input)
            p.ops.append(ProjectOp(rel.exprs, rel.keep_input))
            return p
        if isinstance(rel, ExchangeRel):
            # single-node: the exchange layer is bypassed entirely (§3.2.4)
            return self._stream(rel.input)
        if isinstance(rel, JoinRel):
            build_p = self._stream(rel.build)
            if build_p.sink is None:
                build_p.sink = BuildSink(_Result())
            probe_p = self._stream(rel.probe)
            probe_p.ops.append(ProbeOp(rel, build_p.sink.result, self.backend))
            probe_p.deps.append(build_p.pid)
            return probe_p
        if isinstance(rel, AggregateRel):
            child = self._stream(rel.input)
            if child.sink is None:
                child.sink = AggSink(_Result(), rel, self.backend)
            else:  # child already materialized; chain a fresh pipeline
                mid = self.new_pipeline(child.sink.result, [child.pid])
                mid.sink = AggSink(_Result(), rel, self.backend)
                child = mid
            return self.new_pipeline(child.sink.result, [child.pid])
        if isinstance(rel, SortRel):
            child = self._stream(rel.input)
            sink = SortSink(_Result(), rel, self.backend)
            child = self._attach_sink(child, sink)
            return self.new_pipeline(child.sink.result, [child.pid])
        if isinstance(rel, FetchRel):
            child = self._stream(rel.input)
            sink = FetchSink(_Result(), rel.count)
            child = self._attach_sink(child, sink)
            return self.new_pipeline(child.sink.result, [child.pid])
        raise PlanNotLowerable(f"cannot lower {type(rel)}")

    def _attach_sink(self, child: Pipeline, sink: _Sink) -> Pipeline:
        if child.sink is None:
            child.sink = sink
            return child
        mid = self.new_pipeline(child.sink.result, [child.pid])
        mid.sink = sink
        return mid


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class _GraphReplay:
    """A warm replay captured as one CUDA graph.

    ``outs`` are the result columns in graph memory (cloned out on every
    replay), ``flag`` the folded replay flags (None when the recording
    pulled no device scalar), ``launches`` the kernel launches the graph
    holds per kernel, and ``inputs`` table → column → (tensor, address) of
    what the graph reads (held, so the memory stays allocated)."""

    def __init__(self, graph, out_meta, outs, flag, launches, inputs):
        self.graph = graph
        self.out_meta = out_meta
        self.outs = outs
        self.flag = flag
        self.launches = launches
        self.inputs = inputs


class PipelineExecutor:
    """Global task queue + worker threads pulling ready pipelines."""

    def __init__(self, buffers: BufferManager, num_workers: int = 2,
                 morsel_rows: Optional[int] = None, backend=None,
                 profile: bool = False, compile_pipelines: bool = True,
                 metrics=None):
        self.buffers = buffers
        self.num_workers = num_workers
        self.morsel_rows = morsel_rows
        self.backend = backend
        self.profile = profile
        self.compile_pipelines = compile_pipelines
        # instance-scoped registry (a per-engine one mirrors into METRICS);
        # the process-global METRICS by default
        self.metrics = metrics if metrics is not None else METRICS
        self.compiler = PipelineCompiler()
        self.op_times: Dict[str, float] = defaultdict(float)
        # plans that ``SiriusEngine.execute_with_fallback`` ran on the host
        self.fallback_queries = 0
        # executable-plan cache: signature → recorded pipelines + prepared
        # stages + scalar-pull schedule (+ the captured graph on the card).
        # The hybrid router flips ``cache_enabled`` off around fragments
        # that read boundary tables: those change between accelerate()
        # calls under the same plan signature, which would poison replays
        self.plan_cache = PlanCache(metrics=self.metrics)
        self.cache_enabled = True
        self._exec_depth = 0
        # per-execute telemetry: first-call ("trace") time this query
        # incurred, how the plan cache resolved it and, for a warm run,
        # whether a graph or the closure loop replayed it
        self.last_compile_seconds = 0.0
        self.last_plan_signature: Optional[str] = None
        self.last_plan_cache_hit = False
        self.last_replay_mode: Optional[str] = None
        self.last_query_id: Optional[str] = None
        # EXPLAIN ANALYZE state: the live per-query collector (None on the
        # default path; its presence switches on the per-stage barriers),
        # whether the call asked for analyze, the pushed-down scan filter's
        # seconds of the pipeline being profiled, and the last QueryProfile
        self._builder: Optional[ProfileBuilder] = None
        self._analyze = False
        self._scan_filter_s = 0.0
        self.last_profile: Optional[QueryProfile] = None
        # CUDA graph captures that failed (their entries keep the closure
        # loop): the count, and the last error per plan signature
        self.capture_failures = 0
        self.capture_errors: Dict[str, str] = {}
        # one graph memory pool for every entry of this executor: graphs
        # replay one at a time and their results are cloned out at once,
        # so an entry's intermediates may reuse another's freed blocks.
        # The allocator drops a pool with its last graph, so a capture
        # after that takes a fresh pool (``_graphs`` holds the live ones)
        self._graph_pool = None
        self._graphs: "weakref.WeakSet[_GraphReplay]" = weakref.WeakSet()
        # the stream warm-up walks and captures run on: one for the
        # executor's life, since the allocator keeps freed blocks for reuse
        # on the stream that allocated them
        self._side_stream = None

    @property
    def device(self) -> torch.device:
        return self.buffers.device

    # -- scalar subqueries are resolved before pipeline lowering -------------
    def _resolve_subqueries(self, expr):
        if isinstance(expr, ScalarSubquery):
            sub = self.execute(expr.plan)
            val = sub[expr.column].data.cpu().numpy().reshape(-1)
            return Lit(float(val[0]) if val.dtype.kind == "f" else int(val[0]))
        if dataclasses.is_dataclass(expr) and isinstance(expr, Expr):
            for f in dataclasses.fields(expr):
                v = getattr(expr, f.name)
                if isinstance(v, Expr):
                    setattr(expr, f.name, self._resolve_subqueries(v))
                elif isinstance(v, (list, tuple)) and v and isinstance(v[0], tuple):
                    setattr(expr, f.name, [
                        tuple(self._resolve_subqueries(x) if isinstance(x, Expr) else x
                              for x in w) for w in v])
        return expr

    def _prepare(self, plan: Rel) -> None:
        for rel in walk(plan):
            for f in dataclasses.fields(rel):
                v = getattr(rel, f.name)
                if isinstance(v, Expr):
                    setattr(rel, f.name, self._resolve_subqueries(v))
                elif isinstance(v, list) and v and isinstance(v[0], tuple) and \
                        len(v[0]) == 2 and isinstance(v[0][1], Expr):
                    setattr(rel, f.name,
                            [(n, self._resolve_subqueries(e)) for n, e in v])
                elif isinstance(v, list):
                    for item in v:
                        if dataclasses.is_dataclass(item) and hasattr(item, "expr") \
                                and isinstance(getattr(item, "expr", None), Expr):
                            item.expr = self._resolve_subqueries(item.expr)

    def execute(self, plan: Rel, analyze: bool = False,
                query_text: Optional[str] = None) -> Table:
        """Run ``plan`` (a cold run mutates it: scalar subqueries become
        literals).  With ``analyze=True`` (or engine ``profile=True``) a
        ``QueryProfile`` is assembled on ``self.last_profile``; the default
        path takes no extra barrier and no per-stage timing.  Nested calls
        (scalar-subquery plans) go through the same path and cache, and
        record into the enclosing query's profile.

        Every call lands in the query journal: a top-level call with no
        ambient trace context roots a fresh query tree, a nested one is a
        child span of the enclosing query."""
        with JOURNAL.query_span("engine.execute") as jspan:
            return self._execute_journaled(plan, analyze, query_text, jspan)

    def _execute_journaled(self, plan: Rel, analyze: bool,
                           query_text: Optional[str], jspan) -> Table:
        t0 = time.perf_counter()
        owns_builder = (analyze or self.profile) and self._builder is None
        if owns_builder:
            self._builder = ProfileBuilder(
                query=query_text,
                engine={"use_kernels": self.backend is not None,
                        "compile_pipelines": self.compile_pipelines,
                        "profile_mode": self.profile,
                        "num_workers": self.num_workers})
            self._analyze = bool(analyze)
            metrics_before = self._metrics_snapshot()
            trace_b0 = self.compiler.stats["trace_seconds"]
        top_level = self._exec_depth == 0
        if top_level:
            self.last_plan_signature = None
            self.last_plan_cache_hit = False
            self.last_replay_mode = None
            trace_s0 = self.compiler.stats["trace_seconds"]
        self._exec_depth += 1
        try:
            # the plan cache owns the default path; analyzed, profiled and
            # morsel-driven runs and router-suspended fragments keep the
            # uncached pipeline executor
            use_cache = (self.cache_enabled and self.compile_pipelines
                         and self._builder is None and not self.profile
                         and not self.morsel_rows)
            if use_cache:
                out = self._execute_cached(plan)
            else:
                out = self._execute_inner(plan)
        finally:
            self._exec_depth -= 1
            if top_level:
                # trace time goes to the query that incurred it (a cold run
                # its first calls and capture; a warm replay 0)
                self.last_compile_seconds = (
                    self.compiler.stats["trace_seconds"] - trace_s0)
                self.last_query_id = jspan.query_id
                jspan.set(plan_cache_hit=self.last_plan_cache_hit,
                          compile_seconds=round(self.last_compile_seconds, 6),
                          **self.buffers.watermarks())
            if owns_builder:
                total = time.perf_counter() - t0
                builder, self._builder = self._builder, None
                self._analyze = False
                builder.plan_text = explain(plan)
                compile_s = self.compiler.stats["trace_seconds"] - trace_b0
                metrics = {k: v - metrics_before.get(k, 0)
                           for k, v in self._metrics_snapshot().items()}
                self.last_profile = builder.finalize(total, compile_s, metrics)
        self.metrics.histogram("executor.query_seconds").observe(
            time.perf_counter() - t0)
        return out

    def _metrics_snapshot(self) -> Dict[str, float]:
        """Point-in-time view of this engine's counters; the per-query
        deltas of two snapshots become ``QueryProfile.metrics``.  The key
        set is the reference's (kernel counters appear, as zero, without a
        kernel backend) plus the port's ``compiler.declines``."""
        from ..relational import strings
        snap: Dict[str, float] = {}
        for k, v in self.compiler.stats.items():
            snap[f"compiler.{k}"] = v
        hits = (self.backend.hit_counts() if self.backend is not None
                else {"filter": 0, "probe": 0, "agg": 0,
                      "expand": 0, "topk": 0})
        for k, v in hits.items():
            snap[f"kernel.{k}_hits"] = v
        for k, v in self.plan_cache.stats.items():
            snap[f"plan_cache.{k}"] = v
        b = self.buffers
        snap["buffers.cold_copy_bytes"] = b.cold_copy_bytes
        snap["buffers.host_transfer_bytes"] = b.host_transfer_bytes
        snap["buffers.boundary_to_host_bytes"] = b.boundary_to_host_bytes
        snap["buffers.boundary_to_device_bytes"] = b.boundary_to_device_bytes
        snap["buffers.processing_peak"] = b.processing_peak
        snap["executor.sync_barriers"] = instrument.sync_barriers.value
        snap["executor.scalar_syncs"] = instrument.scalar_syncs.value
        for k, v in strings.stats.items():
            snap[f"strings.{k}"] = v
        return snap

    # -- executable-plan cache -------------------------------------------------
    def _execute_cached(self, plan: Rel) -> Table:
        """Default-path entry: replay a cached executable plan, or run cold
        while recording one.  The signature is computed over the unprepared
        plan (``_prepare`` mutates it), so fresh plan objects for the same
        query hit the same entry.  Only ``ReplayMismatch`` sends a replay
        back to a cold run; any other error raises."""
        sig = plan_signature(plan)
        entry = self.plan_cache.lookup(sig)
        if entry is not None and not self._entry_fresh(entry):
            self.plan_cache.invalidate(sig)
            entry = None
        if entry is not None:
            try:
                out = self._replay_entry(entry)
                self.last_plan_signature = sig
                self.last_plan_cache_hit = True
                return out
            except instrument.ReplayMismatch as exc:
                JOURNAL.event("plan_cache.poison", "cache",
                              reason=type(exc).__name__)
                self.plan_cache.invalidate(sig, mismatch=True)
        with JOURNAL.span("plan_cache.record", "cache"):
            out = self._execute_recording(plan, sig)
        self.last_plan_signature = sig
        return out

    def _execute_recording(self, plan: Rel, sig: str) -> Table:
        """Cold run that assembles the executable plan as it goes.

        Pipelines run serially on the calling thread in creation order
        (``PlanLowering`` emits dependencies first, so that *is* a
        topological order): the scalar recording is thread-local and the
        replayed pull sequence must be deterministic."""
        self._prepare(plan)
        lowering = PlanLowering(self.backend)
        final = lowering.lower(plan)
        recorded = [self._run_pipeline_recorded(p) for p in lowering.pipelines]
        out = final.sink.result.table
        if out is not None:
            # the query's single host wait: materialize the result table
            instrument.barrier(self.device)
        entry = ExecutablePlan(recorded, final)
        entry.epochs = {
            p.source.table: self.buffers.table_epochs.get(p.source.table, 0)
            for p in lowering.pipelines if isinstance(p.source, ReadRel)}
        if self.backend is None:
            # as the reference compiles only where no kernel backend is
            # attached, so the port captures only there
            self._compile_replay(entry, sig)
        self._release(entry)
        self.plan_cache.store(sig, entry)
        return out

    def _run_pipeline_recorded(self, p: Pipeline) -> RecordedPipeline:
        ops = p.ops
        fuse_scan_filter = (self.backend is None and bool(p.ops)
                            and isinstance(p.source, ReadRel)
                            and p.source.filter is not None)
        if fuse_scan_filter:
            ops = [FilterOp(p.source.filter)]
            if p.source.columns:
                ops.append(SelectOp(p.source.columns))
            ops += list(p.ops)
        values: List = []
        with instrument.pipeline_scope():
            # probe lowering happens once, here; its eligibility pulls must
            # never join the replay schedule (warm runs skip prepare)
            with instrument.pulls_suspended():
                stages = self.compiler.prepare(ops, self.backend)
            with instrument.scalar_recording(values):
                src = self._source_table(p.source,
                                         skip_filter=fuse_scan_filter)
                approx_bytes = max(src.nbytes, 1)
                self.buffers.alloc_processing(approx_bytes)
                try:
                    t = src
                    for stage in stages:
                        t = stage(t)
                    p.sink.push(t)
                    p.sink.finalize()
                finally:
                    self.buffers.free_processing(approx_bytes)
        return RecordedPipeline(p, stages, values, fuse_scan_filter)

    def _replay_core(self, entry: ExecutablePlan, flags: List) -> Table:
        """Warm-path body: the loop over already-prepared closures.

        Runs as the closure loop and under CUDA graph capture
        (``_compile_replay``): everything inside must stay free of host
        syncs and host-to-device copies on the paths cached entries take."""
        for rp in entry.pipelines:
            if not rp.must_run:
                continue
            p = rp.pipeline
            p.sink.reset()
            with instrument.pipeline_scope():
                with instrument.scalar_replay(rp.values, flags):
                    src = self._source_table(p.source,
                                             skip_filter=rp.fuse_scan_filter)
                    approx_bytes = max(src.nbytes, 1)
                    self.buffers.alloc_processing(approx_bytes)
                    try:
                        t = src
                        for stage in rp.stages:
                            t = stage(t)
                        p.sink.push(t)
                        p.sink.finalize()
                        p.sink.reset()
                    finally:
                        self.buffers.free_processing(approx_bytes)
        out = entry.final.sink.result.table
        self._release(entry)
        return out

    @staticmethod
    def _release(entry: ExecutablePlan) -> None:
        """Drop the entry's hold on the results a replay recomputes once a
        run is over (under a capture the freed blocks go back to the graph
        pool for other entries' graphs).  The results of pipelines a replay
        skips stay: a segment whose region declined runs its probe eagerly
        against them."""
        for rp in entry.pipelines:
            rp.pipeline.sink.reset()
            if rp.must_run:
                rp.pipeline.sink.result.table = None

    def _compile_replay(self, entry: ExecutablePlan, sig: str) -> None:
        """Walk the warm replay once at record time and, on the card,
        capture it as one CUDA graph (the reference AOT-compiles it into
        one XLA program).

        The walk is the capture's warm-up: it runs on a side stream, so
        that memoized string host passes and first allocations happen
        outside the capture; on the CPU it is the whole step, and the
        closure loop serves warm runs.  A capture that fails leaves
        ``entry.compiled = None`` (the closure loop) and is counted in
        ``capture_failures``.  The time is attributed like a region's first
        call (``compiler.stats["trace_seconds"]``)."""
        t0 = time.perf_counter()
        try:
            side = None
            if self.device.type == "cuda":
                if self._side_stream is None:
                    self._side_stream = torch.cuda.Stream(self.device)
                side = self._side_stream
                side.wait_stream(torch.cuda.current_stream(self.device))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                self._replay_core(entry, [])
            if side is None:
                return
            try:
                entry.compiled = self._capture_replay(entry, side)
                self.metrics.counter("plan_cache.replay_captures").inc()
            except Exception as exc:  # noqa: BLE001 — the closure loop stays
                entry.compiled = None
                self.capture_failures += 1
                self.capture_errors[sig] = f"{type(exc).__name__}: {exc}"
                self.metrics.counter("plan_cache.capture_failures").inc()
        finally:
            dt = time.perf_counter() - t0
            self.compiler.stats["trace_seconds"] += dt
            self.metrics.histogram(
                "pipeline_compiler.trace_seconds").observe(dt)

    def _capture_replay(self, entry: ExecutablePlan,
                        stream: torch.cuda.Stream) -> _GraphReplay:
        if not self._graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
        inputs: Dict[str, Dict[str, tuple]] = {}
        for rp in entry.pipelines:
            src = rp.pipeline.source
            if rp.must_run and isinstance(src, ReadRel):
                inputs[src.table] = {
                    n: (c.data, c.data.data_ptr())
                    for n, c in self.buffers.get(src.table).columns.items()}
        graph = torch.cuda.CUDAGraph()
        launches0 = kbuild.launch_counts()
        flags: List = []
        # capture_begin/end on the warm-up's side stream, as torch.cuda.graph
        # does, but without its synchronize, gc.collect and empty_cache: the
        # warm-up walk has just run, and emptying the allocator's cache
        # would make the next query go back to cudaMalloc
        current = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._graph_pool)
                try:
                    out = self._replay_core(entry, flags)
                    flag = torch.stack(flags).any() if flags else None
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 — the first error is the one
                        pass
                    raise
                graph.capture_end()
            current.wait_stream(stream)
        finally:
            # the capture launched nothing: what it recorded runs, and is
            # counted, at each replay
            launches = {k: v - launches0[k]
                        for k, v in kbuild.launch_counts().items()}
            kbuild.add_launch_counts({k: -v for k, v in launches.items()})
        gr = _GraphReplay(
            graph, [(n, c.kind, c.dictionary) for n, c in out.columns.items()],
            [c.data for c in out.columns.values()], flag,
            {k: v for k, v in launches.items() if v}, inputs)
        self._graphs.add(gr)
        return gr

    def _replay_entry(self, entry: ExecutablePlan) -> Table:
        """The warm path.

        No parsing, no lowering, no probe builds, no scalar syncs: every
        ``pull_scalar`` is served from the recording and the device-side
        flags are read after the single final barrier.  A set flag means
        the data under a recorded cardinality changed: ``ReplayMismatch``,
        so the caller invalidates and re-runs cold.  An entry with a
        captured graph replays it; the rest run the closure loop.  Either
        way the replay is a journal span, whose wall time is the warm
        dispatch's."""
        mode = "graph" if entry.compiled is not None else "closure"
        with JOURNAL.span("plan_cache.replay", "cache", mode=mode):
            self.last_replay_mode = mode
            if entry.compiled is not None:
                return self._replay_graph(entry.compiled)
            return self._replay_closure(entry)

    def _replay_closure(self, entry: ExecutablePlan) -> Table:
        flags: List = []
        out = self._replay_core(entry, flags)
        flag = torch.stack(flags).any() if flags else None
        instrument.barrier(self.device)
        if flag is not None and instrument.read_after_barrier(flag):
            raise instrument.ReplayMismatch(
                "recorded scalar diverged on replay")
        return out

    def _replay_graph(self, gr: _GraphReplay) -> Table:
        for name, cols in gr.inputs.items():
            cur = self.buffers.get(name)   # a spilled table comes back here
            for col, (_, ptr) in cols.items():
                if cur[col].data.data_ptr() != ptr:
                    # promoted after a spill: the graph would read freed memory
                    raise instrument.ReplayMismatch(
                        f"{name}.{col} moved under its captured graph")
        gr.graph.replay()
        # the result columns are graph memory: a later replay must never
        # change a table a caller holds
        outs = [t.clone() for t in gr.outs]
        kbuild.add_launch_counts(gr.launches)
        instrument.barrier(self.device)
        if gr.flag is not None and instrument.read_after_barrier(gr.flag):
            raise instrument.ReplayMismatch(
                "recorded scalar diverged on replay")
        return Table({n: Column(t, kind, dct)
                      for (n, kind, dct), t in zip(gr.out_meta, outs)})

    def _entry_fresh(self, entry: ExecutablePlan) -> bool:
        """True while every table the entry scans is still the generation
        the recording read (epoch-checked so direct ``cache_table``
        re-caches, which bypass ``register``, invalidate replays too)."""
        return all(self.buffers.table_epochs.get(n, 0) == e
                   for n, e in entry.epochs.items())

    def replay_signature(self, sig: str) -> Optional[Table]:
        """Warm front door for the engine's SQL text cache: replay the
        entry under ``sig``, or return None (missing, stale or mismatched)
        so the caller takes its full parse path."""
        entry = self.plan_cache.lookup(sig)
        if entry is not None and not self._entry_fresh(entry):
            self.plan_cache.invalidate(sig)
            entry = None
        if entry is None:
            return None
        with JOURNAL.query_span("engine.execute", entry="warm") as jspan:
            try:
                out = self._replay_entry(entry)
            except instrument.ReplayMismatch as exc:
                JOURNAL.event("plan_cache.poison", "cache",
                              reason=type(exc).__name__)
                self.plan_cache.invalidate(sig, mismatch=True)
                return None
            self.last_plan_signature = sig
            self.last_plan_cache_hit = True
            self.last_compile_seconds = 0.0
            self.last_query_id = jspan.query_id
            jspan.set(plan_cache_hit=True, compile_seconds=0.0,
                      **self.buffers.watermarks())
        return out

    # -- the uncached path ------------------------------------------------------
    def _execute_inner(self, plan: Rel) -> Table:
        self._prepare(plan)
        lowering = PlanLowering(self.backend)
        final = lowering.lower(plan)
        pipelines = lowering.pipelines

        remaining = {p.pid: len(p.deps) for p in pipelines}
        dependents: Dict[int, List[int]] = defaultdict(list)
        for p in pipelines:
            for d in p.deps:
                dependents[d].append(p.pid)

        ready: "queue.Queue[Optional[int]]" = queue.Queue()
        for p in pipelines:
            if remaining[p.pid] == 0:
                ready.put(p.pid)

        done = threading.Event()
        errors: List[BaseException] = []
        lock = threading.Lock()
        finished = {"n": 0}

        # profiling serializes pipelines so per-operator wall clocks never
        # overlap (sum of operator times must stay <= query total)
        n_workers = 1 if self._builder is not None else self.num_workers

        def finish():
            # wake every idle worker at once (the reference polls its queue
            # every 20 ms, which put a 20 ms floor under every query)
            done.set()
            for _ in range(n_workers):
                ready.put(None)

        def worker():
            while not done.is_set():
                pid = ready.get()
                if pid is None:      # woken to exit: the query is done
                    return
                try:
                    self._run_pipeline(pipelines[pid])
                except BaseException as e:  # noqa: BLE001 — re-raised by execute
                    errors.append(e)
                    finish()
                    return
                with lock:
                    finished["n"] += 1
                    for dep in dependents[pid]:
                        remaining[dep] -= 1
                        if remaining[dep] == 0:
                            ready.put(dep)
                    if finished["n"] == len(pipelines):
                        finish()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        done.wait()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        out = final.sink.result.table
        if out is not None and not self.profile and not self._analyze:
            # the query's single host wait: materialize the result table
            instrument.barrier(self.device)
        return out

    # -- single pipeline ------------------------------------------------------
    def _source_table(self, source, skip_filter: bool = False) -> Table:
        if isinstance(source, ReadRel):
            t = self.buffers.get(source.table)
            if source.filter is not None and not skip_filter:
                t0 = time.perf_counter()
                out = (self.backend.try_filter(source.filter, t)
                       if self.backend is not None else None)
                if out is None:
                    mask = evaluate(source.filter, t)
                    out = t.filter_mask(mask.data)
                t = out
                if self._builder is not None:
                    instrument.barrier(self.device)
                    dt = time.perf_counter() - t0
                    # keeps the pushed-down filter attributable as "filter"
                    # in the profile (the scan record subtracts it)
                    self._scan_filter_s = dt
                    if self.profile:
                        self.op_times["filter"] += dt
            if source.columns:
                keep = [c for c in source.columns if c in t]
                if skip_filter and source.filter is not None:
                    # deferred filter: its columns ride along until the fused
                    # region applies the filter and the SelectOp prunes them
                    keep += [c for c in source.filter.columns()
                             if c in t and c not in keep]
                t = t.select(keep)
            return t
        if isinstance(source, _Result):
            assert source.table is not None, "dependency not materialized"
            return source.table
        raise TypeError(type(source))

    def _morsels(self, t: Table):
        if not self.morsel_rows or t.num_rows <= self.morsel_rows:
            yield t
            return
        for lo in range(0, t.num_rows, self.morsel_rows):
            hi = min(lo + self.morsel_rows, t.num_rows)
            yield t.take(torch.arange(lo, hi, device=t.device))

    def _run_pipeline(self, p: Pipeline) -> None:
        # pushed-down ReadRel filters join the fused region as its first op
        # (compiled, no kernel backend: the backend's filter kernel keeps
        # the eager route) — only worthwhile with downstream ops to fuse
        fuse_scan_filter = (not self.profile and self.compile_pipelines
                            and self.backend is None and bool(p.ops)
                            and isinstance(p.source, ReadRel)
                            and p.source.filter is not None)
        ops = p.ops
        if fuse_scan_filter:
            ops = [FilterOp(p.source.filter)]
            if p.source.columns:
                ops.append(SelectOp(p.source.columns))
            ops += list(p.ops)
        builder = self._builder
        with instrument.pipeline_scope():
            rec = None
            if builder is not None:
                rec = self._start_profiled_pipeline(p, builder)
                t0 = time.perf_counter()
            src = self._source_table(p.source, skip_filter=fuse_scan_filter)
            if builder is not None:
                instrument.barrier(self.device)
                self._record_scan(p, src, rec, builder,
                                  time.perf_counter() - t0)
            approx_bytes = max(src.nbytes, 1)
            self.buffers.alloc_processing(approx_bytes)
            try:
                if self.profile:
                    self._run_profiled(p, src, rec)
                    return
                # asynchronous device work: downstream pipelines consume the
                # sink's tensors without a barrier; the single wait is at
                # the query's final sink
                stages = (self.compiler.prepare(ops, self.backend)
                          if self.compile_pipelines else ops)
                if builder is not None:
                    self._run_analyzed(p, src, stages, rec, builder)
                    return
                for morsel in self._morsels(src):
                    t = morsel
                    for stage in stages:
                        t = stage(t)
                    p.sink.push(t)
                p.sink.finalize()
            finally:
                self.buffers.free_processing(approx_bytes)

    def _start_profiled_pipeline(self, p: Pipeline,
                                 builder: ProfileBuilder) -> PipelineProfile:
        self._scan_filter_s = 0.0
        label = (f"scan:{p.source.table}" if isinstance(p.source, ReadRel)
                 else "result")
        return builder.start_pipeline(label, list(p.deps))

    def _record_scan(self, p: Pipeline, src: Table, rec: PipelineProfile,
                     builder: ProfileBuilder, seconds: float) -> None:
        """The pipeline's source as its first operator: a base table's scan
        (rows in are the table's), split into the fetch and a pushed-down
        ``ReadRel`` filter where one ran, so the breakdown stays exact by
        category; a breaker's result otherwise."""
        label = rec.source
        base_rows = (self.buffers.get(p.source.table).num_rows
                     if isinstance(p.source, ReadRel) else src.num_rows)
        filt_s = self._scan_filter_s
        if filt_s > 0:
            builder.add_operator(rec, label, "scan", base_rows, base_rows,
                                 max(seconds - filt_s, 0.0))
            builder.add_operator(rec, "ReadFilter", "filter", base_rows,
                                 src.num_rows, filt_s)
        else:
            builder.add_operator(rec, label, "scan", base_rows, src.num_rows,
                                 seconds)

    @staticmethod
    def _stage_telemetry(stage):
        """Name, category and attributes of a pipeline stage, read *after*
        its timer stopped.  A fused region also reports its cache hit,
        whether it degraded to its eager ops, and its cost estimate
        (``est_flops`` / ``est_bytes``, ``_CompiledRegion.cost_summary``),
        computed here, outside the stage's wall-clock window."""
        if isinstance(stage, FusedSegment):
            info = stage.last_call_info or {}
            attrs = {}
            if "cache_hit" in info:
                attrs["cache_hit"] = bool(info["cache_hit"])
            if info.get("degraded"):
                attrs["degraded"] = True
            region = info.get("region")
            if region is not None and "cost_args" in info:
                attrs.update(region.cost_summary(*info["cost_args"]))
            return stage.describe(), "fused", attrs
        return type(stage).__name__, getattr(stage, "category", "other"), {}

    def _run_analyzed(self, p: Pipeline, src: Table, stages,
                      rec: PipelineProfile, builder: ProfileBuilder) -> None:
        """EXPLAIN ANALYZE: the *same* stages as the default path (fused
        regions included) plus a barrier and a timer per stage.  The extra
        barriers are the point: they pin wall time onto operators that
        asynchronous launches would otherwise smear into the final sink."""
        pushed = 0
        sink_s = 0.0
        for morsel in self._morsels(src):
            t = morsel
            for stage in stages:
                rows_in = t.num_rows
                t0 = time.perf_counter()
                t = stage(t)
                instrument.barrier(self.device)
                dt = time.perf_counter() - t0
                name, cat, attrs = self._stage_telemetry(stage)
                builder.add_operator(rec, name, cat, rows_in, t.num_rows, dt,
                                     **attrs)
            pushed += t.num_rows
            t0 = time.perf_counter()
            p.sink.push(t)
            sink_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        p.sink.finalize()
        out = p.sink.result.table
        if out is not None:
            instrument.barrier(self.device)
        sink_s += time.perf_counter() - t0
        builder.add_operator(rec, type(p.sink).__name__, p.sink.category,
                             pushed, out.num_rows if out is not None else 0,
                             sink_s)

    def _run_profiled(self, p: Pipeline, src: Table,
                      rec: Optional[PipelineProfile] = None) -> None:
        """Eager per-op dispatch with a barrier + timer per operator, feeding
        the Figure-5 breakdown (``op_times`` by category) and, where a
        profile builder is live, the query's ``QueryProfile``."""
        builder = self._builder
        pushed = 0
        sink_s = 0.0
        for morsel in self._morsels(src):
            t = morsel
            for op in p.ops:
                rows_in = t.num_rows
                t0 = time.perf_counter()
                t = op(t)
                instrument.barrier(self.device)
                dt = time.perf_counter() - t0
                self.op_times[op.category] += dt
                if builder is not None:
                    builder.add_operator(rec, type(op).__name__, op.category,
                                         rows_in, t.num_rows, dt)
            pushed += t.num_rows
            t0 = time.perf_counter()
            p.sink.push(t)
            dt = time.perf_counter() - t0
            self.op_times[p.sink.category] += dt
            sink_s += dt
        t0 = time.perf_counter()
        p.sink.finalize()
        out = p.sink.result.table
        if out is not None:
            instrument.barrier(self.device)
        dt = time.perf_counter() - t0
        self.op_times[p.sink.category] += dt
        sink_s += dt
        if builder is not None:
            builder.add_operator(rec, type(p.sink).__name__, p.sink.category,
                                 pushed, out.num_rows if out is not None else 0,
                                 sink_s)


# ---------------------------------------------------------------------------
# engine facade
# ---------------------------------------------------------------------------


def default_device() -> torch.device:
    """The card the engine runs on; there is no silent fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: SiriusEngine runs on the GPU; pass "
            "device='cpu' to run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


class SiriusEngine:
    """The public query engine: caches tables on the device, executes plans.

    ``device=None`` picks the current CUDA device and raises if there is
    none; tests pass ``device="cpu"``, where every kernel wrapper runs its
    plain version.  ``metrics`` is the engine's registry (a
    ``MetricsRegistry(parent=METRICS, label=...)`` mirrors into the
    process-wide one); ``METRICS`` itself by default."""

    def __init__(self, caching_bytes: int = 8 << 30, processing_bytes: int = 8 << 30,
                 num_workers: int = 2, morsel_rows: Optional[int] = None,
                 use_kernels: bool = False, profile: bool = False,
                 compile_pipelines: bool = True, device=None, metrics=None):
        self.device = torch.device(device) if device is not None else default_device()
        self.buffers = BufferManager(caching_bytes, processing_bytes, self.device)
        backend = None
        if use_kernels:
            from .kernel_backend import KernelBackend
            backend = KernelBackend()
        self.backend = backend
        self.metrics = metrics if metrics is not None else METRICS
        self.executor = PipelineExecutor(self.buffers, num_workers, morsel_rows,
                                         backend, profile=profile,
                                         compile_pipelines=compile_pipelines,
                                         metrics=self.metrics)
        # journal query ID of the most recent front-door call (sql,
        # accelerate, execute): how a caller finds its span tree in JOURNAL
        self.last_query_id: Optional[str] = None
        # QueryProfile of the most recent analyzed or profiled query
        self.last_profile: Optional[QueryProfile] = None
        # host-format copies of registered tables (``register``'s
        # ``host_data``): what host fragments and the fallback scan
        self.host_tables: Dict[str, dict] = {}
        # routing report of the most recent ``accelerate`` call
        self.last_accelerate_report: Optional[dict] = None
        # host-side string dictionaries harvested at registration — kept
        # instead of the Tables themselves so the buffer manager stays free
        # to spill device columns
        self.table_dictionaries: Dict[str, Dict[str, object]] = {}
        # warm front doors: normalized SQL text and canonical wire bytes map
        # to executable-plan signatures, skipping lexer, parser, binder and
        # optimizer (sql) or ingest and routing (accelerate) on a hit;
        # cleared with the plan cache on every register()
        self._sql_plan_sigs: Dict[str, str] = {}
        self._wire_plan_cache: Dict[bytes, tuple] = {}

    @property
    def compiler(self):
        """The signature-keyed region cache (its stats live here)."""
        return self.executor.compiler

    def register(self, name: str, table: Table,
                 host_data: Optional[dict] = None):
        """Cache ``table`` on the engine's device under ``name`` (tensors
        already on that device are held, not copied); ``host_data``, the
        same table in host format, is kept for host fragments.

        Registered data is the one thing allowed to change between
        queries: every cached executable plan, SQL key and wire key is
        dropped."""
        self.executor.plan_cache.clear()
        self._sql_plan_sigs.clear()
        self._wire_plan_cache.clear()
        self.buffers.cache_table(name, table)
        dicts = {c: col.dictionary for c, col in table.columns.items()
                 if col.dictionary is not None}
        if dicts:
            self.table_dictionaries[name] = dicts
        else:
            # re-registration may drop string columns; never leave stale
            # dictionaries steering the optimizer's selectivity estimates
            self.table_dictionaries.pop(name, None)
        if host_data is not None:
            self.host_tables[name] = host_data

    def execute(self, plan: Rel, analyze: bool = False,
                query_text: Optional[str] = None) -> Table:
        """Run ``plan``; with ``analyze=True`` (or ``profile=True``) its
        ``QueryProfile`` lands on ``self.last_profile``."""
        out = self.executor.execute(plan, analyze=analyze,
                                    query_text=query_text)
        self.last_query_id = self.executor.last_query_id
        if analyze or self.executor.profile:
            self.last_profile = self.executor.last_profile
        return out

    def sql(self, text: str, catalog=None, optimize: bool = True,
            analyze: bool = False):
        """SQL text → parse → optimize → execute.

        The optimizer's catalog (default: TPC-H at SF 1) is enriched with
        the registered tables' string dictionaries, so LIKE / IN / prefix
        predicates are costed by their dictionary hit rate.

        ``EXPLAIN ANALYZE <query>`` runs the query with per-operator
        telemetry and returns its ``QueryProfile`` instead of the result;
        ``analyze=True`` does the same but returns the result.  Either way
        the profile lands on ``self.last_profile``, and the analyzed run
        bypasses the plan cache.

        Repeated queries take the warm path: the normalized text keys an
        executable-plan signature, so a hit skips lexer, parser, binder,
        optimizer and lowering and replays the cached entry
        (``PipelineExecutor.replay_signature``)."""
        with JOURNAL.query_span("sql",
                                text=" ".join(text.split())[:200]) as jq:
            out = self._sql_impl(text, catalog, optimize, analyze)
            if jq.query_id is not None:
                self.last_query_id = jq.query_id
            return out

    def _sql_impl(self, text: str, catalog, optimize: bool, analyze: bool):
        from ..sql import EXPLAIN_ANALYZE_RE, run_sql, sql_to_plan
        from ..sql.binder import DEFAULT_CATALOG
        m = EXPLAIN_ANALYZE_RE.match(text)
        cacheable = (m is None and not analyze and catalog is None
                     and optimize)
        if cacheable:
            # (the reference keeps the space before a trailing ";", so
            # "... x ;" misses its cache; the port strips it)
            key = " ".join(text.split()).rstrip(";").rstrip()
            sig = self._sql_plan_sigs.get(key)
            if sig is not None:
                out = self.executor.replay_signature(sig)
                if out is not None:
                    return out
        cat = (catalog or DEFAULT_CATALOG).with_dictionaries(
            self.table_dictionaries)
        if m or analyze:
            if m:
                text = text[m.end():]
            plan = sql_to_plan(text, catalog=cat, optimize=optimize)
            out = self.execute(plan, analyze=True, query_text=text.strip())
            return self.last_profile if m else out
        out = run_sql(text, self, catalog=cat, optimize=optimize)
        if cacheable and self.executor.last_plan_signature is not None:
            self._sql_plan_sigs[key] = self.executor.last_plan_signature
        return out

    def accelerate(self, wire_plan, registry=None, analyze: bool = False):
        """The drop-in front door: execute a serialized Substrait-style plan.

        ``wire_plan`` is what an external host engine hands over — the wire
        dict produced by ``repro_torch.substrait.emit`` (or the reference's),
        or its JSON text/bytes.  The plan is ingested, split by the
        capability ``registry`` into maximal device fragments and host
        fragments (run on the numpy ``FallbackEngine``), and run with
        boundary transfers accounted through the buffer manager: an
        unsupported rel is a routed, reported placement, not an error.

        Returns a ``Table`` on the engine's device; the routing report
        (fragment placements, boundary bytes, ``device_rel_fraction``) is
        kept on ``self.last_accelerate_report``.

        Repeated wire plans take the warm path: the canonical wire bytes
        key an executable-plan signature (cached only when routing placed
        the whole plan on the device as one fragment), so a hit skips
        ingest and routing and replays the cached entry, as ``sql`` does.

        ``analyze=True`` runs each device fragment analyzed and leaves one
        merged ``QueryProfile`` on ``self.last_profile``: the device
        fragments' pipelines (sources prefixed ``frag<N>:``) and one opaque
        operator per host fragment; it bypasses the wire and plan caches."""
        with JOURNAL.query_span("wire") as jq:
            out = self._accelerate_impl(wire_plan, registry, analyze)
            if jq.query_id is not None:
                self.last_query_id = jq.query_id
            return out

    def _accelerate_impl(self, wire_plan, registry, analyze: bool):
        from ..substrait import HybridRouter, ingest, wire_bytes
        from ..substrait.router import host_to_device

        wire_key = None
        if registry is None and not analyze:
            try:
                if isinstance(wire_plan, bytes):
                    wire_key = wire_plan
                elif isinstance(wire_plan, str):
                    wire_key = wire_plan.encode("utf-8")
                else:
                    wire_key = wire_bytes(wire_plan)
            except (TypeError, ValueError):  # unkeyable plans just run cold
                wire_key = None
            cached = (self._wire_plan_cache.get(wire_key)
                      if wire_key is not None else None)
            if cached is not None:
                sig, report_template = cached
                out = self.executor.replay_signature(sig)
                if out is not None:
                    self.last_accelerate_report = dict(report_template,
                                                       plan_cache_hit=True)
                    return out

        # a cold run ingests afresh: execution resolves scalar subqueries
        # in place
        plan = ingest(wire_plan)
        t0 = time.perf_counter()
        result, report = HybridRouter(self, registry).execute(
            plan, analyze=analyze)
        if (wire_key is not None and isinstance(result, Table)
                and report["host_fragments"] == 0
                and report["device_fragments"] == 1
                and self.executor.last_plan_signature is not None):
            # one all-device fragment: the executor's entry covers the
            # whole plan, so the routing report is replayable verbatim
            self._wire_plan_cache[wire_key] = (
                self.executor.last_plan_signature, dict(report))
        if not isinstance(result, Table):
            # host-rooted plan: the result itself crosses to the device
            result = host_to_device(result, self.device)
            self.buffers.account_boundary_to_device(result.nbytes)
            report["boundary_to_device_bytes"] += result.nbytes
        self.last_accelerate_report = report
        if analyze:
            self.last_profile = self._merge_fragment_profiles(
                report, plan, time.perf_counter() - t0)
        return result

    def _merge_fragment_profiles(self, report: dict, plan: Rel,
                                 total_seconds: float) -> QueryProfile:
        """Stitch the fragments' profiles of an analyzed ``accelerate`` run
        into one ``QueryProfile``.  Device fragments contribute their
        pipelines (sources prefixed ``frag<N>:``); a host fragment is one
        opaque operator, since the numpy engine has no operator clock."""
        pipelines: List[PipelineProfile] = []
        compile_s = 0.0
        metrics: Dict[str, float] = {}
        for frag in report["fragments"]:
            prof = frag.pop("_profile", None)
            fid = frag["fid"]
            if prof is not None:
                compile_s += prof.compile_seconds
                for k, v in prof.metrics.items():
                    metrics[k] = metrics.get(k, 0) + v
                for p in prof.pipelines:
                    pipelines.append(PipelineProfile(
                        len(pipelines), f"frag{fid}:{p.source}", [],
                        list(p.operators)))
            else:
                rec = PipelineProfile(len(pipelines), f"frag{fid}:host", [])
                rec.operators.append(OperatorProfile(
                    "HostFragment", "other", 0,
                    int(frag.get("rows_out", 0)),
                    float(frag.get("seconds", 0.0))))
                pipelines.append(rec)
        totals: Dict[str, float] = {}
        for p in pipelines:
            for op in p.operators:
                totals[op.category] = totals.get(op.category, 0.0) + op.seconds
        compile_s = min(max(compile_s, 0.0), total_seconds)
        return QueryProfile(
            query=None,
            engine={"accelerate": True,
                    "use_kernels": self.backend is not None,
                    "compile_pipelines": self.executor.compile_pipelines},
            total_seconds=float(total_seconds),
            compile_seconds=float(compile_s),
            execute_seconds=float(max(total_seconds - compile_s, 0.0)),
            pipelines=pipelines, operator_totals=totals, metrics=metrics,
            plan=explain(plan), fragments=list(report["fragments"]))

    def execute_with_fallback(self, plan: Rel):
        """Run on the device engine; a plan it cannot lower runs on the
        host ``FallbackEngine`` over ``host_tables`` instead.

        Returns ``(result, route)``: a device ``Table`` and
        ``"accelerator"``, or a host dict and ``"fallback"`` (counted in
        ``executor.fallback_queries``).  Unlike the reference, which
        degrades on any exception, only ``PlanNotLowerable`` (raised before
        any pipeline of the plan runs) degrades: a kernel build or launch
        error, or a CUDA error, propagates."""
        try:
            return self.execute(plan), "accelerator"
        except PlanNotLowerable:
            from .fallback import FallbackEngine
            self.executor.fallback_queries += 1
            return FallbackEngine(self.host_tables).execute(plan), "fallback"
