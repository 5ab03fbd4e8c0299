"""Push-based pipeline executor (paper §3.2.2) — counterpart of ``repro/core/executor.py``.

The plan is decomposed into **pipelines** at breakers (join build side,
aggregation, sort).  Each pipeline is a task on a global queue; worker
threads pull tasks whose dependencies have completed and drive them.
Within a pipeline execution is **push-based**: the executor owns all state
(build tables, partial agg inputs) and pushes morsels into stateless
operator callables.

Two modes, as the reference's ``compile_pipelines=False`` path has them:

* **default** — every operator runs eagerly and queues its device work
  without waiting; the query's one barrier is at the final sink;
* **profile=True** (per engine) — a barrier and a timer after every
  operator, accumulated per category in ``op_times`` for the Figure-5
  breakdown.

Compiled pipelines, the plan cache, ``accelerate`` and EXPLAIN ANALYZE are
later slices of the port; ``SiriusEngine.sql`` runs SQL text through the
frontend and optimizer.  All worker threads launch on the device's
current stream, so the device runs their work in submission order.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..buffer.manager import BufferManager
from ..observability.metrics import METRICS
from ..relational.aggregate import group_aggregate
from ..relational.expressions import Expr, Lit, evaluate
from ..relational.join import hash_join
from ..relational.sort import sort_table
from ..relational.table import Table
from . import instrument
from .plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SortRel, walk,
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
        raise TypeError(f"cannot lower {type(rel)}")

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


class PipelineExecutor:
    """Global task queue + worker threads pulling ready pipelines."""

    def __init__(self, buffers: BufferManager, num_workers: int = 2,
                 morsel_rows: Optional[int] = None, backend=None,
                 profile: bool = False):
        self.buffers = buffers
        self.num_workers = num_workers
        self.morsel_rows = morsel_rows
        self.backend = backend
        self.profile = profile
        self.op_times: Dict[str, float] = defaultdict(float)

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

    def execute(self, plan: Rel) -> Table:
        """Run ``plan`` (mutates it: scalar subqueries become literals)."""
        t0 = time.perf_counter()
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
        n_workers = 1 if self.profile else self.num_workers

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
        if out is not None and not self.profile:
            # the query's single host wait: materialize the result table
            instrument.barrier(self.device)
        METRICS.histogram("executor.query_seconds").observe(
            time.perf_counter() - t0)
        return out

    # -- single pipeline ------------------------------------------------------
    def _source_table(self, source) -> Table:
        if isinstance(source, ReadRel):
            t = self.buffers.get(source.table)
            if source.filter is not None:
                t0 = time.perf_counter()
                out = (self.backend.try_filter(source.filter, t)
                       if self.backend is not None else None)
                if out is None:
                    mask = evaluate(source.filter, t)
                    out = t.filter_mask(mask.data)
                t = out
                if self.profile:
                    instrument.barrier(self.device)
                    self.op_times["filter"] += time.perf_counter() - t0
            if source.columns:
                t = t.select([c for c in source.columns if c in t])
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
        with instrument.pipeline_scope():
            src = self._source_table(p.source)
            approx_bytes = max(src.nbytes, 1)
            self.buffers.alloc_processing(approx_bytes)
            try:
                if self.profile:
                    self._run_profiled(p, src)
                    return
                # default path: eager operators, asynchronous device work —
                # downstream pipelines consume the sink's tensors without a
                # barrier; the single wait is at the query's final sink
                for morsel in self._morsels(src):
                    t = morsel
                    for op in p.ops:
                        t = op(t)
                    p.sink.push(t)
                p.sink.finalize()
            finally:
                self.buffers.free_processing(approx_bytes)

    def _run_profiled(self, p: Pipeline, src: Table) -> None:
        """Eager per-op dispatch with a barrier + timer per operator, feeding
        the Figure-5 breakdown (``op_times`` by category)."""
        for morsel in self._morsels(src):
            t = morsel
            for op in p.ops:
                t0 = time.perf_counter()
                t = op(t)
                instrument.barrier(self.device)
                self.op_times[op.category] += time.perf_counter() - t0
            t0 = time.perf_counter()
            p.sink.push(t)
            self.op_times[p.sink.category] += time.perf_counter() - t0
        t0 = time.perf_counter()
        p.sink.finalize()
        if p.sink.result.table is not None:
            instrument.barrier(self.device)
        self.op_times[p.sink.category] += time.perf_counter() - t0


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
    plain version."""

    def __init__(self, caching_bytes: int = 8 << 30, processing_bytes: int = 8 << 30,
                 num_workers: int = 2, morsel_rows: Optional[int] = None,
                 use_kernels: bool = False, profile: bool = False,
                 device=None):
        self.device = torch.device(device) if device is not None else default_device()
        self.buffers = BufferManager(caching_bytes, processing_bytes, self.device)
        backend = None
        if use_kernels:
            from .kernel_backend import KernelBackend
            backend = KernelBackend()
        self.backend = backend
        self.executor = PipelineExecutor(self.buffers, num_workers, morsel_rows,
                                         backend, profile=profile)
        # host-side string dictionaries harvested at registration — kept
        # instead of the Tables themselves so the buffer manager stays free
        # to spill device columns
        self.table_dictionaries: Dict[str, Dict[str, object]] = {}

    def register(self, name: str, table: Table):
        """Cache ``table`` on the engine's device under ``name``."""
        self.buffers.cache_table(name, table)
        dicts = {c: col.dictionary for c, col in table.columns.items()
                 if col.dictionary is not None}
        if dicts:
            self.table_dictionaries[name] = dicts
        else:
            # re-registration may drop string columns; never leave stale
            # dictionaries steering the optimizer's selectivity estimates
            self.table_dictionaries.pop(name, None)

    def execute(self, plan: Rel) -> Table:
        return self.executor.execute(plan)

    def sql(self, text: str, catalog=None, optimize: bool = True) -> Table:
        """SQL text → parse → optimize → execute.

        The optimizer's catalog (default: TPC-H at SF 1) is enriched with
        the registered tables' string dictionaries, so LIKE / IN / prefix
        predicates are costed by their dictionary hit rate.  The reference's
        warm front door (plan cache), journal span and ``EXPLAIN ANALYZE``
        are not ported yet; ``EXPLAIN ANALYZE`` raises."""
        from ..sql import run_sql
        from ..sql.binder import DEFAULT_CATALOG
        cat = (catalog or DEFAULT_CATALOG).with_dictionaries(
            self.table_dictionaries)
        return run_sql(text, self, catalog=cat, optimize=optimize)
