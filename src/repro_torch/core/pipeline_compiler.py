"""Pipeline compiler: fuse contiguous op chains into one device region.

Counterpart of ``repro/core/pipeline_compiler.py``.  Each pipeline's
contiguous Filter/Select/Project/Probe chain becomes one region:

* **Mask-mode execution.**  Inside a region a table keeps a static row
  count; filters and probes narrow a validity mask instead of compacting.
  One ``kernels.ops.compact`` and one gather at the region's boundary
  materialize the survivors, and the surviving-row count is the region's
  one ``pull_scalar``.
* **Signature-keyed cache.**  Regions are cached across queries, keyed by
  the structural expression tree of every op plus the input columns'
  names, kinds, dtypes and dictionary identities.  Within a region, a new
  padding bucket (row counts rounded up to powers of two) or a new build
  table shape is a new *trace*, as a new shape is a new trace of the
  reference's ``jax.jit``; ``stats["traces"]`` and ``stats["cache_hits"]``
  count what the reference's count.  The body runs as eager torch: the
  bucket keys the count and the probe-side rows are not copied into it.
  On the card a warm replay of the whole query is one CUDA graph
  (``core.executor``), which is where this port fuses.
* **Probe lowering.**  An eligible hash probe (single int key; unique build
  keys for inner; inner/semi/anti/mark) becomes a static-shape lookup: the
  lookup table is built once, at prepare time, on the device.  Dense key
  domains get a sort-free direct-address build (``ops.direct_build``),
  sparse domains a sorted binary-search build, and with a kernel backend
  attached the probe launches the ``hash_probe`` kernel on int32 ranks.
* **Degradation.**  An op outside the fusion contract (left joins,
  multi-column keys, duplicate build keys…) splits the chain and runs
  eagerly between fused segments.  A region that declines on purpose (a
  probe key that is not an integer, ``UnfusableRegion``) runs its ops
  eagerly from then on, and ``stats["declines"]`` counts it; any other
  error in a region raises.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops
from ..observability.metrics import METRICS
from ..relational.expressions import Expr, evaluate
from ..relational.table import BOOL, DATE, NUMERIC, Column, Table, dtype_kind
from .instrument import pull_scalar

_bucket = kops.bucket_size
_pad = kops.pad_rows


class UnfusableRegion(TypeError):
    """A region's ops are outside the fusion contract for this input (the
    reference's deliberate trace abort); the segment runs them eagerly."""


def expr_signature(e) -> str:
    """Deterministic structural rendering of an expression tree.

    Part of the key of the region cache (structural, never ``==``:
    ``Expr.__eq__`` builds BinOp nodes)."""
    if e is None:
        return "_"
    if isinstance(e, Expr) and dataclasses.is_dataclass(e):
        parts = []
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                parts.append(expr_signature(v))
            elif isinstance(v, (list, tuple)):
                parts.append("[" + ",".join(
                    expr_signature(x) if isinstance(x, Expr) else
                    ("(" + ",".join(expr_signature(y) if isinstance(y, Expr)
                                    else repr(y) for y in x) + ")")
                    if isinstance(x, tuple) else repr(x) for x in v) + "]")
            else:
                parts.append(repr(v))
        return f"{type(e).__name__}({','.join(parts)})"
    return repr(e)


def _expr_nodes(e) -> int:
    """Expression nodes an evaluation of ``e`` visits (0 for None)."""
    if not isinstance(e, Expr):
        return 0
    n = 1
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                n += _expr_nodes(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    for y in (x if isinstance(x, tuple) else (x,)):
                        n += _expr_nodes(y)
    return n


def _table_signature(t: Table) -> Tuple:
    return tuple((n, c.kind, str(c.data.dtype),
                  id(c.dictionary) if c.dictionary is not None else None)
                 for n, c in t.columns.items())


def _shape_key(t) -> Tuple:
    """Shapes and dtypes of a nest of tensors (a trace's abstract values)."""
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), t.dtype)
    return tuple(_shape_key(x) for x in t)


# ---------------------------------------------------------------------------
# fused items (static descriptions of ops inside a region)
# ---------------------------------------------------------------------------


class _FusedFilter:
    def __init__(self, cond: Expr):
        self.cond = cond

    def signature(self):
        return ("F", expr_signature(self.cond))

    def apply(self, t: Table, valid, aux):
        return t, valid & evaluate(self.cond, t).data


class _FusedProject:
    def __init__(self, exprs, keep_input: bool):
        self.exprs = exprs
        self.keep_input = keep_input

    def signature(self):
        return ("P", tuple((n, expr_signature(e)) for n, e in self.exprs),
                self.keep_input)

    def apply(self, t: Table, valid, aux):
        cols = dict(t.columns) if self.keep_input else {}
        for name, e in self.exprs:
            cols[name] = evaluate(e, t)
        return Table(cols), valid


class _FusedSelect:
    def __init__(self, columns):
        self.columns = list(columns)

    def signature(self):
        return ("S", tuple(self.columns))

    def apply(self, t: Table, valid, aux):
        return t.select([c for c in self.columns if c in t]), valid


class _FusedProbe:
    """Static-shape hash probe; the build table arrives as region arguments.

    ``aux`` = (lookup table, build_arrays), padded to power-of-two buckets
    at prepare time.  The lookup table is (slot, lo) in direct mode,
    (sorted keys, order) in sorted mode, and (sorted keys, slots_key,
    slots_row) in kernel mode."""

    def __init__(self, probe_key: str, how: str, mark_name: str,
                 post_filter: Optional[Expr], build_meta, mode: str):
        self.probe_key = probe_key
        self.how = how
        self.mark_name = mark_name
        self.post_filter = post_filter
        self.build_meta = build_meta      # tuple of (name, kind, dtype, dict)
        self.mode = mode                  # direct | sorted | kernel

    def signature(self):
        return ("J", self.probe_key, self.how, self.mark_name,
                expr_signature(self.post_filter),
                tuple((n, k, str(dt), id(d) if d is not None else None)
                      for n, k, dt, d in self.build_meta),
                self.mode)

    def apply(self, t: Table, valid, aux):
        table, build_arrays = aux
        probe_col = t[self.probe_key]
        if dtype_kind(probe_col.data) not in "iu":
            # an int64 cast of a float/string key would change semantics:
            # the segment runs its ops eagerly instead
            raise UnfusableRegion(
                f"unfusable probe key dtype {probe_col.data.dtype}")
        pk = probe_col.data.to(torch.int64)
        if self.mode == "kernel":
            s_keys, slots_key, slots_row = table
            p32 = kops.map_probe_keys(s_keys, pk)
            row, found = kops.hash_probe(p32, slots_key, slots_row)
        elif self.mode == "direct":
            slot, lo = table
            row, found = kops.direct_lookup(slot, lo, pk)
        else:
            s_keys, order = table
            row, found = kops.sorted_lookup(s_keys, order, pk)
        if self.how == "mark":
            out = t.with_column(self.mark_name, Column(found, BOOL))
        elif self.how == "semi":
            out, valid = t, valid & found
        elif self.how == "anti":
            out, valid = t, valid & ~found
        else:  # inner
            cols = dict(t.columns)
            # the clip bound is the build arrays' own (bucketed) length: a
            # cached region run with a regrown build table in the same
            # bucket must not clamp to the old row count
            safe = torch.clamp(row, 0, build_arrays[0].shape[0] - 1).long()
            for (name, kind, dt, dct), arr in zip(self.build_meta,
                                                  build_arrays):
                if name not in cols:
                    cols[name] = Column(arr[safe], kind, dct)
            out, valid = Table(cols), valid & found
        if self.post_filter is not None:
            valid = valid & evaluate(self.post_filter, out).data
        return out, valid

    def _dicts(self):
        return [(n, d) for n, k, dt, d in self.build_meta]


# ---------------------------------------------------------------------------
# region (cached across queries by signature)
# ---------------------------------------------------------------------------


class _CompiledRegion:
    def __init__(self, compiler: "PipelineCompiler", items, in_meta):
        self.compiler = compiler
        self.items = items
        self.in_meta = in_meta            # tuple of (name, kind, dictionary)
        self.failed = False
        self.dict_refs: List = []         # pins dictionary ids for the cache key
        self._traced = set()              # shape keys seen (one trace each)
        # bytes a row of the input and of the output takes, set at the
        # first trace; and the lazy cost summary (analyze mode)
        self.row_bytes = (0, 0)
        self.cost = None

    def cost_summary(self, n_rows: int, rows_out: int, aux) -> dict:
        """Estimated FLOPs and bytes of one call of this region.

        The reference reads them from XLA's HLO cost analysis of the
        compiled region; the port has no compiled program to ask, so it
        counts them from the region's items: bytes are the input columns
        read, the probe tables (every tensor of ``aux``) read and the
        output columns written; FLOPs are the rows times the expression
        nodes evaluated (filters, projections, post-filters) plus the
        probe slot reads (one a key for a direct-address table, a binary
        search over the sorted keys otherwise, plus the first slot of the
        hash table on the kernel route).  Computed lazily, only where
        ``analyze=True`` asks, after the stage's timer stopped, from the
        first such call's rows, and cached per region like the
        reference's.  It may never fail a query."""
        if self.cost is None:
            try:
                nodes, probes = 0, 0.0
                tensors = []
                for item, a in zip(
                        (i for i in self.items if isinstance(i, _FusedProbe)),
                        aux):
                    tensors.extend(_flat_tensors(a))
                    probes += _probe_reads(item, a[0])
                for item in self.items:
                    if isinstance(item, _FusedFilter):
                        nodes += _expr_nodes(item.cond)
                    elif isinstance(item, _FusedProject):
                        nodes += sum(_expr_nodes(e) for _, e in item.exprs)
                    elif isinstance(item, _FusedProbe):
                        nodes += _expr_nodes(item.post_filter)
                in_row, out_row = self.row_bytes
                nbytes = (n_rows * in_row + rows_out * out_row
                          + sum(t.numel() * t.element_size() for t in tensors))
                self.cost = {"est_flops": float(n_rows * (nodes + probes)),
                             "est_bytes": float(nbytes)}
            except Exception:  # noqa: BLE001 — an estimate must never fail a query
                self.cost = {}
        return self.cost

    def run(self, arrays, n_bucket: int, valid, aux):
        """The region body over ``arrays`` (static row count) → (surviving
        rows' index tensor, count tensor, output Table before the gather)."""
        key = (n_bucket, tuple(a.dtype for a in arrays), _shape_key(aux))
        new_trace = key not in self._traced
        if new_trace:
            self._traced.add(key)
            self.compiler.stats["traces"] += 1
            METRICS.counter("pipeline_compiler.traces").inc()
        t = Table({name: Column(arr, kind, dct)
                   for (name, kind, dct), arr in zip(self.in_meta, arrays)})
        ai = 0
        for item in self.items:
            a = None
            if isinstance(item, _FusedProbe):
                a = aux[ai]
                ai += 1
            t, valid = item.apply(t, valid, a)
        if new_trace:
            self.row_bytes = (sum(a.element_size() for a in arrays),
                              sum(c.data.element_size()
                                  for c in t.columns.values()))
        idx, count = kops.compact(valid)
        return idx, count, t


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat_tensors(y)]
    return []


def _probe_reads(item: "_FusedProbe", table) -> float:
    """Slot reads a probe key costs in ``item``'s lookup table."""
    if item.mode == "direct":
        return 1.0
    search = math.log2(max(table[0].shape[0], 2))   # the sorted build keys
    return search + (1.0 if item.mode == "kernel" else 0.0)


class FusedSegment:
    """A per-execution runnable: region → one compaction and gather."""

    def __init__(self, compiler: "PipelineCompiler", items, eager_ops, aux):
        self.compiler = compiler
        self.items = items
        self.eager_ops = eager_ops        # the same ops, run one by one
        self.aux = tuple(aux)
        # the items half of the cache key never changes for this segment
        self._items_sig = tuple(i.signature() for i in items)
        kinds = {"_FusedFilter": "filter", "_FusedSelect": "select",
                 "_FusedProject": "project", "_FusedProbe": "probe"}
        self._description = "FusedRegion[" + "+".join(
            kinds.get(type(i).__name__, "?") for i in items) + "]"
        # the last call's telemetry for the analyze path: the region,
        # whether it was a cache hit or degraded to the eager ops, and the
        # call's arguments for ``cost_summary`` (its rows in and out; the
        # probe tables are this segment's own ``aux``).  Host values only,
        # so a recorded entry pins no tensor through it
        self.last_call_info: Optional[dict] = None

    def describe(self) -> str:
        return self._description

    def _eager(self, t: Table) -> Table:
        for op in self.eager_ops:
            t = op(t)
        return t

    def __call__(self, t: Table) -> Table:
        sig = (self._items_sig, _table_signature(t))
        region = self.compiler.cache.get(sig)
        cache_hit = region is not None
        if region is None:
            in_meta = tuple((n, c.kind, c.dictionary)
                            for n, c in t.columns.items())
            region = _CompiledRegion(self.compiler, self.items, in_meta)
            # pin every dictionary object in the signature so its id() can
            # never be recycled onto a different dictionary
            region.dict_refs = [c.dictionary for c in t.columns.values()] + [
                d for item in self.items if isinstance(item, _FusedProbe)
                for _, d in item._dicts()]
            self.compiler.cache[sig] = region
        else:
            self.compiler.stats["cache_hits"] += 1
        if region.failed:
            self.last_call_info = {"cache_hit": cache_hit, "degraded": True}
            return self._eager(t)

        n = t.num_rows
        arrays = tuple(c.data for c in t.columns.values())
        device = t.device
        valid = torch.ones(n, dtype=torch.bool, device=device)
        t0 = time.perf_counter()
        try:
            idx, count, out = region.run(arrays, _bucket(n), valid, self.aux)
        except UnfusableRegion:
            region.failed = True
            self.compiler.stats["declines"] += 1
            METRICS.counter("pipeline_compiler.declines").inc()
            self.last_call_info = {"cache_hit": cache_hit, "degraded": True}
            return self._eager(t)
        if not cache_hit:
            # a fresh region's first call is its "compile" in the
            # reference's accounting
            dt = time.perf_counter() - t0
            self.compiler.stats["trace_seconds"] += dt
            METRICS.histogram("pipeline_compiler.trace_seconds").observe(dt)
        self.compiler.stats["region_calls"] += 1
        k = pull_scalar(count)   # the region's single scalar pull
        self.last_call_info = {"cache_hit": cache_hit, "degraded": False,
                               "region": region,
                               "cost_args": (n, k, self.aux)}
        return out.take(idx[:k])


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


class PipelineCompiler:
    """Owns the signature-keyed cache of pipeline regions."""

    def __init__(self):
        self.cache: Dict[Tuple, _CompiledRegion] = {}
        self.stats = {"traces": 0, "cache_hits": 0, "region_calls": 0,
                      "fused_probes": 0, "eager_ops": 0, "declines": 0,
                      "trace_seconds": 0.0}

    # -- probe eligibility + device-side build ------------------------------
    def _lower_probe(self, op, backend) -> Optional[_FusedProbe]:
        rel = op.rel
        if rel.how not in ("inner", "semi", "anti", "mark"):
            return None
        if len(rel.probe_keys) != 1 or len(rel.build_keys) != 1:
            return None
        build = op.build_ref.table
        if build is None or build.num_rows == 0:
            return None
        bc = build[rel.build_keys[0]]
        if bc.kind not in (NUMERIC, DATE) or dtype_kind(bc.data) not in "iu":
            return None
        bk = bc.data.to(torch.int64)
        n = build.num_rows
        nb = _bucket(n)
        valid = torch.arange(nb, device=bk.device) < n
        bk_p = _pad(bk, nb)

        if backend is not None:
            # kernel path: the sorted ranks double as the int32
            # factorization the probe kernel wants
            s, order, ranks, dup, sentinel_hit = kops.sorted_build(bk_p, valid)
            if pull_scalar(sentinel_hit) or (rel.how == "inner"
                                             and pull_scalar(dup)):
                return None
            b32 = torch.where(valid, ranks, -1).to(torch.int32)
            sk, sr, placed = kops.build_table32(b32, valid)
            if not pull_scalar(placed):
                return None
            mode, table = "kernel", (s, sk, sr)
            backend.probe_hits += 1
        else:
            lo, hi, _ = kops.key_bounds(bk_p, valid)
            # one pull pair for build metadata (prepare time only: the plan
            # cache replays prepared segments, never this lowering)
            lo_i, hi_i = pull_scalar(lo), pull_scalar(hi)
            domain = _bucket(hi_i - lo_i + 1)
            if domain <= max(1 << 16, 8 * nb):
                # dense key domain: sort-free direct-address build
                slot, dup = kops.direct_build(bk_p, valid, lo, domain)
                if rel.how == "inner" and pull_scalar(dup):
                    return None           # multi-match: eager join handles it
                mode, table = "direct", (slot, lo)
            else:
                # sparse keys: sorted binary-search build
                s, order, ranks, dup, sentinel_hit = kops.sorted_build(
                    bk_p, valid)
                if pull_scalar(sentinel_hit) or (rel.how == "inner"
                                                 and pull_scalar(dup)):
                    return None
                mode, table = "sorted", (s, order)
        build_meta = tuple((nm, c.kind, c.data.dtype, c.dictionary)
                           for nm, c in build.columns.items())
        build_arrays = tuple(_pad(c.data, nb)
                             for c in build.columns.values())
        fused = _FusedProbe(rel.probe_keys[0], rel.how, rel.mark_name,
                            rel.post_filter, build_meta, mode)
        fused._aux = (table, build_arrays)
        self.stats["fused_probes"] += 1
        METRICS.counter("pipeline_compiler.fused_probes").inc()
        return fused

    def prepare(self, ops: Sequence, backend=None) -> List:
        """Segment a pipeline's op chain into fused regions and eager ops.

        Called once per pipeline execution, after its dependencies (build
        tables) have materialized → a list of callables Table → Table."""
        from .executor import FilterOp, ProbeOp, ProjectOp, SelectOp

        segments: List = []
        run_items: List = []
        run_ops: List = []
        run_aux: List = []

        def flush():
            if run_items:
                segments.append(FusedSegment(self, list(run_items),
                                             list(run_ops), list(run_aux)))
                run_items.clear(), run_ops.clear(), run_aux.clear()

        for op in ops:
            lowered = None
            if isinstance(op, FilterOp):
                lowered = _FusedFilter(op.cond)
            elif isinstance(op, SelectOp):
                lowered = _FusedSelect(op.columns)
            elif isinstance(op, ProjectOp):
                lowered = _FusedProject(op.exprs, op.keep_input)
            elif isinstance(op, ProbeOp):
                lowered = self._lower_probe(op, backend)
                if lowered is not None:
                    run_aux.append(lowered._aux)
            if lowered is None:
                flush()
                segments.append(op)
                self.stats["eager_ops"] += 1
                METRICS.counter("pipeline_compiler.eager_ops").inc()
            else:
                run_items.append(lowered)
                run_ops.append(op)
        flush()
        return segments
