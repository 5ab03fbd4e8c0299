"""Distributed query execution (paper §3.2.4, §3.3 'Distributed') —
counterpart of ``repro/core/distributed.py``.

Mirrors the Doris+Sirius lifecycle: a host-side **coordinator** takes any
optimized plan, runs the exchange-placement pass
(``optimizer.exchange.place_exchanges``) to insert shuffle / broadcast /
merge boundaries, cuts the plan into fragments at those boundaries, and
dispatches the fragments in dependency order.  Each shard fragment runs
through the regular pipeline executor of a pooled shard engine over its
shard's partition (one shared region compiler), and every exchange runs as
a collective from ``exchange.service`` over a ``ShardMesh`` — the
compute/exchange split is timed separately for the Table-2 breakdown.

The shards are **logical and share one device**: the mesh places
``n_shards`` shards on the engine's device, each shard's engine runs there
one after another, and an exchange is a permutation within device memory
plus the host round trip through the registry — not NVLink, not a network.

Intermediate results cross fragments through the **exchange registry** of
temp tables (compacted host rows + partition key), which is also the
checkpoint boundary: snapshots re-shard onto any mesh size, which is what
makes elastic downsizing possible.

Fault tolerance: fragment-level retry, registry checkpointing + restart,
elastic downsizing to a smaller mesh on (injected) node failure,
speculative re-execution of stragglers, and shuffle-overflow retry with
doubled bucket capacity.

Departures from the reference: a shard degrades to the host
``FallbackEngine`` only on ``PlanNotLowerable`` (the reference degrades on
any exception, which on the card would hide a CUDA or kernel error), and a
speculative replica never runs once the other's result is taken
(``runtime.control.SpeculativeRunner``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..exchange.service import (
    MIX64, Frame, ShardMesh, broadcast, collective_step, shuffle,
)
from ..kernels import ops as kops
from ..observability.dist import skew_ratio
from ..observability.journal import JOURNAL
from ..observability.metrics import METRICS, MetricsRegistry
from ..optimizer.exchange import (
    DIST_BOUNDARY_PREFIX, HASH, REP, ExchangeFragment, Partitioning,
    boundary_name, cut_fragments, place_exchanges,
)
from ..relational.expressions import Expr, Lit
from ..relational.table import Table
from ..runtime.checkpoint import RegistryCheckpointer
from ..runtime.control import (
    FaultInjector, HeartbeatMonitor, SimulatedNodeFailure, SpeculativeRunner,
)
from ..substrait.router import host_to_device
from .executor import PlanNotLowerable, default_device
from .fallback import FallbackEngine
from .plan import (
    ReadRel, Rel, ScalarSubquery, plan_from_json, plan_to_json, walk,
    walk_deep,
)


class ExchangeOverflow(RuntimeError):
    pass


def np_partition_hash(keys: np.ndarray, n: int) -> np.ndarray:
    """Host twin of exchange.service.partition_hash (must agree bit-for-bit)."""
    with np.errstate(over="ignore"):
        h = keys.astype(np.int64) * np.int64(MIX64)
        h = (h >> 33) ^ h
    return ((h % n) + n) % n


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h - (1 << 64) if h >= (1 << 63) else h


def key_to_int64(v: np.ndarray) -> np.ndarray:
    """Deterministic int64 surrogate for any partition-key dtype.

    Used identically for base-table partitioning, registry re-partitioning
    and the device shuffle's key column, so two tables hashed on equal key
    *values* always co-locate — even string keys across different
    dictionaries (per-value FNV-1a, not dictionary codes).
    """
    v = np.asarray(v)
    if v.dtype.kind in "UO":
        uniq, inv = np.unique(np.asarray(v, "U"), return_inverse=True)
        h = np.array([_fnv1a(s) for s in uniq], np.int64)
        return h[inv] if len(uniq) else np.zeros(0, np.int64)
    if v.dtype.kind == "M":
        return (v.astype("datetime64[D]")
                - np.datetime64("1970-01-01", "D")).astype(np.int64)
    if v.dtype.kind == "f":
        # normalize -0.0 so equal float keys share a bit pattern
        return (v.astype(np.float64) + 0.0).view(np.int64)
    return v.astype(np.int64)


def encode_host_table(cols: Dict[str, np.ndarray]):
    """Host format → engine encoding (codes / days / numerics) + dictionaries."""
    enc, dicts = {}, {}
    for name, v in cols.items():
        if v.dtype.kind in "UO":
            d, codes = np.unique(np.asarray(v, "U"), return_inverse=True)
            enc[name] = codes.astype(np.int32)
            dicts[name] = d
        elif v.dtype.kind == "M":
            enc[name] = (v.astype("datetime64[D]")
                         - np.datetime64("1970-01-01", "D")).astype(np.int32)
        else:
            enc[name] = v
    return enc, dicts


class _DbCatalog:
    """Stats-layer adapter over the actual host database (exact row counts
    — the coordinator owns the data, so the placement pass plans against
    real cardinalities, not schema guesses)."""

    def __init__(self, db: Dict[str, Dict[str, np.ndarray]]):
        self.db = db

    def has_table(self, t: str) -> bool:
        return t in self.db

    def columns(self, t: str) -> List[str]:
        return list(self.db[t].keys())

    def row_estimate(self, t: str) -> float:
        cols = self.db.get(t)
        if not cols:
            return 1e3
        return float(len(next(iter(cols.values()))))

    def dictionary_for(self, name: str):
        return None


class DistributedEngine:
    """SPMD SQL over a mesh of logical shards: generic ``run_plan`` for
    every optimized plan, with the exchange service layer moving rows.

    ``device=None`` picks the current CUDA device and raises if there is
    none; tests pass ``device="cpu"``.  All ``n_shards`` shards share that
    one device (``n_shards`` defaults to 1).  ``device`` may also be an
    explicit device list, as the reference's ``jax.devices()``, naming
    one device: ``n_shards`` then defaults to its length and may not
    exceed it."""

    PARTITION_KEYS = {
        "lineitem": "l_partkey",   # co-located with part, NOT with orders —
        "orders": "o_custkey",     # forces orderkey joins to exchange (§4.3)
        "customer": "c_custkey",
        "part": "p_partkey",
        "supplier": "s_suppkey",
        "partsupp": "ps_partkey",
        "hits": "userid",          # ClickBench fact table
    }

    def __init__(self, db: Dict[str, Dict[str, np.ndarray]],
                 n_shards: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 injector: Optional[FaultInjector] = None,
                 shuffle_slack: float = 2.0,
                 predicate_transfer: bool = False,
                 use_kernels: Optional[bool] = None,
                 partition_keys: Optional[Dict[str, str]] = None,
                 device=None):
        self.db = db
        self.predicate_transfer = predicate_transfer
        if isinstance(device, (list, tuple)):
            devices = [torch.device(d) for d in device]
            if len(set(devices)) != 1:
                raise ValueError("the shards share one device; got "
                                 f"{sorted(map(str, set(devices)))}")
            self.n_shards = n_shards or len(devices)
            if self.n_shards > len(devices):
                raise ValueError("n_shards exceeds device count")
            self.device = devices[0]
        else:
            self.device = (torch.device(device) if device is not None
                           else default_device())
            self.n_shards = n_shards or 1
        self.shuffle_slack = shuffle_slack
        self.injector = injector or FaultInjector()
        self.speculative = SpeculativeRunner()
        self.checkpointer = (RegistryCheckpointer(checkpoint_dir)
                             if checkpoint_dir else None)
        self.use_kernels = (bool(int(os.environ.get("REPRO_USE_KERNELS", "0")))
                            if use_kernels is None else use_kernels)
        self.partition_keys = dict(self.PARTITION_KEYS
                                   if partition_keys is None else partition_keys)
        self.catalog = _DbCatalog(db)
        self.timers: Dict[str, float] = defaultdict(float)
        self.recoveries = 0
        # per-query exchange telemetry: one dict per collective commit
        # {fragment, kind, key, bytes_per_shard, skew_ratio, ...}
        self.exchange_stats: List[dict] = []
        # journal query ID of the most recent run_plan/run_query
        self.last_query_id: Optional[str] = None
        # compile seconds the most recent _exec_one_shard incurred (used
        # by _run_fragment_shards to attribute compile vs compute)
        self._last_shard_compile_s = 0.0
        self._shard_engines: List = []
        self._region_compiler = None   # shared across shards/queries
        self._collective_cache: Dict[tuple, Callable] = {}
        self.tables: Dict[str, dict] = {}
        self._build_mesh()
        self._load()

    # -- data plane ----------------------------------------------------------
    def _build_mesh(self):
        self.mesh = ShardMesh.of(self.n_shards, self.device)
        self.heartbeat = HeartbeatMonitor(self.n_shards)
        self._collective_cache.clear()
        self._shard_engines = []

    def _load(self):
        """Encode each base table once into a master Table on the device
        (shared dictionaries → cross-shard pipeline-region reuse) plus
        per-shard row indices, on the device, for hash-partitioned tables;
        tables without a partition key are replicated (every shard reads
        the master).  The previous masters and slices are released first,
        so that a recovery does not hold two copies."""
        self.tables = {}
        for name, cols in self.db.items():
            key = self.partition_keys.get(name)
            entry = {"master": host_to_device(cols, self.device), "key": key,
                     "shard_idx": None, "slices": {}}
            if key is not None and key in cols:
                pid = np_partition_hash(key_to_int64(np.asarray(cols[key])),
                                        self.n_shards)
                entry["shard_idx"] = [
                    torch.from_numpy(np.nonzero(pid == s)[0]).to(self.device)
                    for s in range(self.n_shards)]
            self.tables[name] = entry

    def table_partitionings(self) -> Dict[str, Partitioning]:
        out = {}
        for name, entry in self.tables.items():
            out[name] = (Partitioning(HASH, entry["key"])
                         if entry["shard_idx"] is not None
                         else Partitioning(REP))
        return out

    def _base_table(self, name: str, shard: int, full: bool) -> Table:
        entry = self.tables[name]
        if full or entry["shard_idx"] is None:
            return entry["master"]
        t = entry["slices"].get(shard)
        if t is None:
            t = entry["master"].take(entry["shard_idx"][shard])
            entry["slices"][shard] = t
        return t

    def _boundary_table(self, name: str, producer: ExchangeFragment,
                        registry: dict, shard: int, full: bool) -> Table:
        entry = registry[name]
        cache = entry.setdefault("_device", {})
        master = cache.get("master")
        if master is None:
            master = host_to_device(entry["rows"], self.device)
            cache["master"] = master
        if full or producer.kind != "shuffle":
            return master
        key = entry["partition_key"]
        idx = cache.get(("idx", self.n_shards))
        if idx is None:
            pid = np_partition_hash(key_to_int64(entry["rows"][key]),
                                    self.n_shards)
            idx = [torch.from_numpy(np.nonzero(pid == s)[0]).to(self.device)
                   for s in range(self.n_shards)]
            cache[("idx", self.n_shards)] = idx
        slot = ("slice", self.n_shards, shard)
        t = cache.get(slot)
        if t is None:
            t = master.take(idx[shard])
            cache[slot] = t
        return t

    # -- timing ---------------------------------------------------------------
    def _timed(self, kind: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":     # time the work, not its enqueue
            torch.cuda.synchronize(self.device)
        self.timers[kind] += time.perf_counter() - t0
        return out

    # -- planning -------------------------------------------------------------
    def plan_fragments(self, plan: Rel) -> List[ExchangeFragment]:
        """Exchange placement + fragment cutting for ``plan`` (pure)."""
        plan = plan_from_json(plan_to_json(plan))
        placed = place_exchanges(plan, self.catalog, self.n_shards,
                                 self.table_partitionings())
        return cut_fragments(placed)

    def program_names(self, plan_or_qid) -> List[str]:
        """Fragment names ``run_plan`` will execute for a plan (or TPC-H
        query id) — the handles fault-injection plans target."""
        plan = plan_or_qid
        if isinstance(plan_or_qid, int):
            from ..data.tpch_queries import QUERIES
            plan = QUERIES[plan_or_qid]()
        return [f.label for f in self.plan_fragments(plan)]

    # -- coordinator ----------------------------------------------------------
    def run_query(self, qid: int, resume: bool = False):
        """Distributed TPC-H by query id.  A ``_program_q{qid}`` attribute,
        if present, overrides the generic path with a hand-built program
        (kept as a hook for tests); everything else goes through
        ``run_plan`` on the standard plan."""
        override = getattr(self, f"_program_q{qid}", None)
        if override is not None:
            t_start = time.perf_counter()
            self.timers = defaultdict(float)
            self.exchange_stats = []
            with JOURNAL.query_span("distributed.query",
                                    shards=self.n_shards,
                                    program=f"q{qid}") as jq:
                final = self._run_program(override, resume=resume)
                self.last_query_id = jq.query_id
            self._publish(t_start)
            return final
        from ..data.tpch_queries import QUERIES
        if qid not in QUERIES:
            raise NotImplementedError(f"unknown TPC-H query {qid}")
        return self.run_plan(QUERIES[qid](), resume=resume)

    def run_plan(self, plan: Rel, resume: bool = False):
        """Execute any optimized plan distributed; returns host columns.

        The whole run roots one journal query tree: fragment attempts,
        per-shard engine runs, collectives, retries, recoveries and
        checkpoints all land under ``self.last_query_id``."""
        t_start = time.perf_counter()
        self.timers = defaultdict(float)
        self.exchange_stats = []
        with JOURNAL.query_span("distributed.query",
                                shards=self.n_shards) as jq:
            out = self._run_plan_inner(plan, resume=resume, top=True)
            self.last_query_id = jq.query_id
            jq.set(exchanges=len(self.exchange_stats),
                   recoveries=self.recoveries)
        self._publish(t_start)
        return out

    def _run_plan_inner(self, plan: Rel, resume: bool = False,
                        top: bool = False):
        plan = plan_from_json(plan_to_json(plan))   # private mutable copy
        self._resolve_subqueries(plan)
        # fragments are fixed for the life of the query: elastic downsizing
        # and overflow retries rebuild closures, not the plan cut, so
        # fragment names stay stable for checkpoints and fault plans
        fragments = self.plan_fragments(plan)

        def build():
            return [(f.label, self._make_fragment_fn(f, fragments))
                    for f in fragments]

        return self._run_program(build, resume=resume,
                                 checkpoint=top)

    def _resolve_subqueries(self, plan: Rel) -> None:
        """Run scalar subquery plans (distributed, recursively) and splice
        their values in as literals — the executor's contract."""
        def resolve(e):
            if isinstance(e, ScalarSubquery):
                rows = self._run_plan_inner(e.plan)
                val = np.asarray(rows[e.column]).reshape(-1)
                return Lit(float(val[0]) if val.dtype.kind == "f"
                           else int(val[0]))
            if dataclasses.is_dataclass(e) and isinstance(e, Expr):
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, Expr):
                        setattr(e, f.name, resolve(v))
                    elif isinstance(v, (list, tuple)) and v and \
                            isinstance(v[0], tuple):
                        setattr(e, f.name, [
                            tuple(resolve(x) if isinstance(x, Expr) else x
                                  for x in w) for w in v])
            return e

        for rel in walk(plan):
            for f in dataclasses.fields(rel):
                v = getattr(rel, f.name)
                if isinstance(v, Expr):
                    setattr(rel, f.name, resolve(v))
                elif isinstance(v, list) and v and isinstance(v[0], tuple) \
                        and len(v[0]) == 2 and isinstance(v[0][1], Expr):
                    setattr(rel, f.name, [(n, resolve(e)) for n, e in v])
                elif isinstance(v, list):
                    for item in v:
                        if dataclasses.is_dataclass(item) and \
                                isinstance(getattr(item, "expr", None), Expr):
                            item.expr = resolve(item.expr)

    def _run_program(self, build_program, resume: bool = False,
                     checkpoint: bool = True):
        """The fragment dispatch loop: retry budget, elastic recovery on
        node failure, slack doubling on exchange overflow, checkpoint after
        every non-final fragment, speculative straggler re-execution."""
        program = build_program()
        names = [n for n, _ in program]
        registry: dict = {}
        idx = 0
        if resume and self.checkpointer:
            loaded = self.checkpointer.load_latest(names)
            if loaded:
                done_frag, registry = loaded
                idx = names.index(done_frag) + 1
                self.timers["resumed_from"] = idx
        final = None
        attempts = 0
        frag_attempts: Dict[str, int] = defaultdict(int)
        while idx < len(program):
            name, fn = program[idx]
            attempt = frag_attempts[name]
            frag_attempts[name] += 1
            attempts += 1
            if attempts > 3 * len(program) + 10:
                raise RuntimeError("fragment retry budget exhausted")
            fattrs = getattr(fn, "_journal_attrs", {})
            try:
                with JOURNAL.span(name, "fragment", fragment=name,
                                  attempt=attempt, **fattrs):
                    self.injector.before_fragment(name)
                    delay = self.injector.straggle(name)
                    # fragments run on SpeculativeRunner threads: carry
                    # this loop's trace context over so shard/exchange
                    # spans land in the query tree, with each replica
                    # (primary or speculative backup) as its own span
                    ctx = JOURNAL.current_context()
                    self._frag_attempt = attempt

                    def run_replica(who, body, _name=name, _ctx=ctx):
                        with JOURNAL.activate(_ctx):
                            with JOURNAL.span(f"{_name}:{who}", "attempt",
                                              fragment=_name, replica=who):
                                return body()

                    out, who = self.speculative.run(
                        name, lambda: fn(registry), injected_delay_s=delay,
                        wrap=run_replica)
                    if who == "backup":
                        JOURNAL.event("speculative_backup", "recovery",
                                      fragment=name, attempt=attempt)
            except SimulatedNodeFailure as e:
                self.heartbeat.kill(e.node)
                JOURNAL.event("elastic_rebuild", "recovery", fragment=name,
                              node=e.node, shards_next=max(
                                  self.n_shards - 1, 1))
                self._elastic_recover()
                program = build_program()
                continue
            except ExchangeOverflow:
                JOURNAL.event("overflow_retry", "recovery", fragment=name,
                              slack_next=self.shuffle_slack * 2.0)
                self.shuffle_slack *= 2.0
                program = build_program()
                continue
            if out is not None:
                final = out
            if checkpoint and self.checkpointer and idx < len(program) - 1:
                with JOURNAL.span("checkpoint", "checkpoint", fragment=name):
                    self.checkpointer.save(name, registry)
            idx += 1
        return final

    def _publish(self, t_start: float):
        total = time.perf_counter() - t_start
        self.timers["other"] = max(
            total - self.timers["compute"] - self.timers["exchange"]
            - self.timers["compile"], 0.0)
        self.timers["total"] = total
        # phase timers land in the process-wide registry so distributed
        # runs show up next to single-device telemetry
        for kind, secs in self.timers.items():
            if isinstance(secs, (int, float)) and kind != "resumed_from":
                METRICS.counter(f"distributed.{kind}_seconds").inc(secs)
        METRICS.histogram("distributed.query_seconds").observe(total)

    def _elastic_recover(self):
        """Node loss → rebuild a smaller mesh and re-shard the base tables.

        Registry snapshots are host-side compacted rows, so they re-shard
        transparently on the new mesh at the next boundary read.  The shard
        engines (and the slices registered in them) and the old masters are
        dropped before the reload."""
        live = max(self.n_shards - 1, 1)
        self.recoveries += 1
        self.n_shards = live
        self._build_mesh()
        self._load()

    # -- fragment execution ---------------------------------------------------
    def _make_fragment_fn(self, frag: ExchangeFragment,
                          fragments: List[ExchangeFragment]):
        def fn(registry):
            if frag.placement == "coordinator":
                with JOURNAL.span(f"{frag.label}@coordinator", "coordinator",
                                  fragment=frag.label):
                    return self._run_coordinator(frag, registry)
            outs = self._run_fragment_shards(frag, fragments, registry)
            self._commit_exchange(frag, outs, registry)
            return None
        fn._journal_attrs = {"placement": frag.placement,
                             "kind": frag.kind or "final"}
        return fn

    def _shard_engine(self, shard: int):
        from .executor import SiriusEngine
        while len(self._shard_engines) <= shard:
            idx = len(self._shard_engines)
            # each pooled engine gets its own registry, labeled into the
            # process-global METRICS (``distributed.shard<i>.*``)
            reg = MetricsRegistry(parent=METRICS,
                                  label=f"distributed.shard{idx}")
            eng = SiriusEngine(use_kernels=self.use_kernels, num_workers=1,
                               metrics=reg, device=self.device)
            # boundary temp tables change under a constant plan signature,
            # so warm replays would poison — trace each execution instead
            eng.executor.cache_enabled = False
            if self._region_compiler is None:
                self._region_compiler = eng.executor.compiler
            else:
                eng.executor.compiler = self._region_compiler
            self._shard_engines.append(eng)
        return self._shard_engines[shard]

    def _run_fragment_shards(self, frag: ExchangeFragment,
                             fragments: List[ExchangeFragment],
                             registry: dict) -> List[Dict[str, np.ndarray]]:
        producers = {boundary_name(f.fid): f for f in fragments}
        needed, seen = [], set()
        for rel in walk_deep(frag.plan):
            if isinstance(rel, ReadRel) and rel.table not in seen:
                seen.add(rel.table)
                needed.append(rel.table)
        shards = [0] if frag.run_once else list(range(self.n_shards))
        outs = []
        for s in shards:
            tables = {}
            for tname in needed:
                if tname.startswith(DIST_BOUNDARY_PREFIX):
                    tables[tname] = self._boundary_table(
                        tname, producers[tname], registry, s,
                        full=frag.run_once)
                else:
                    tables[tname] = self._base_table(tname, s,
                                                     full=frag.run_once)
            t0 = time.perf_counter()
            with JOURNAL.span(f"{frag.label}@shard{s}", "shard",
                              fragment=frag.label, shard=s,
                              attempt=getattr(self, "_frag_attempt", 0)):
                rows = self._exec_one_shard(frag.plan, tables, s)
            dt = time.perf_counter() - t0
            # compile (region trace) time the shard engine incurred is not
            # compute — attribute it to its own phase timer
            compile_s = min(self._last_shard_compile_s, dt)
            self.timers["compute"] += dt - compile_s
            self.timers["compile"] += compile_s
            METRICS.counter(
                f"distributed.shard{s}.compute_seconds").inc(dt - compile_s)
            if compile_s:
                METRICS.counter(
                    f"distributed.shard{s}.compile_seconds").inc(compile_s)
            outs.append(rows)
        return outs

    def _exec_one_shard(self, plan: Rel, tables: Dict[str, Table],
                        shard: int) -> Dict[str, np.ndarray]:
        """One shard's fragment on its pooled engine → host rows.  A plan
        the engine cannot lower runs on the host ``FallbackEngine``
        (counted in ``distributed.shard_fallbacks``); any other error — a
        kernel's, a CUDA error — propagates."""
        eng = self._shard_engine(shard)
        self._last_shard_compile_s = 0.0
        for name, t in tables.items():
            eng.register(name, t)
        try:
            out = eng.execute(plan)
        except PlanNotLowerable as exc:
            METRICS.counter("distributed.shard_fallbacks").inc()
            JOURNAL.event("shard_fallback", "shard", shard=shard,
                          reason=type(exc).__name__)
            host = {name: t.to_host() for name, t in tables.items()}
            return FallbackEngine(host).execute(plan)
        # surface the fragment's true trace/compile tax to the caller
        # (executor.last_compile_seconds is per-execute)
        self._last_shard_compile_s = eng.executor.last_compile_seconds
        return out.to_host()

    def _run_coordinator(self, frag: ExchangeFragment, registry: dict):
        """Root fragment: merged registry rows + full base tables on the
        host engine (which also covers window/set rels the device engine
        does not lower)."""
        tables: Dict[str, Dict[str, np.ndarray]] = dict(self.db)
        for name, entry in registry.items():
            tables[name] = entry["rows"]
        return FallbackEngine(tables).execute(frag.plan)

    # -- exchange collectives -------------------------------------------------
    def _out_cap(self, shard_cap: int) -> int:
        per_dest = int(shard_cap * self.shuffle_slack / self.n_shards) + 8
        return kops.bucket_size(per_dest, minimum=8)

    @staticmethod
    def _rows_bytes(rows: Dict[str, np.ndarray]) -> int:
        return int(sum(np.asarray(v).nbytes for v in rows.values()))

    def _commit_exchange(self, frag: ExchangeFragment,
                         outs: List[Dict[str, np.ndarray]], registry: dict):
        name = boundary_name(frag.fid)
        if frag.run_once and frag.kind in ("broadcast", "merge"):
            # producer already holds the complete result — a logical
            # exchange with zero wire cost, still journaled for the tree
            registry[name] = {"rows": outs[0], "partition_key": None}
            self._record_exchange(frag, frag.kind, None,
                                  [self._rows_bytes(outs[0])], 0.0, None)
            return
        if frag.run_once:
            # replicated producer feeding a shuffle: source the collective
            # from shard 0, the rest contribute empty frames
            empty = {c: np.asarray(v)[:0] for c, v in outs[0].items()}
            outs = [outs[0]] + [dict(empty) for _ in range(self.n_shards - 1)]
        kind = frag.kind or "merge"
        key = frag.keys[0] if frag.kind == "shuffle" else None
        with JOURNAL.span(f"exchange:{frag.label}", "exchange",
                          fragment=frag.label, kind=kind, key=key) as sp:
            t0 = time.perf_counter()
            if kind == "shuffle":
                outs = self._predicate_transfer(frag, outs, registry)
                rows = self._collective(outs, "shuffle", key)
                registry[name] = {"rows": rows, "partition_key": key}
                # skew is about what each shard *receives* post-partition:
                # re-derive the destination row distribution from the
                # merged rows (host-side, same hash as the collective)
                counts = np.bincount(
                    np_partition_hash(key_to_int64(rows[key]),
                                      self.n_shards),
                    minlength=self.n_shards)
                total_rows = int(counts.sum())
                bpr = self._rows_bytes(rows) / max(total_rows, 1)
                bytes_per_shard = [int(c * bpr) for c in counts]
            else:
                rows = self._collective(outs, kind, None)
                registry[name] = {"rows": rows, "partition_key": None}
                # broadcast/merge replicate everything: the interesting
                # distribution is what each producer shard contributed
                bytes_per_shard = [self._rows_bytes(r) for r in outs]
            wall = time.perf_counter() - t0
            stat = self._record_exchange(frag, kind, key, bytes_per_shard,
                                         wall, len(next(iter(rows.values()))))
            sp.set(**{k: v for k, v in stat.items() if k != "wall_s"})

    def _record_exchange(self, frag: ExchangeFragment, kind: str,
                         key: Optional[str], bytes_per_shard: List[int],
                         wall: float, rows_out: Optional[int]) -> dict:
        stat = {
            "fragment": frag.label, "kind": kind, "key": key,
            "bytes_per_shard": [int(b) for b in bytes_per_shard],
            "skew_ratio": round(skew_ratio(bytes_per_shard), 4),
            "rows_out": int(rows_out) if rows_out is not None else None,
            "wall_s": round(wall, 6),
        }
        self.exchange_stats.append(stat)
        return stat

    def exchange_summary(self) -> List[dict]:
        """One row per exchange for the last query: a retried exchange
        commits again, so keep the latest entry per fragment — that is also
        the post-retry slack on overflow-retried shuffles."""
        latest: Dict[str, dict] = {}
        for stat in self.exchange_stats:
            latest[stat["fragment"]] = stat
        return list(latest.values())

    def _predicate_transfer(self, frag, outs, registry):
        """Semi-filter shuffle rows by a committed build side's keys before
        the collective (the Doris 'predicate transfer' sideways pass) —
        correctness-neutral for the inner/semi joins it is planned on."""
        if not (self.predicate_transfer and frag.pt):
            return outs
        bfid, pk, bk = frag.pt
        bentry = registry.get(boundary_name(bfid))
        if bentry is None or bk not in bentry["rows"] or \
                any(pk not in rows for rows in outs):
            return outs
        bkeys = np.unique(key_to_int64(bentry["rows"][bk]))
        pruned, filtered = 0, []
        for rows in outs:
            m = np.isin(key_to_int64(rows[pk]), bkeys)
            pruned += int((~m).sum())
            filtered.append({c: np.asarray(v)[m] for c, v in rows.items()})
        METRICS.counter("distributed.predicate_transfer_rows_pruned").inc(pruned)
        return filtered

    def _wire_encode(self, outs: List[Dict[str, np.ndarray]]):
        """Unify dtypes across shards and encode strings/dates to device
        integers; returns (encoded shards, decode metadata)."""
        cols = list(outs[0].keys())
        enc = [dict() for _ in outs]
        meta: Dict[str, tuple] = {}
        for c in cols:
            vals = [np.asarray(rows[c]) for rows in outs]
            kinds = {v.dtype.kind for v in vals}
            if kinds & set("UO"):
                d = np.unique(np.concatenate(
                    [np.asarray(v, "U") for v in vals])) if any(
                        len(v) for v in vals) else np.zeros(0, "U1")
                for i, v in enumerate(vals):
                    enc[i][c] = np.searchsorted(
                        d, np.asarray(v, "U")).astype(np.int64)
                meta[c] = ("str", d)
            elif "M" in kinds:
                for i, v in enumerate(vals):
                    enc[i][c] = (v.astype("datetime64[D]") - np.datetime64(
                        "1970-01-01", "D")).astype(np.int64)
                meta[c] = ("date", None)
            else:
                dt = np.result_type(*[v.dtype for v in vals])
                for i, v in enumerate(vals):
                    enc[i][c] = v.astype(dt)
                meta[c] = ("raw", dt)
        return enc, meta

    def _wire_decode(self, rows: Dict[str, np.ndarray],
                     meta: Dict[str, tuple]) -> Dict[str, np.ndarray]:
        out = {}
        for c, v in rows.items():
            tag, extra = meta[c]
            if tag == "str":
                out[c] = extra[v.astype(np.int64)]
            elif tag == "date":
                out[c] = (np.datetime64("1970-01-01", "D")
                          + v.astype("timedelta64[D]"))
            else:
                out[c] = v.astype(extra)
        return out

    def _stack(self, enc: List[Dict[str, np.ndarray]]):
        """Pad-and-mask per-shard rows into sharded ``(n, cap)`` device
        buffers; cap is a pow2 bucket (matching the pipeline compiler) so
        buffer shapes repeat even when shard row counts are uneven or
        prime."""
        n = len(enc)
        counts = [len(next(iter(rows.values()))) if rows else 0
                  for rows in enc]
        cap = kops.bucket_size(max(counts + [1]), minimum=128)
        cols = {}
        for c in enc[0]:
            buf = np.zeros((n, cap), enc[0][c].dtype)
            for s in range(n):
                buf[s, :counts[s]] = enc[s][c]
            cols[c] = torch.from_numpy(buf).to(self.device)
        valid = np.zeros((n, cap), bool)
        for s in range(n):
            valid[s, :counts[s]] = True
        return cols, torch.from_numpy(valid).to(self.device), cap

    def _collective_fn(self, kind: str, out_cap: Optional[int],
                       schema: tuple):
        sig = (kind, out_cap, self.n_shards, schema)
        fn = self._collective_cache.get(sig)
        if fn is not None:
            return fn
        mesh = self.mesh
        if kind == "shuffle":
            def step(cols, valid, key):
                out, overflow = shuffle(Frame(cols, valid), key, mesh,
                                        out_cap)
                # out: sharded, row-major by shard (the reference's
                # P("data") out_spec); overflow: the psum, one value
                return out.columns, out.valid, overflow[0]
            fn = collective_step(step, mesh, label="shuffle")
        else:   # broadcast / merge: all rows everywhere, one copy returned
            def step(cols, valid):
                out = broadcast(Frame(cols, valid), mesh)
                return ({c: v[0] for c, v in out.columns.items()},
                        out.valid[0])
            fn = collective_step(step, mesh, label=kind)
        self._collective_cache[sig] = fn
        return fn

    def _collective(self, outs: List[Dict[str, np.ndarray]], kind: str,
                    key: Optional[str]) -> Dict[str, np.ndarray]:
        """Run one exchange as a collective over the mesh and return the
        compacted merged host rows for the registry (valid rows in
        shard-major order, selected on the device)."""
        enc, meta = self._wire_encode(outs)
        cols, valid, cap = self._stack(enc)
        schema = tuple(sorted((c, str(v.dtype)) for c, v in cols.items()))
        if kind == "shuffle":
            keys64 = [key_to_int64(rows[key]) for rows in outs]
            kcol, _, _ = self._stack([{"__k": k} for k in keys64])
            out_cap = self._out_cap(cap)
            fn = self._collective_fn("shuffle", out_cap, schema)
            scols, svalid, overflow = self._timed(
                "exchange", fn, cols, valid, kcol["__k"])
            if int(overflow) > 0:
                raise ExchangeOverflow
        else:
            fn = self._collective_fn(kind, None, schema)
            scols, svalid = self._timed("exchange", fn, cols, valid)
        sel = torch.nonzero(svalid.reshape(-1)).reshape(-1)
        rows = {c: v.reshape(-1)[sel].cpu().numpy() for c, v in scols.items()}
        return self._wire_decode(rows, meta)
