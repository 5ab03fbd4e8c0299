"""Buffer manager (paper §3.2.3) — counterpart of ``repro/buffer/manager.py``.

Two regions:

* **caching region** — pre-sized budget holding base-table columns resident on
  device ("hot run" semantics of §4.1).  Insertion from the host format is the
  cold-run deep copy; eviction spills LRU tables back to pinned host memory
  (numpy here) and re-promotion is transparent.
* **processing region** — an accounting pool for intermediates (hash tables,
  join outputs).  PyTorch's caching allocator owns real allocation; the pool
  tracks bytes so queries can be admission-controlled and peak usage
  reported, mirroring the RMM pool.

Also owns columnar format conversion host<->device (Arrow-derived zero-copy in
the paper; an explicit ``.to(device)`` here).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..observability.metrics import METRICS
from ..relational.table import Column, Table


class BufferError(RuntimeError):
    pass


class _CacheEntry:
    __slots__ = ("table", "nbytes", "last_used", "on_device", "host_copy", "meta")

    def __init__(self, table: Table, nbytes: int):
        self.table = table
        self.nbytes = nbytes
        self.last_used = time.monotonic()
        self.on_device = True
        self.host_copy: Optional[Dict[str, np.ndarray]] = None


class BufferManager:
    def __init__(self, caching_bytes: int, processing_bytes: int, device):
        self.device = torch.device(device)
        self.caching_capacity = caching_bytes
        self.processing_capacity = processing_bytes
        self._cache: Dict[str, _CacheEntry] = {}
        # per-table write generation: bumped on every (re-)cache so the
        # executable-plan cache can detect that a recorded plan read data
        # that has since been replaced (see core.plan_cache)
        self.table_epochs: Dict[str, int] = {}
        self.caching_used = 0
        self.processing_used = 0
        self.processing_peak = 0
        self.spill_count = 0
        self.promote_count = 0
        # host<->device traffic ledger: after the cold-run deep copy, the
        # only legitimate crossings are spills/promotions — pipeline
        # execution itself must contribute nothing (see core.instrument)
        self.cold_copy_bytes = 0
        self.host_transfer_bytes = 0

    # -- caching region -----------------------------------------------------
    def cache_table(self, name: str, table: Table) -> Table:
        """Cold-run load: deep-copy host columns into the device cache.

        Tensors already on the engine's device are held as they are."""
        self.table_epochs[name] = self.table_epochs.get(name, 0) + 1
        nbytes = table.nbytes
        self._make_room(nbytes)
        dev = Table({
            n: Column(c.data.to(self.device), c.kind, c.dictionary)
            for n, c in table.columns.items()
        })
        if name in self._cache:
            self.caching_used -= self._cache[name].nbytes
        self._cache[name] = _CacheEntry(dev, nbytes)
        self.caching_used += nbytes
        self.cold_copy_bytes += nbytes
        METRICS.counter("buffers.cold_copy_bytes").inc(nbytes)
        return dev

    def get(self, name: str) -> Table:
        e = self._cache.get(name)
        if e is None:
            raise BufferError(f"table {name!r} not cached")
        e.last_used = time.monotonic()
        if not e.on_device:
            self._promote(name, e)
        return e.table

    def has(self, name: str) -> bool:
        return name in self._cache

    def drop(self, name: str) -> None:
        e = self._cache.pop(name, None)
        if e and e.on_device:
            self.caching_used -= e.nbytes

    def _make_room(self, nbytes: int) -> None:
        if nbytes > self.caching_capacity:
            raise BufferError(
                f"table of {nbytes} bytes exceeds caching region "
                f"({self.caching_capacity})")
        while self.caching_used + nbytes > self.caching_capacity:
            victims = [(e.last_used, n) for n, e in self._cache.items() if e.on_device]
            if not victims:
                raise BufferError("caching region full and nothing to spill")
            _, victim = min(victims)
            self._spill(victim)

    def _spill(self, name: str) -> None:
        e = self._cache[name]
        e.host_copy = {
            n: c.data.cpu().numpy() for n, c in e.table.columns.items()
        }
        e.meta = {n: (c.kind, c.dictionary) for n, c in e.table.columns.items()}
        e.table = None  # release device refs
        e.on_device = False
        self.caching_used -= e.nbytes
        self.spill_count += 1
        self.host_transfer_bytes += e.nbytes
        METRICS.counter("buffers.spill_bytes").inc(e.nbytes)

    def _promote(self, name: str, e: _CacheEntry) -> None:
        self._make_room(e.nbytes)
        cols = {}
        for n, host in e.host_copy.items():
            kind, dictionary = e.meta[n]
            cols[n] = Column(torch.from_numpy(host).to(self.device), kind,
                             dictionary)
        e.table = Table(cols)
        e.host_copy = None
        e.on_device = True
        self.caching_used += e.nbytes
        self.promote_count += 1
        self.host_transfer_bytes += e.nbytes
        METRICS.counter("buffers.promote_bytes").inc(e.nbytes)

    # -- processing region ----------------------------------------------------
    def alloc_processing(self, nbytes: int) -> None:
        if self.processing_used + nbytes > self.processing_capacity:
            raise BufferError(
                f"processing region overflow: {self.processing_used + nbytes} "
                f"> {self.processing_capacity}")
        self.processing_used += nbytes
        self.processing_peak = max(self.processing_peak, self.processing_used)
        METRICS.gauge("buffers.processing_used").set(self.processing_used)

    def free_processing(self, nbytes: int) -> None:
        self.processing_used = max(0, self.processing_used - nbytes)

    def watermarks(self) -> dict:
        """Host-side ledger sample the query journal attaches to each
        query span: enough to spot a transfer or memory-pressure
        regression per query without any device interaction (all plain
        ints — never triggers a sync)."""
        return dict(
            host_transfer_bytes=self.host_transfer_bytes,
            caching_used=self.caching_used,
            processing_peak=self.processing_peak,
        )

    def stats(self) -> dict:
        return dict(
            caching_used=self.caching_used,
            caching_capacity=self.caching_capacity,
            processing_peak=self.processing_peak,
            spills=self.spill_count,
            promotions=self.promote_count,
            cold_copy_bytes=self.cold_copy_bytes,
            host_transfer_bytes=self.host_transfer_bytes,
            cached_tables=sorted(self._cache),
        )
