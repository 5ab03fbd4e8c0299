"""Sync accounting: count the host waits the data path takes.

Counterpart of ``repro/core/instrument.py``.  Two thread-safe counters,
mirrored into ``observability.METRICS``:

* ``scalar_syncs`` — every dynamic-cardinality or eligibility scalar the
  engine reads back from the device goes through ``pull_scalar``
  (``.item()`` on a tensor), and each such read is counted;
* ``sync_barriers`` — the executor's explicit barriers
  (``torch.cuda.synchronize()`` at the final sink, or per operator in
  ``profile=True`` mode), counted through ``count_sync``.

``pipeline_scope`` marks worker threads that are executing a pipeline.
The reference's record/replay protocol and ``track_transfers`` belong to
the plan cache, which this package does not have yet.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

from ..observability.metrics import METRICS


class _SyncCounter:
    """Thread-safe counter for host waits."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self) -> None:
        with self._lock:
            self._value += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


sync_barriers = _SyncCounter()
scalar_syncs = _SyncCounter()


def count_sync() -> None:
    """Record one explicit executor barrier."""
    sync_barriers.inc()
    METRICS.counter("executor.sync_barriers").inc()


def barrier(device: torch.device) -> None:
    """Wait for ``device`` to finish its queued work, and count the wait."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    count_sync()


def pull_scalar(x):
    """Read a device scalar (dynamic row count, eligibility bit) on the host.

    Tensors are read with ``.item()`` and counted into ``scalar_syncs``;
    host values (python or numpy scalars) pass through uncounted.
    """
    if isinstance(x, torch.Tensor):
        scalar_syncs.inc()
        METRICS.counter("executor.scalar_syncs").inc()
        return x.item()
    return x.item() if hasattr(x, "item") else x


_local = threading.local()


def _depth() -> int:
    return getattr(_local, "pipeline_depth", 0)


@contextlib.contextmanager
def pipeline_scope() -> Iterator[None]:
    """Marks the current thread as executing a pipeline (worker threads)."""
    _local.pipeline_depth = _depth() + 1
    try:
        yield
    finally:
        _local.pipeline_depth = _depth() - 1
