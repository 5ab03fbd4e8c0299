"""Sync accounting: count the host waits the data path takes.

Counterpart of ``repro/core/instrument.py``.  Two thread-safe counters,
mirrored into ``observability.METRICS``:

* ``scalar_syncs`` — every dynamic-cardinality or eligibility scalar the
  engine reads back from the device goes through ``pull_scalar``
  (``.item()`` on a tensor), and each such read is counted;
* ``sync_barriers`` — the executor's explicit barriers
  (``torch.cuda.synchronize()`` at the final sink, or per operator in
  ``profile=True`` mode), counted through ``count_sync``.

``pipeline_scope`` marks worker threads that are executing a pipeline, and
``track_transfers`` counts device→host copies of tensors inside and outside
that scope, so a test can assert that the data path stays on the device.
A ``pull_scalar`` read is counted in ``scalar_syncs`` and not as a
transfer, as in the reference, whose ``track_transfers`` watches
``np.asarray`` and whose scalar pulls do not pass through it.  The
reference's record/replay protocol belongs to the plan cache, which this
package does not have yet.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

from ..observability.metrics import METRICS


class TransferCounter:
    """Counts device→host copies (see ``track_transfers``); thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0            # all counted copies
        self.in_pipeline = 0      # …of which inside pipeline execution

    def record(self, in_pipeline: bool) -> None:
        with self._lock:
            self.total += 1
            if in_pipeline:
                self.in_pipeline += 1


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


# the unpatched read: pull_scalar's syncs are counted in scalar_syncs,
# never by track_transfers
_ITEM = torch.Tensor.item


def pull_scalar(x):
    """Read a device scalar (dynamic row count, eligibility bit) on the host.

    Tensors are read with ``.item()`` and counted into ``scalar_syncs``;
    host values (python or numpy scalars) pass through uncounted.
    """
    if isinstance(x, torch.Tensor):
        scalar_syncs.inc()
        METRICS.counter("executor.scalar_syncs").inc()
        return _ITEM(x)
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


# the Tensor methods that copy device data to the host
_COPY_METHODS = ("cpu", "numpy", "item", "tolist", "to",
                 "__bool__", "__int__", "__float__", "__index__")
_patch_lock = threading.Lock()


def _targets_host(args, kwargs) -> bool:
    """True when ``Tensor.to(*args, **kwargs)`` moves the tensor to the CPU."""
    dev = kwargs.get("device")
    if dev is None and args:
        a = args[0]
        if isinstance(a, torch.Tensor):
            dev = a.device
        elif isinstance(a, (str, torch.device)):
            dev = a
    return dev is not None and torch.device(dev).type == "cpu"


@contextlib.contextmanager
def track_transfers(device_type: str = "cuda") -> Iterator[TransferCounter]:
    """Count device→host copies of tensors until the context exits.

    Patches the ``torch.Tensor`` methods that copy to the host (``.cpu()``,
    ``.numpy()``, ``.item()``, ``.tolist()``, ``.to(<cpu>)`` and the
    ``bool``/``int``/``float``/index conversions) process-wide — tests and
    smoke runs only, not a production mode — and counts each call on a
    tensor whose device type is ``device_type``.  With ``"cpu"`` the same
    calls are counted on a CPU run, where they are the copies a card run
    would make.  Nesting is not supported; concurrent entry is serialized.
    Counts mirror into ``METRICS`` under ``instrument.transfers.total`` /
    ``instrument.transfers.in_pipeline``.
    """
    counter = TransferCounter()

    def counting(name, orig):
        def method(self, *args, **kwargs):
            if self.device.type == device_type and (
                    name != "to" or _targets_host(args, kwargs)):
                in_pipe = _depth() > 0
                counter.record(in_pipe)
                METRICS.counter("instrument.transfers.total").inc()
                if in_pipe:
                    METRICS.counter("instrument.transfers.in_pipeline").inc()
            return orig(self, *args, **kwargs)
        return method

    with _patch_lock:
        own = {m: vars(torch.Tensor).get(m) for m in _COPY_METHODS}
        for m in _COPY_METHODS:
            setattr(torch.Tensor, m, counting(m, getattr(torch.Tensor, m)))
    try:
        yield counter
    finally:
        with _patch_lock:
            for m, orig in own.items():
                if orig is None:      # inherited from the C base class
                    delattr(torch.Tensor, m)
                else:
                    setattr(torch.Tensor, m, orig)
