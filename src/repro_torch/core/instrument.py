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
``np.asarray`` and whose scalar pulls do not pass through it.

``pull_scalar`` also records and replays, for the executable-plan cache
(``core.plan_cache``): a cold run under ``scalar_recording`` appends every
pulled value; a warm run under ``scalar_replay`` is served those values
without a sync, and each device scalar leaves a device-side
``x != recorded`` flag that the executor folds into the query's one
barrier.
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


def read_after_barrier(x: torch.Tensor):
    """Read a device scalar the query's barrier has already materialized
    (the replay flags): no wait, so counted neither as a sync nor as a
    transfer, as the reference's ``bool(flag)`` after its barrier is not."""
    return _ITEM(x)


_local = threading.local()


class ReplayMismatch(Exception):
    """A replayed execution diverged structurally from its recording.

    Raised when a warm run performs more or fewer pulls than the cold run
    recorded, or a host-side scalar differs from its recording.  (Value
    divergence of a device scalar is detected at the final barrier through
    the device-side flags, not here.)  The executor invalidates the entry
    and re-runs cold."""


class _ScalarCtx:
    __slots__ = ("mode", "values", "pos", "flags")

    def __init__(self, mode: str, values: list, flags: list = None):
        self.mode = mode          # "record" | "replay"
        self.values = values
        self.pos = 0
        self.flags = flags


def _materialize(x):
    return x.item() if hasattr(x, "item") else x


def pull_scalar(x):
    """Read a device scalar (dynamic row count, eligibility bit) on the host.

    * **normal** — tensors are read with ``.item()`` and counted into
      ``scalar_syncs``; host values (python or numpy scalars) pass through
      uncounted;
    * **record** (cold run under the plan cache) — the same, and the value
      is appended to the active recording;
    * **replay** (warm run) — the recorded value comes back without a sync;
      for a tensor the ``x != recorded`` test stays on the device, in the
      replay's flags.
    """
    ctx = getattr(_local, "scalar_ctx", None)
    if ctx is not None and ctx.mode == "replay":
        if ctx.pos >= len(ctx.values):
            raise ReplayMismatch(
                f"replay exhausted after {len(ctx.values)} recorded pulls")
        v = ctx.values[ctx.pos]
        ctx.pos += 1
        if isinstance(x, torch.Tensor):
            ctx.flags.append((x != v).reshape(()))
        elif _materialize(x) != v:
            raise ReplayMismatch("host-side scalar diverged from recording")
        return v
    if isinstance(x, torch.Tensor):
        scalar_syncs.inc()
        METRICS.counter("executor.scalar_syncs").inc()
        v = _ITEM(x)
    else:
        v = _materialize(x)
    if ctx is not None and ctx.mode == "record":
        ctx.values.append(v)
    return v


@contextlib.contextmanager
def scalar_recording(values: list) -> Iterator[None]:
    """Append every ``pull_scalar`` value on this thread to ``values``."""
    prev = getattr(_local, "scalar_ctx", None)
    _local.scalar_ctx = _ScalarCtx("record", values)
    try:
        yield
    finally:
        _local.scalar_ctx = prev


@contextlib.contextmanager
def scalar_replay(values: list, flags: list) -> Iterator[None]:
    """Serve ``pull_scalar`` calls from ``values`` without syncing.

    Device-side ``!=`` flags accumulate into ``flags``; the caller folds
    them into its final barrier and treats any set flag as a cache
    invalidation.  Raises ``ReplayMismatch`` if the pull sequence outruns
    the recording or ends short of it."""
    prev = getattr(_local, "scalar_ctx", None)
    ctx = _ScalarCtx("replay", values, flags)
    _local.scalar_ctx = ctx
    try:
        yield
        if ctx.pos != len(values):
            raise ReplayMismatch(
                f"replay consumed {ctx.pos} of {len(values)} recorded pulls")
    finally:
        _local.scalar_ctx = prev


@contextlib.contextmanager
def pulls_suspended() -> Iterator[None]:
    """Temporarily drop out of record/replay (prepare-time code paths:
    probe lowering) so their pulls never join a schedule."""
    prev = getattr(_local, "scalar_ctx", None)
    _local.scalar_ctx = None
    try:
        yield
    finally:
        _local.scalar_ctx = prev


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
