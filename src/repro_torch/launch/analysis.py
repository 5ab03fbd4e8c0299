"""What a fragment moves and holds, counted from the operations that run —
counterpart of ``repro/launch/hlo_analysis.py``.

The reference reads a compiled XLA program: collective bytes from its HLO
text, bytes accessed and FLOPs from ``cost_analysis()``, memory from
``memory_analysis()``.  The port has no HLO, so it counts an eager run:

* ``CountingMesh``: a ``ShardMesh`` whose four collectives add their result
  bytes per shard, by ``hlo_analysis.py``'s rules: each ``all_to_all``,
  ``all_gather``, ``psum`` and ``pmax`` adds the bytes of its result on one
  shard, and an all-reduce (``psum``, ``pmax``) counts double (a
  reduce-scatter and an all-gather).  The kinds carry the HLO names
  (``all-to-all``, ``all-gather``, ``all-reduce``).
* ``OpCounter``: a ``TorchDispatchMode`` that adds, for every op that
  returns a tensor and is not a view, the bytes of its tensor inputs and
  outputs (what an eager
  run reads and writes: the counterpart of ``hbm_traffic_estimate``) and,
  for pointwise ops, their output elements; and that tracks every storage
  an op allocates from its creation until it is freed, keeping the most
  bytes live at once.

Run under ``FakeTensorMode`` with tensors on ``cuda``, nothing is
allocated and no card is needed, and the run takes the branches the card
takes (``relational/aggregate.py::segment_sum`` sums floats on the card in
fixed point).  A build of PyTorch without CUDA cannot make the CUDA device
guard that the bindings of indexing, ``~``, ``contiguous`` and ``copy_``
create; ``fake_cuda()`` then routes those through the aten ops they stand
for.

``dot_flops`` and ``loop_corrected_flops`` (``hlo_analysis.py:170–233``)
count matmuls for the model cells; they wait for the model half of the
dry run (ROADMAP queue 1).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..exchange.service import ShardMesh

ALL_REDUCE = "all-reduce"


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class CountingMesh(ShardMesh):
    """A ``ShardMesh`` that counts the bytes its collectives move per
    shard, by kind."""

    counts: Dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False, hash=False)

    @staticmethod
    def like(mesh: ShardMesh) -> "CountingMesh":
        return CountingMesh(mesh.axes, mesh.device)

    def _add(self, kind: str, out: torch.Tensor) -> torch.Tensor:
        factor = 2.0 if kind == ALL_REDUCE else 1.0
        self.counts[kind] = (self.counts.get(kind, 0.0)
                             + factor * nbytes(out) / self.size)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._add("all-to-all", super().all_to_all(x, axis))

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._add("all-gather", super().all_gather(x, axis))

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._add(ALL_REDUCE, super().psum(x, axis))

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._add(ALL_REDUCE, super().pmax(x, axis))

    def collective_bytes(self) -> Dict[str, float]:
        """→ ``{kind: bytes per shard, ..., 'total': bytes per shard}``
        (``hlo_analysis.collective_bytes``'s keys; no loops here)."""
        return {**self.counts, "total": sum(self.counts.values())}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Bytes accessed, pointwise element operations and peak live bytes of
    the aten ops run under it (totals over all shards of a sharded run)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes_accessed = 0
        self.element_ops = 0
        self.live = 0
        self.peak = 0
        self.by_op: Dict[str, List[int]] = {}      # op -> [calls, bytes]
        self._storages: Dict[int, List[int]] = {}   # key -> [bytes, refs]

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._storages[key][1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in self._storages:              # a view or in place
                self._hold(t, key)
            elif key not in in_keys:               # a new allocation
                self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._storages[key][0]
                self._hold(t, key)
        self.peak = max(self.peak, self.live)
        if outs and not func.is_view:        # metadata queries move nothing
            moved = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
            self.ops += 1
            self.bytes_accessed += moved
            entry = self.by_op.setdefault(str(func), [0, 0])
            entry[0] += 1
            entry[1] += moved
            if torch.Tag.pointwise in func.tags:
                self.element_ops += sum(t.numel() for t in outs)
        return out


# ---------------------------------------------------------------------------
# fake CUDA tensors on a build without CUDA
# ---------------------------------------------------------------------------

aten = torch.ops.aten


def _basic(x: torch.Tensor, index) -> tuple:
    """Apply the basic part of a Python index (ints, slices, None,
    Ellipsis) as aten views, as ``THPVariable_getitem`` does; → (view, the
    advanced index tensors by dimension of the view, or None)."""
    index = index if isinstance(index, tuple) else (index,)
    if any(i is Ellipsis for i in index):
        at = next(k for k, i in enumerate(index) if i is Ellipsis)
        used = sum(1 for i in index if i is not None and i is not Ellipsis)
        index = (index[:at] + (slice(None),) * (x.dim() - used)
                 + index[at + 1:])
    view, dim, adv = x, 0, []
    for i in index:
        if i is None:
            view = aten.unsqueeze.default(view, dim)
            adv.append(None)
            dim += 1
        elif isinstance(i, slice):
            view = aten.slice.Tensor(view, dim, i.start, i.stop, i.step or 1)
            adv.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor):
            adv.append(i)
            dim += 1
        else:
            view = aten.select.int(view, dim, int(i))
    while adv and adv[-1] is None:
        adv.pop()
    return view, adv


def _getitem(x: torch.Tensor, index):
    view, adv = _basic(x, index)
    return aten.index.Tensor(view, adv) if adv else view


def _setitem(x: torch.Tensor, index, value) -> None:
    view, adv = _basic(x, index)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    if adv:
        aten.index_put_.default(view, adv, value)
    else:
        aten.copy_.default(view, value)


class _AtenIndexing(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__getitem__":
            return _getitem(*args)
        if name == "__setitem__":
            return _setitem(*args)
        if name == "contiguous" and not kwargs and len(args) == 1:
            x = args[0]
            return x if x.is_contiguous() else aten.clone.default(
                x, memory_format=torch.contiguous_format)
        if name == "copy_":
            return aten.copy_.default(*args, **kwargs)
        if name == "__invert__":
            return aten.bitwise_not.default(*args)
        return func(*args, **kwargs)


class _ShapeOnly(TorchDispatchMode):
    """Fake ``cumsum`` by its shape: the fake kernel PyTorch falls back to
    is the reference decomposition, which builds an (n, n) mask."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.cumsum.default:
            x, dtype = args[0], kwargs.get("dtype")
            if dtype is None:
                dtype = (torch.int64 if not x.dtype.is_floating_point
                         and not x.dtype.is_complex else x.dtype)
            return torch.empty(x.shape, dtype=dtype, device=x.device)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_cuda() -> Iterator[torch.device]:
    """Fake tensors on ``cuda``: shapes, dtypes and the card's branches,
    no allocation, no card (→ the device to make them on)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with contextlib.ExitStack() as stack:
        stack.enter_context(FakeTensorMode())
        stack.enter_context(_ShapeOnly())
        if not torch.backends.cuda.is_built():
            stack.enter_context(_AtenIndexing())
        yield torch.device("cuda")
