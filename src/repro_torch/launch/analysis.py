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
  (``all-to-all``, ``all-gather``, ``all-reduce``, ``reduce-scatter``).
  Its ``shard_*`` collectives serve a program of one shard (the model
  cells): they take that shard's tensor and return one of the
  collective's result shape, counted by the same rules.
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

``OpCounter`` also counts matmul FLOPs, the counterpart of ``dot_flops``
(``hlo_analysis.py:170``): ``2 x |result| x (product of the contracted
sizes)`` for every matmul aten op that runs (``mm``, ``addmm``, ``bmm``,
``baddbmm``, ``mv``, ``addmv``, ``dot``: what ``F.linear``, ``@``,
``matmul`` and ``einsum`` lower to), by op, and for the shape-only
``repro_torch.decode_attention`` op by its formula.  ``loop_corrected_flops``
keeps the reference's keys.

Loops.  The reference's ``cost_analysis`` counts a while body once and
``dot_flops`` multiplies it by its trip count.  An eager run has no loop to
correct: every op it runs is counted where it runs.  The model cells'
shard programs run their long loops of identical iterations (the q and kv
blocks of ``blockwise_attention``, Mamba's time steps) through
``models/layers.py``'s loop helpers, which the dry run may let run one
iteration standing for ``n``: inside ``OpCounter.iteration(n)`` every op
counts ``n`` times, and so does the backward of every autograd node made
there (``mult`` in the node's metadata, read while the backward runs); a
storage made in the iteration and still live at its end (an output kept,
a tensor saved for the backward) stands for ``n`` of them until it is
freed.  ``tests/test_torch_launch_models.py`` holds such a run against the
same program run whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

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

    # -- one shard's program (launch/model_dryrun.py): ``x`` is one
    # shard's tensor, and the result one shard's, of the collective's shape
    def _axes_size(self, axes) -> int:
        return math.prod(self.axis_size(a) for a in axes)

    def _add_shard(self, kind: str, out: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
        factor = 2.0 if kind == ALL_REDUCE else 1.0
        self.counts[kind] = (self.counts.get(kind, 0.0)
                             + factor * scale * nbytes(out))
        return out

    def shard_all_gather(self, x: torch.Tensor, axes, dim: int,
                         scale: float = 1.0) -> torch.Tensor:
        """``x`` gathered along ``dim`` over ``axes`` (the pieces tiled
        in order; on real tensors the shard's own piece repeated)."""
        reps = [1] * x.dim()
        reps[dim] = self._axes_size(axes)
        return self._add_shard("all-gather", x.repeat(reps), scale)

    def shard_reduce_scatter(self, x: torch.Tensor, axes, dim: int,
                             scale: float = 1.0) -> torch.Tensor:
        """The summed ``x``'s piece along ``dim`` over ``axes`` (on real
        tensors: the shard's own first piece)."""
        n = self._axes_size(axes)
        out = x.narrow(dim, 0, x.shape[dim] // n).clone()
        return self._add_shard("reduce-scatter", out, scale)

    def shard_all_reduce(self, x: torch.Tensor, axes,
                         scale: float = 1.0) -> torch.Tensor:
        """``x`` summed over ``axes``, out of place (on real tensors: a
        copy of the shard's own)."""
        return self._add_shard(ALL_REDUCE, x.clone(), scale)

    def collective_bytes(self) -> Dict[str, float]:
        """→ ``{kind: bytes per shard, ..., 'total': bytes per shard}``
        (``hlo_analysis.collective_bytes``'s keys; no loops here)."""
        return {**self.counts, "total": sum(self.counts.values())}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


aten = torch.ops.aten


def _contracted(func, args) -> Optional[int]:
    """The contracted size of a matmul aten op (None for any other op)."""
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default, aten.vdot.default):
        return args[0].shape[-1]
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        return args[1].shape[-1]
    return None


def matmul_flops(func, args, outs) -> int:
    """``2 x |result| x contracted size`` of a matmul op, the formula of the
    shape-only decode attention op, else 0."""
    if func is _DECODE_ATTENTION:
        from ..kernels.decode_attention import decode_attention_flops
        return decode_attention_flops(args[0].shape, args[1].shape)
    k = _contracted(func, args)
    if k is None:
        return 0
    return 2 * k * sum(t.numel() for t in outs)


def _decode_attention_op():
    from ..kernels import decode_attention  # noqa: F401 — defines the op
    return torch.ops.repro_torch.decode_attention.default


_DECODE_ATTENTION = _decode_attention_op()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested in tuples, lists
    and dicts), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _grad_fns(tree) -> list:
    return [t.grad_fn for t in _tensors(tree, []) if t.grad_fn is not None]


class _Tagger(TorchFunctionMode):
    """Marks every autograd node a function makes inside an iteration (a
    composite function such as ``einsum`` makes several: those between its
    outputs' nodes and its inputs') with the iteration's multiplier, for
    the backward to read; and counts the iteration's uses of tensors made
    before it (``carry`` aside): each use sends a gradient of the tensor's
    size back to it, which the backward of the whole loop would add up."""

    def __init__(self, mult: float, carry=()):
        super().__init__()
        self.mult = mult
        self.carry = {id(t) for t in carry}
        self.inside: set = set()
        self.uses: Dict[int, List] = {}          # id → [tensor, uses]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs), [])
        for t in ins:
            if (t.requires_grad and id(t) not in self.carry
                    and t.grad_fn not in self.inside):
                self.uses.setdefault(id(t), [t, 0])[1] += 1
        stop = set(_grad_fns(ins))
        out = func(*args, **kwargs)
        todo = _grad_fns(out)
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in self.inside \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            self.inside.add(node)
            node.metadata["mult"] = self.mult
            todo.extend(n for n, _ in node.next_functions)
        return out


class OpCounter(TorchDispatchMode):
    """Bytes accessed, pointwise element operations, matmul FLOPs and peak
    live bytes of the aten ops run under it (totals over all shards of a
    sharded run; one shard's in a shard program)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes_accessed = 0
        self.element_ops = 0
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.by_op: Dict[str, List[int]] = {}      # op -> [calls, bytes]
        self.flops_by_op: Dict[str, int] = {}
        self._storages: Dict[int, List[int]] = {}   # key -> [bytes, refs]
        self._mults: List[float] = [1.0]
        self._made: List[set] = []                  # keys made per iteration

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._storages[key][1] += 1
        weakref.finalize(t, self._release, key)

    @contextlib.contextmanager
    def iteration(self, n: int, carry=lambda: ()):
        """One iteration standing for ``n``: ops count ``n`` times (their
        backward too, and the adding up of the gradients the other
        iterations would send back), and each storage made here that
        outlives it stands for ``n`` (but those of ``carry()``, a fold's
        carried tensors, where autograd is not recording: the next
        iteration would free them).  ``carry()`` is called on entry (the
        carry in, whose uses send no gradient to add up) and on exit."""
        carry_in = carry()
        self._mults.append(self._mults[-1] * n)
        self._made.append(set())
        tagger = _Tagger(self._mults[-1], carry_in) \
            if torch.is_grad_enabled() else None
        try:
            with tagger or contextlib.nullcontext():
                yield
        finally:
            self._mults.pop()
            made = self._made.pop()
            if self._made:
                self._made[-1] |= made
        if tagger is not None and torch._C._current_autograd_node() is None:
            # the n - 1 iterations not run would each have sent a gradient
            # to every tensor this one used from before it: the backward
            # adds them up (a recompute inside the backward adds nothing)
            for t, uses in tagger.uses.values():
                self._count("aten.add.Tensor", (n - 1) * uses
                            * self._mults[-1], 3 * nbytes(t), t.numel())
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in carry())):
            made -= {_storage_key(t) for t in carry()}
        for key in made & self._storages.keys():
            entry = self._storages[key]
            self.live += (n - 1) * entry[0]
            entry[0] *= n
        self.peak = max(self.peak, self.live)

    def _count(self, op: str, m: float, moved: int, elements: int) -> None:
        self.ops += m
        self.bytes_accessed += m * moved
        self.element_ops += m * elements
        entry = self.by_op.setdefault(op, [0, 0])
        entry[0] += m
        entry[1] += m * moved

    def _mult(self) -> float:
        node = torch._C._current_autograd_node()
        m = self._mults[-1]
        if node is not None:
            m *= node.metadata.get("mult", 1.0)
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in self._storages:              # a view or in place
                self._hold(t, key)
            elif key not in in_keys:               # a new allocation
                self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._storages[key][0]
                self._hold(t, key)
                if self._made:
                    self._made[-1].add(key)
        self.peak = max(self.peak, self.live)
        if outs and not func.is_view:        # metadata queries move nothing
            m = self._mult()
            moved = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
            self.ops += m
            self.bytes_accessed += m * moved
            entry = self.by_op.setdefault(str(func), [0, 0])
            entry[0] += m
            entry[1] += m * moved
            if torch.Tag.pointwise in func.tags:
                self.element_ops += m * sum(t.numel() for t in outs)
            flops = matmul_flops(func, args, outs)
            if flops:
                self.flops += m * flops
                self.flops_by_op[str(func)] = (
                    self.flops_by_op.get(str(func), 0) + m * flops)
        return out


def loop_corrected_flops(counter: OpCounter, n: int = 1) -> dict:
    """The reference's ``loop_corrected_flops`` keys for a counted run, per
    shard of ``n``: ``cost_analysis_flops`` all counted FLOPs (matmul FLOPs
    and one per pointwise output element), ``dot_flops_loop_corrected``
    the matmuls only, ``flops`` the larger.  An eager run has no loop to
    correct (the module docstring says how a sampled iteration counts)."""
    dot = counter.flops / n
    cost = (counter.flops + counter.element_ops) / n
    return {"cost_analysis_flops": cost, "dot_flops_loop_corrected": dot,
            "flops": max(dot, cost),
            "dot_flops_by_op": {k: v / n for k, v in sorted(
                counter.flops_by_op.items(), key=lambda kv: -kv[1])}}


# ---------------------------------------------------------------------------
# fake CUDA tensors on a build without CUDA
# ---------------------------------------------------------------------------


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
