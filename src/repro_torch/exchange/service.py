"""Exchange service layer (paper §3.2.4) — counterpart of
``repro/exchange/service.py``.

Exchange is modeled as dedicated physical operators — broadcast, shuffle,
merge, multicast — NCCL primitives in the paper, ``shard_map`` + ``jax.lax``
collectives in the reference.  Here a mesh of **logical shards** lives on
one device (``ShardMesh``): a sharded buffer is a tensor whose leading axis
is the shard, ``(n_shards, cap, ...)``, and each collective is a plain
tensor operation over that axis —

* ``all_to_all``: the ``(n_src, n_dst, out_cap)`` send buckets transposed
  to ``(n_dst, n_src, out_cap)``;
* ``all_gather``: every shard's rows concatenated, seen by each shard;
* ``psum`` / ``pmax``: a reduction over the shard axis, seen by each shard.

These are the reference's semantics on its forced host devices, shard for
shard and row for row.  Collectives across several cards wait for a
multi-GPU configuration.

Everything operates on **static-shape shard frames**: per-shard
fixed-capacity column arrays plus a validity mask.  Overflow contract:
shuffles write into fixed receive buckets; an overflow count is returned
and checked by the coordinator, which repartitions with larger buckets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

MIX64 = -7046029254386353131  # golden-ratio mix


@dataclasses.dataclass
class Frame:
    """Static-capacity columnar batch.

    ``valid`` is ``(cap,)`` for one shard's frame, ``(n_shards, cap)`` for a
    sharded one; each column has the same leading dimensions, then its own
    trailing ones."""

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[-1])

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def with_mask(self, mask: torch.Tensor) -> "Frame":
        return Frame(self.columns, self.valid & mask)

    def select(self, names) -> "Frame":
        return Frame({n: self.columns[n] for n in names}, self.valid)

    def with_columns(self, **cols) -> "Frame":
        out = dict(self.columns)
        out.update(cols)
        return Frame(out, self.valid)

    def take(self, idx: torch.Tensor, taken_valid: torch.Tensor) -> "Frame":
        """Gather rows: ``idx`` is ``(k,)`` for one shard's frame, ``(n_shards,
        k)`` for a sharded one (each shard's own rows)."""
        return Frame({n: take_rows(c, idx) for n, c in self.columns.items()},
                     taken_valid)


def take_rows(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``col`` along the row axis, the last of ``idx``'s
    dimensions; ``col`` may carry trailing dimensions of its own."""
    rest = tuple(col.shape[idx.dim():])
    ix = idx.reshape(tuple(idx.shape) + (1,) * len(rest)).expand(
        tuple(idx.shape) + rest)
    return torch.gather(col, idx.dim() - 1, ix)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A mesh of logical shards on one device: named axes and their sizes,
    shard ``s`` at row-major position ``s`` (the reference's
    ``Mesh(devices.reshape(sizes), names)``).

    The shards share the device; a collective moves rows within its
    memory.  This is also where ``repro/core/compat.py``'s mesh role went:
    the port has no JAX versions to shim."""

    axes: Tuple[Tuple[str, int], ...]
    device: torch.device

    @staticmethod
    def of(n_shards: int, device, axis: str = "data") -> "ShardMesh":
        return ShardMesh(((axis, int(n_shards)),), torch.device(device))

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    def _dim(self, axis: str) -> int:
        for i, (name, _) in enumerate(self.axes):
            if name == axis:
                return i
        raise KeyError(f"mesh has no axis {axis!r}: {self.axes}")

    def axis_size(self, axis: str) -> int:
        return self.axes[self._dim(axis)][1]

    def axis_index(self, axis: str) -> torch.Tensor:
        """Each shard's index along ``axis``: ``(n_shards,)`` int64."""
        k = self._dim(axis)
        stride = math.prod(self.shape[k + 1:])
        return (torch.arange(self.size, device=self.device) // stride) \
            % self.axis_size(axis)

    # -- collectives over one axis (x: (n_shards, ...)) ----------------------
    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.shape + tuple(x.shape[1:]))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Shard ``s`` sends ``x[s, j]`` to its peer ``j`` along ``axis``
        and receives, at ``[.., j]``, what peer ``j`` sent it
        (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
        k, m = self._dim(axis), len(self.axes)
        return self._grid(x).transpose(k, m).reshape(x.shape)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        k = self._dim(axis)
        g = self._grid(x)
        return g.sum(k, keepdim=True).expand_as(g).reshape(x.shape)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        k = self._dim(axis)
        g = self._grid(x)
        return g.amax(k, keepdim=True).expand_as(g).reshape(x.shape)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``(n_shards, cap, ...)`` → ``(n_shards, a * cap, ...)``: each
        shard sees its ``axis`` group's rows in group order
        (``jax.lax.all_gather(tiled=True)``)."""
        k, m = self._dim(axis), len(self.axes)
        a, cap, rest = self.axis_size(axis), x.shape[1], tuple(x.shape[2:])
        g = self._grid(x).movedim(k, m - 1)           # group axis next to cap
        flat = g.reshape(g.shape[:m - 1] + (a * cap,) + rest)
        out = flat.unsqueeze(k).expand(
            flat.shape[:k] + (a,) + flat.shape[k:])
        return out.reshape((self.size, a * cap) + rest)


def partition_hash(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Destination shard of each key, int32 in [0, n_parts).

    Bit for bit the reference's: an int64 multiply that wraps, an
    arithmetic shift, Python-style modulo (``remainder``, not ``fmod``),
    then the int32 cast at the same point."""
    h = keys.to(torch.int64) * MIX64
    h = (h >> 33) ^ h
    return (torch.remainder(h, n_parts) + n_parts).to(torch.int32) % n_parts


# ---------------------------------------------------------------------------
# exchange operators (on sharded frames)
# ---------------------------------------------------------------------------


def shuffle(frame: Frame, keys: torch.Tensor, mesh: ShardMesh, out_cap: int,
            axis: str = "data") -> Tuple[Frame, torch.Tensor]:
    """Hash-repartition rows by ``keys`` across the ``axis`` shards."""
    n = mesh.axis_size(axis)
    dest = torch.where(frame.valid, partition_hash(keys, n), n)
    return shuffle_by_dest(frame, dest, mesh, out_cap, axis)


def shuffle_hierarchical(frame: Frame, key_name: str, mesh: ShardMesh,
                         pod_axis: str, data_axis: str, out_cap_pod: int,
                         out_cap_data: int) -> Tuple[Frame, torch.Tensor]:
    """Pod-aware two-stage shuffle: rows first cross the pod axis bucketed
    by destination pod, then fan out within the pod.  ``key_name`` must be
    a frame column so the second stage can re-derive destinations after
    the first exchange.

    The overflow count is the whole mesh's, on every shard: both stages'
    rows past their buckets, summed with one ``psum`` over each axis.  The
    reference sums each stage only along its own axis, so a shard misses
    the rows dropped outside its own pod and data groups (ROADMAP queue 3);
    both take two all-reduces of one count."""
    p = mesh.axis_size(pod_axis)
    d = mesh.axis_size(data_axis)
    g = partition_hash(frame.columns[key_name], p * d)
    fr, ov1 = _exchange_by_dest(frame, g // d, mesh, out_cap_pod, pod_axis)
    g2 = partition_hash(fr.columns[key_name], p * d) % d
    fr2, ov2 = _exchange_by_dest(fr, g2, mesh, out_cap_data, data_axis)
    return fr2, mesh.psum(mesh.psum(ov1 + ov2, pod_axis), data_axis)


def shuffle_by_dest(frame: Frame, dest: torch.Tensor, mesh: ShardMesh,
                    out_cap: int, axis: str = "data"
                    ) -> Tuple[Frame, torch.Tensor]:
    """Repartition rows to explicit destinations over ``axis``.

    Per shard: rows are grouped by destination (a *stable* argsort),
    packed into (n, out_cap) send buckets, exchanged with one
    ``all_to_all``, and flattened into a (n*out_cap,) frame.  Returns
    (received sharded frame, overflow count per shard, equal on all: the
    ``psum`` over ``axis``).  Invalid rows must carry dest >= n.  A row
    past its bucket goes to a dump slot past the end (the reference's
    ``mode="drop"``), never to an out-of-range index."""
    fr, overflow = _exchange_by_dest(frame, dest, mesh, out_cap, axis)
    return fr, mesh.psum(overflow, axis)


def _exchange_by_dest(frame: Frame, dest: torch.Tensor, mesh: ShardMesh,
                      out_cap: int, axis: str) -> Tuple[Frame, torch.Tensor]:
    """``shuffle_by_dest`` with each shard's own overflow count, not yet
    summed."""
    n = mesh.axis_size(axis)
    shards, cap = frame.valid.shape
    dev = frame.valid.device
    dest = torch.where(frame.valid, dest.to(torch.int64), n)

    order = torch.sort(dest, dim=1, stable=True).indices   # group by dest
    dest_sorted = torch.gather(dest, 1, order)
    bounds = torch.arange(n + 1, device=dev).expand(shards, n + 1).contiguous()
    start = torch.searchsorted(dest_sorted, bounds)        # (shards, n+1)
    pos_in_group = torch.arange(cap, device=dev) - torch.gather(
        start, 1, dest_sorted)
    counts = start[:, 1:] - start[:, :-1]
    overflow = torch.clamp(counts[:, :n] - out_cap, min=0).sum(1)

    in_bucket = (dest_sorted < n) & (pos_in_group < out_cap)
    slot = torch.where(in_bucket, dest_sorted * out_cap + pos_in_group,
                       n * out_cap)                        # dumped past the end
    rows = torch.arange(shards, device=dev).unsqueeze(1)

    def scatter(col: torch.Tensor) -> torch.Tensor:
        src = col[rows, order]
        buf = torch.zeros((shards, n * out_cap + 1) + tuple(col.shape[2:]),
                          dtype=col.dtype, device=dev)
        buf[rows, slot] = src
        return buf[:, :-1].reshape((shards, n, out_cap) + tuple(col.shape[2:]))

    def exchange(buf: torch.Tensor) -> torch.Tensor:
        r = mesh.all_to_all(buf, axis)
        return r.reshape((shards, n * out_cap) + tuple(r.shape[3:]))

    sent_valid = torch.zeros((shards, n * out_cap + 1), dtype=torch.bool,
                             device=dev)
    sent_valid[rows, slot] = in_bucket
    recv_valid = exchange(sent_valid[:, :-1].reshape(shards, n, out_cap))
    recv_cols = {name: exchange(scatter(col))
                 for name, col in frame.columns.items()}
    return Frame(recv_cols, recv_valid), overflow


def broadcast(frame: Frame, mesh: ShardMesh, axis: str = "data") -> Frame:
    """All shards receive every shard's rows (build-side replication)."""
    cols = {name: mesh.all_gather(col, axis)
            for name, col in frame.columns.items()}
    return Frame(cols, mesh.all_gather(frame.valid, axis))


def merge(frame: Frame, mesh: ShardMesh, axis: str = "data") -> Frame:
    """Gather all rows everywhere; the coordinator reads shard 0's copy."""
    return broadcast(frame, mesh, axis)


def multicast(frame: Frame, mesh: ShardMesh, group_size: int,
              axis: str = "data") -> Frame:
    """Replicate rows within disjoint shard groups (paper's multi-cast)."""
    n = mesh.axis_size(axis)
    full = broadcast(frame, mesh, axis)
    group = mesh.axis_index(axis) // group_size
    member = (torch.arange(n, device=mesh.device) // group_size
              == group.unsqueeze(1))                       # (shards, n)
    keep = member.repeat_interleave(frame.capacity, dim=1)
    return Frame(full.columns, full.valid & keep)


def all_reduce_sum(x: torch.Tensor, mesh: ShardMesh,
                   axis: str = "data") -> torch.Tensor:
    return mesh.psum(x, axis)


def collective_step(fn, mesh: ShardMesh, label: Optional[str] = None):
    """The one wrapper the distributed executor puts around every
    collective step (counterpart of the reference's ``compiled_shard_map``:
    nothing to compile here, the step runs eagerly).

    With ``label``, every invocation journals a ``collective:<label>``
    span measuring the host-side **dispatch wall** (enqueue, not device
    completion — the caller's own barrier times that); spans are dropped
    outside a query context, so the label costs nothing standalone."""
    if label is None:
        return fn
    from ..observability.journal import JOURNAL

    def dispatch(*args):
        with JOURNAL.span(f"collective:{label}", "collective",
                          shards=mesh.size):
            return fn(*args)
    return dispatch

