"""Join operators — counterpart of ``repro/relational/join.py``.

``hash_join`` is sort-merge on factorized keys, exact for any
multiplicity: match counting (stable argsort + two searchsorted), then the
run expansion into gather indices.  The dynamic output size is the single
scalar pull between the two.  With a kernel backend attached the run
expansion goes to the ``join_expand`` CUDA kernel.  Supports inner / left /
semi / anti / mark.

The static-shape tier: ``hash_join_bounded`` (the same join under a
cardinality cap, with no host sync for single-column keys) and
``StaticHashTable``, an atomics-free open-addressing table built by
multi-round masked scatter and probed linearly (build keys unique).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.instrument import pull_scalar
from ..kernels import ops as kops
from ..kernels.ref import join_expand_ref
from .table import BOOL, STRING, Column, Table, unify_string_keys

# ---------------------------------------------------------------------------
# key factorization (multi-column keys -> single int64 key)
# ---------------------------------------------------------------------------


def _minmax(*arrays) -> Tuple[int, int]:
    """(min, max) over possibly-empty device tensors, as python ints."""
    lo, hi = 0, 0
    for a in arrays:
        if a.shape[0]:
            lo = min(lo, pull_scalar(a.min()))
            hi = max(hi, pull_scalar(a.max()))
    return lo, hi


def _rank_in_union(l: torch.Tensor, r: torch.Tensor):
    """Order-preserving integer codes for the values of two tensors.

    Equal values get equal codes (their first position in the sorted
    union), so matching is exact; the codes need not be dense."""
    both = torch.sort(torch.cat([l, r])).values
    return torch.searchsorted(both, l), torch.searchsorted(both, r)


def _as_int_keys(left: Column, right: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bring a (probe, build) key column pair into a shared integer space."""
    if left.kind == STRING or right.kind == STRING:
        left, right = unify_string_keys(left, right)
    l, r = left.data, right.data
    if l.dtype.is_floating_point or r.dtype.is_floating_point:
        # factorize floats exactly through their rank in the union
        common = torch.promote_types(l.dtype, r.dtype)
        l, r = _rank_in_union(l.to(common), r.to(common))
    return l.to(torch.int64), r.to(torch.int64)


def combine_keys(probe_cols: Sequence[Column], build_cols: Sequence[Column]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack multi-column join keys into one int64 key per row (exact)."""
    if len(probe_cols) != len(build_cols) or not probe_cols:
        raise ValueError("join needs the same number (>= 1) of keys per side")
    pk, bk = _as_int_keys(probe_cols[0], build_cols[0])
    if len(probe_cols) == 1:
        # sort-merge matching is sign-agnostic: single-key joins need no
        # normalization, hence zero metadata pulls
        return pk, bk
    base_min, _ = _minmax(pk, bk)
    pk, bk = pk - base_min, bk - base_min
    for pc, bc in zip(probe_cols[1:], build_cols[1:]):
        p2, b2 = _as_int_keys(pc, bc)
        m, mx = _minmax(p2, b2)
        p2, b2 = p2 - m, b2 - m
        card = mx - m + 1
        _, hi = _minmax(pk, bk)
        if hi * card > 2**62:
            # re-factorize to ranks to avoid overflow
            pk, bk = _rank_in_union(pk, bk)
        pk = pk * card + p2
        bk = bk * card + b2
    return pk, bk


# ---------------------------------------------------------------------------
# eager join (dynamic shapes)
# ---------------------------------------------------------------------------


def join_match(pk: torch.Tensor, bk: torch.Tensor):
    """Sort-merge match counting → (build order, lo, counts).

    The argsort must be stable (equal build keys keep their row order),
    as ``jnp.argsort`` is and torch's default sort is not."""
    order = torch.sort(bk, stable=True).indices
    bk_sorted = bk[order]
    lo = torch.searchsorted(bk_sorted, pk, side="left")
    hi = torch.searchsorted(bk_sorted, pk, side="right")
    return order, lo, hi - lo


def _empty_build_join(probe: Table, build: Table, how: str,
                      mark_name: str) -> Table:
    n = probe.num_rows
    device = probe.device
    if how == "mark":
        return probe.with_column(mark_name, Column(
            torch.zeros(n, dtype=torch.bool, device=device), BOOL))
    if how == "anti":
        return probe
    if how == "left":
        out = dict(probe.columns)
        for name, col in build.columns.items():
            if name not in out:
                out[name] = Column(torch.zeros(n, dtype=col.data.dtype,
                                               device=device),
                                   col.kind, col.dictionary)
        out["__matched"] = Column(torch.zeros(n, dtype=torch.bool,
                                              device=device), BOOL)
        return Table(out)
    # inner / semi: no matches
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    out = {name: col.take(empty) for name, col in probe.columns.items()}
    if how == "inner":
        for name, col in build.columns.items():
            if name not in out:
                out[name] = col.take(empty)
    return Table(out)


def hash_join(
    probe: Table,
    build: Table,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    how: str = "inner",
    mark_name: str = "__mark",
    backend=None,
) -> Table:
    """Join ``probe`` against ``build``.

    how = inner | left | semi | anti | mark.
    ``left`` adds a ``__matched`` BOOL column; build columns of unmatched rows
    are garbage (gathered at index 0) and must be guarded by ``__matched``.
    ``mark`` returns the probe table + BOOL ``mark_name`` column (EXISTS / IN).
    """
    if probe.num_rows == 0 or build.num_rows == 0:
        if probe.num_rows == 0 and how in ("inner", "left"):
            out = {n: c for n, c in probe.columns.items()}
            for n, c in build.columns.items():
                if n not in out:
                    out[n] = c.take(torch.zeros(0, dtype=torch.int64,
                                                device=c.data.device))
            if how == "left":
                out["__matched"] = Column(torch.zeros(
                    0, dtype=torch.bool, device=probe.device), BOOL)
            return Table(out)
        if build.num_rows == 0:
            return _empty_build_join(probe, build, how, mark_name)

    pk, bk = combine_keys([probe[k] for k in probe_keys],
                          [build[k] for k in build_keys])
    order, lo, counts = join_match(pk, bk)

    if how == "mark":
        return probe.with_column(mark_name, Column(counts > 0, BOOL))
    if how == "semi":
        sel, k = kops.compact(counts > 0)
        return probe.take(sel[: pull_scalar(k)])
    if how == "anti":
        sel, k = kops.compact(counts == 0)
        return probe.take(sel[: pull_scalar(k)])

    if how == "left":
        counts_out = torch.clamp(counts, min=1)
    elif how == "inner":
        counts_out = counts
    else:
        raise ValueError(f"unknown join type {how}")

    # dynamic output size: the single scalar pull of the eager join; the
    # expansion runs over the output padded to a power-of-two bucket
    total = pull_scalar(counts_out.sum())
    t_pad = kops.bucket_size(total)
    expanded = None
    if backend is not None:
        expanded = backend.try_expand(order, lo, counts, counts_out, t_pad)
    if expanded is None:
        expanded = join_expand_ref(order, lo, counts, counts_out, t_pad)
    probe_idx, build_idx, matched = expanded
    probe_idx = probe_idx[:total]
    build_idx = build_idx[:total]

    out = {}
    for name, col in probe.columns.items():
        out[name] = col.take(probe_idx)
    for name, col in build.columns.items():
        if name in out:  # key columns equal by definition; keep probe copy
            continue
        out[name] = col.take(build_idx)
    if how == "left":
        out["__matched"] = Column(matched[:total], BOOL)
    return Table(out)


def hash_join_bounded(
    probe: Table,
    build: Table,
    probe_keys: Sequence[str],
    build_keys: Sequence[str],
    capacity: int,
    how: str = "inner",
) -> Tuple[Table, torch.Tensor, torch.Tensor]:
    """Sync-free inner/left join under a conservative cardinality cap.

    The stats-layer ``capacity`` (an upper bound on the join's output
    cardinality) replaces the dynamic-size pull entirely: the output is
    allocated at the padded cap, surviving rows are flagged by ``valid``,
    and ``overflow`` is a device bool that is true iff the true match
    count exceeded ``capacity`` (rows were dropped — the caller must fall
    back to ``hash_join``).  With single-column keys nothing here waits
    for the device; multi-column keys pull per-column min/max scalars to
    pack them.

    Returns ``(padded_table, valid_mask, overflow_flag)``; the padded table
    has exactly ``bucket_size(capacity)`` rows.
    """
    if how not in ("inner", "left"):
        raise ValueError(f"hash_join_bounded supports inner/left, got {how}")
    cap = kops.bucket_size(max(int(capacity), 1))
    if probe.num_rows == 0 or build.num_rows == 0:
        joined = hash_join(probe, build, probe_keys, build_keys, how)
        device = joined.device
        if joined.num_rows == 0:
            out = {n: Column(torch.zeros(cap, dtype=c.data.dtype,
                                         device=c.data.device),
                             c.kind, c.dictionary)
                   for n, c in joined.columns.items()}
        else:
            pad = torch.clamp(torch.arange(cap, device=device),
                              max=joined.num_rows - 1)
            out = {n: c.take(pad) for n, c in joined.columns.items()}
        valid = torch.arange(cap, device=device) < joined.num_rows
        return (Table(out), valid,
                torch.tensor(joined.num_rows > cap, device=device))

    pk, bk = combine_keys([probe[k] for k in probe_keys],
                          [build[k] for k in build_keys])
    order, lo, counts = join_match(pk, bk)
    counts_out = torch.clamp(counts, min=1) if how == "left" else counts
    total = counts_out.sum()
    overflow = total > cap
    probe_idx, build_idx, matched = join_expand_ref(order, lo, counts,
                                                    counts_out, cap)
    # rows past the true total are filler: mask them out
    valid = torch.arange(cap, device=pk.device) < total
    out = {}
    for name, col in probe.columns.items():
        out[name] = col.take(probe_idx)
    for name, col in build.columns.items():
        if name in out:
            continue
        out[name] = col.take(build_idx)
    if how == "left":
        out["__matched"] = Column(matched, BOOL)
    return Table(out), valid, overflow


# ---------------------------------------------------------------------------
# static-shape open-addressing hash table (fixed shapes, no host syncs)
# ---------------------------------------------------------------------------

_MIX = -7046029254386353131  # 0x9E3779B97F4A7C15 as signed int64
EMPTY = -1


def _hash(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """Slot of each key: an int64 multiply that wraps, an arithmetic
    ``>> 29``, ``& mask`` — bit for bit the reference's."""
    h = keys.to(torch.int64) * _MIX
    h = h ^ (h >> 29)
    return (h & mask).to(torch.int32)


def next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 4)


@dataclasses.dataclass
class StaticHashTable:
    """Open-addressing table over unique int keys; fully static shapes.

    slots_key[i]  = key stored in slot i (or -1)
    slots_row[i]  = build-side row index for that key (or -1)
    Built with deterministic multi-round masked scatter: every unplaced
    key scatters its row id into its current candidate slot with a
    scatter-max; winners are the rows that read their own id back.

    Keys ``(n,)`` build one table; keys ``(shards, n)`` build one table a
    shard, side by side (slots ``(shards, capacity)``), each equal to the
    table its shard's keys build alone; ``lookup`` then takes
    ``(shards, m)`` keys."""

    slots_key: torch.Tensor
    slots_row: torch.Tensor
    capacity: int
    max_probes: int
    all_placed: Optional[torch.Tensor] = None  # bool scalar; debug/assert aid

    @staticmethod
    def build(keys: torch.Tensor, valid: Optional[torch.Tensor] = None,
              capacity: Optional[int] = None,
              max_probes: int = 32) -> "StaticHashTable":
        lead, n = tuple(keys.shape[:-1]), keys.shape[-1]
        device = keys.device
        cap = capacity or next_pow2(2 * n)
        mask = cap - 1
        keys = keys.to(torch.int64)
        rows = torch.arange(n, dtype=torch.int32, device=device).expand(
            lead + (n,))
        if valid is None:
            valid = torch.ones(lead + (n,), dtype=torch.bool, device=device)

        slots_row = torch.full(lead + (cap,), -1, dtype=torch.int32,
                               device=device)
        placed = ~valid  # invalid rows are "already placed" (i.e. skipped)
        h0 = _hash(keys, mask)
        for i in range(max_probes):
            cand = ((h0 + i) & mask).long()
            # Contenders scatter-max their row id into a scratch table; the
            # scratch is merged only into slots that are still empty, so
            # earlier winners are never displaced.
            attempt = torch.where(placed, -1, rows)
            bids = torch.full(lead + (cap,), -1, dtype=torch.int32,
                              device=device)
            bids.scatter_reduce_(-1, cand, attempt, "amax")
            empty = slots_row == -1
            slots_row = torch.where(empty & (bids >= 0), bids, slots_row)
            won = (~placed) & (torch.gather(slots_row, -1, cand) == rows)
            placed = placed | won
        if n:
            slots_key = torch.where(
                slots_row >= 0,
                torch.gather(keys, -1, torch.clamp(slots_row, 0, n - 1).long()),
                -1)
        else:
            slots_key = torch.full(lead + (cap,), -1, dtype=torch.int64,
                                   device=device)
        return StaticHashTable(slots_key, slots_row, cap, max_probes,
                               torch.all(placed))

    def lookup(self, probe_keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (build_row_idx int32 [-1 if none], found bool). Fully vectorized."""
        mask = self.capacity - 1
        keys = probe_keys.to(torch.int64)
        h0 = _hash(keys, mask)
        found_row = torch.full(keys.shape, -1, dtype=torch.int32,
                               device=keys.device)
        done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        for i in range(self.max_probes):
            cand = ((h0 + i) & mask).long()
            k = torch.gather(self.slots_key, -1, cand)
            r = torch.gather(self.slots_row, -1, cand)
            hit = (~done) & (k == keys) & (r >= 0)
            miss_empty = (~done) & (r == -1)  # empty slot ⇒ key absent
            found_row = torch.where(hit, r, found_row)
            done = done | hit | miss_empty
        return found_row, found_row >= 0


def static_join_gather(probe_data: dict, build_data: dict,
                       row_idx: torch.Tensor, found: torch.Tensor):
    """Gather build columns alongside probe columns under a match mask."""
    safe = torch.clamp(row_idx, min=0).long()
    out = dict(probe_data)
    for name, arr in build_data.items():
        if name not in out:
            out[name] = arr[safe]
    return out, found
