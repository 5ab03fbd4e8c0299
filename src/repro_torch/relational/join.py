"""Join operators — counterpart of the eager path of ``repro/relational/join.py``.

``hash_join`` is sort-merge on factorized keys, exact for any
multiplicity: match counting (stable argsort + two searchsorted), then the
run expansion into gather indices.  The dynamic output size is the single
scalar pull between the two.  With a kernel backend attached the run
expansion goes to the ``join_expand`` CUDA kernel.  Supports inner / left /
semi / anti / mark.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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
