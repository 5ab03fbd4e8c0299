"""Glue around the kernels — counterpart of ``repro/kernels/ops.py``.

What the reference computes here in jnp stays plain torch: bucketing and
padding, the sort-based join build, probe-key mapping, static-size
compaction, the filter's compaction and the group-space partitioning.
"""
from __future__ import annotations

import torch

from .filter_count import filter_mask_counts
from .groupby_agg import groupby_sum
from .hash_probe import build_table32, hash_probe
from .join_expand import join_expand
from .topk import topk_select

__all__ = [
    "bucket_size", "build_table32", "compact", "filter_mask_counts",
    "filter_select", "groupby_sum", "groupby_sum_large", "hash_probe",
    "join_expand", "map_probe_keys", "pad_rows", "sorted_build", "topk_select",
]

_GROUP_BUDGET = 4096                      # groups per groupby_sum call
KEY_SENTINEL = torch.iinfo(torch.int64).max  # pads sorted key arrays


def bucket_size(n: int, minimum: int = 8) -> int:
    """Pad row counts to powers of two."""
    if n <= minimum:
        return minimum
    return 1 << int(n - 1).bit_length()


def pad_rows(arr: torch.Tensor, b: int) -> torch.Tensor:
    """Zero-pad the leading axis to ``b`` rows."""
    n = arr.shape[0]
    if n == b:
        return arr
    return torch.cat([arr, torch.zeros((b - n,) + tuple(arr.shape[1:]),
                                       dtype=arr.dtype, device=arr.device)])


def sorted_build(keys_padded: torch.Tensor, valid: torch.Tensor):
    """Sort-based join build over sentinel-padded int64 keys.

    → (sorted keys with KEY_SENTINEL tail, original-row order int32, rank per
    input row int32, duplicate-key flag, sentinel-collision flag).  The sort
    is stable, as ``jnp.argsort`` is, so padding rows keep their order."""
    nb = keys_padded.shape[0]
    masked = torch.where(valid, keys_padded, KEY_SENTINEL)
    order = torch.sort(masked, stable=True).indices  # valid keys first, pads last
    s = masked[order]
    if nb > 1:
        dup = ((s[1:] == s[:-1]) & (s[1:] != KEY_SENTINEL)).any()
    else:
        dup = torch.zeros((), dtype=torch.bool, device=s.device)
    sentinel_hit = (valid & (keys_padded == KEY_SENTINEL)).any()
    ranks = torch.zeros(nb, dtype=torch.int32, device=s.device)
    ranks[order] = torch.arange(nb, dtype=torch.int32, device=s.device)
    return s, order.to(torch.int32), ranks, dup, sentinel_hit


def map_probe_keys(uni: torch.Tensor, probe_keys: torch.Tensor) -> torch.Tensor:
    """Rank ``probe_keys`` in the sorted-unique build key set (-2 = absent).

    ``uni`` may carry a KEY_SENTINEL pad tail; sentinel positions never
    match real keys."""
    if uni.shape[0] == 0:
        return torch.full(probe_keys.shape, -2, dtype=torch.int32,
                          device=probe_keys.device)
    pos = torch.clamp(torch.searchsorted(uni, probe_keys), 0, uni.shape[0] - 1)
    hit = uni[pos] == probe_keys
    return torch.where(hit, pos, -2).to(torch.int32)


def compact(mask: torch.Tensor):
    """Selection-vector compaction: indices of True, selected-first order.

    Static output size (= len(mask)), built by cumsum and scatter, so it
    never syncs (``torch.nonzero`` would); the tail is zeros, as the
    reference's ``nonzero(size=n, fill_value=0)`` gives.  → (idx, count)
    with ``count`` a device scalar."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    dest = torch.where(mask, torch.cumsum(m, 0) - 1, n)  # drops go to slot n
    idx = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dest, torch.arange(n, device=mask.device))
    return idx[:n], m.sum()


def filter_select(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Fused range filter + compaction → (row indices, count)."""
    mask, _ = filter_mask_counts(cols, lo, hi)
    return compact(mask)


def groupby_sum_large(gids: torch.Tensor, values: torch.Tensor,
                      n_groups: int) -> torch.Tensor:
    """Group-space-partitioned aggregation for G beyond one call's budget."""
    if n_groups <= _GROUP_BUDGET:
        return groupby_sum(gids, values, n_groups)
    parts = []
    for base in range(0, n_groups, _GROUP_BUDGET):
        g = min(_GROUP_BUDGET, n_groups - base)
        parts.append(groupby_sum(gids - base, values, g))
    return torch.cat(parts, dim=0)
