"""Glue around the kernels — counterpart of ``repro/kernels/ops.py``.

What the reference computes here in jnp stays plain torch: bucketing and
padding, the sort-based and direct-address join builds and their lookups,
key bounds, probe-key mapping and factorization, static-size compaction
and the filter's compaction.
``hash_probe_int64`` launches the ``hash_probe`` kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .decode_attention import decode_attention
from .filter_count import filter_mask_counts
from .groupby_agg import groupby_sum
from .hash_probe import build_table32, hash_probe
from .join_expand import join_expand
from .topk import topk_select

__all__ = [
    "bucket_size", "build_table32", "compact", "decode_attention",
    "direct_build", "direct_lookup", "factorize_keys_int32",
    "factorize_keys_int32_device", "filter_mask_counts", "filter_select",
    "groupby_sum", "groupby_sum_large", "hash_probe", "hash_probe_int64",
    "join_expand", "key_bounds", "map_probe_keys", "pad_rows",
    "sorted_build", "sorted_lookup", "topk_select",
]

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


def key_bounds(keys_padded: torch.Tensor, valid: torch.Tensor):
    """(min, max, count) over the valid rows of a padded key column, as
    device scalars."""
    masked_lo = torch.where(valid, keys_padded, KEY_SENTINEL)
    masked_hi = torch.where(valid, keys_padded, torch.iinfo(torch.int64).min)
    return masked_lo.min(), masked_hi.max(), valid.sum()


def direct_build(keys_padded: torch.Tensor, valid: torch.Tensor, lo,
                 domain: int):
    """Sort-free direct-address join build for dense key domains.

    Scatters each row id into ``slot[key - lo]`` (the largest row id wins
    where keys repeat, as the reference's ``.at[].max`` does).  → (slot
    array int32 [-1 = empty], duplicate-key flag).  Padding rows scatter
    into an overflow slot that is cut off."""
    nb = keys_padded.shape[0]
    device = keys_padded.device
    idx = torch.clamp(keys_padded - lo, 0, domain - 1)
    pos = torch.where(valid, idx, domain)          # pads → overflow slot
    slot = torch.full((domain + 1,), -1, dtype=torch.int32, device=device)
    slot.scatter_reduce_(0, pos, torch.arange(nb, dtype=torch.int32,
                                              device=device),
                         "amax", include_self=True)
    counts = torch.zeros(domain + 1, dtype=torch.int32, device=device)
    counts.index_add_(0, pos, torch.ones(nb, dtype=torch.int32, device=device))
    dup = (counts[:domain] > 1).any()
    return slot[:domain], dup


def direct_lookup(slot: torch.Tensor, lo, probe_keys: torch.Tensor):
    """Probe a direct-address build → (build row [-1], found)."""
    domain = slot.shape[0]
    idx = probe_keys - lo
    ok = (idx >= 0) & (idx < domain)
    row = slot[torch.clamp(idx, 0, domain - 1)]
    found = ok & (row >= 0)
    return torch.where(found, row, -1), found


def sorted_lookup(s_keys: torch.Tensor, s_order: torch.Tensor,
                  probe_keys: torch.Tensor):
    """Probe sentinel-padded sorted build keys → (build row [-1], found).

    Binary search and two gathers; first match wins (exact for unique
    keys, existence semantics for semi/anti/mark)."""
    pos = torch.clamp(torch.searchsorted(s_keys, probe_keys), 0,
                      s_keys.shape[0] - 1)
    k = s_keys[pos]
    found = (k == probe_keys) & (k != KEY_SENTINEL)
    row = s_order[pos]
    return torch.where(found, row, -1), found


def hash_probe_int64(probe_keys: torch.Tensor, build_keys: torch.Tensor,
                     slots_key32: torch.Tensor, slots_row: torch.Tensor):
    """Probe against a table built on int32-factorized keys, then verify
    true key equality → (build row [-1], found).

    The kernel takes the keys cast to int32, as the reference's wrapper
    casts them; ``build_keys`` (indexed by the build row) must equal the
    probe key for a hit, which rejects 32-bit factorization misses."""
    row, found = hash_probe(probe_keys.to(torch.int32).contiguous(),
                            slots_key32, slots_row)
    ok = found & (build_keys[torch.clamp(row, min=0).long()] == probe_keys)
    return torch.where(ok, row, -1), ok


def factorize_keys_int32(build_keys_np: np.ndarray, probe_keys_np: np.ndarray):
    """Map int64 key spaces into dense int32 ranks (host-side, exact)."""
    uni = np.unique(build_keys_np)
    b = np.searchsorted(uni, build_keys_np).astype(np.int32)
    pos = np.searchsorted(uni, probe_keys_np)
    pos = np.clip(pos, 0, len(uni) - 1)
    hit = uni[pos] == probe_keys_np
    p = np.where(hit, pos, -2).astype(np.int32)  # -2 never matches
    return b, p


def factorize_keys_int32_device(build_keys: torch.Tensor,
                                probe_keys: torch.Tensor):
    """Device-side analogue of ``factorize_keys_int32``: build keys ranked
    against their sorted unique set, probe keys mapped through the same
    ranking (-2 = absent) → (build ranks, probe ranks, unique keys).
    ``torch.unique`` sizes its output from the data, so this syncs."""
    uni = torch.unique(build_keys)
    b = torch.searchsorted(uni, build_keys).to(torch.int32)
    p = map_probe_keys(uni, probe_keys)
    return b, p, uni


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
    """Aggregation at any G in one ``groupby_sum`` call.  The reference
    cuts G above 4096 into 4096-group calls, each reading every row, to fit
    a TPU VMEM accumulator; the card's kernel takes G above 4096 in one pass
    over the rows instead (``groupby_agg.one_pass``)."""
    return groupby_sum(gids, values, n_groups)
