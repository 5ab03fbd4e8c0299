"""Plain PyTorch versions of the six CUDA kernels (the correctness contracts).

The wrappers use them for CPU tensors; ``chip_smoke.py`` holds each kernel
against them on the card.  ``filter_mask_counts_ref``, ``groupby_sum_ref``,
``hash_probe_ref`` and ``decode_attention_ref`` port ``repro/kernels/ref.py``;
``join_expand_ref`` ports ``repro/relational/join.py::_join_expand``;
``topk_select_ref`` states the semantics of ``repro/kernels/topk.py``,
which has no plain version in the reference.
"""
from __future__ import annotations

import torch

MIX32 = -1640531527  # 0x9E3779B9 as a signed int32


def hash32(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """The probe kernel's hash: ``h = key * 0x9E3779B9`` in wrapping int32
    arithmetic, then ``h ^ (h >> 15)`` (arithmetic shift), masked.

    Computed in int64: the exact product is cut to its low 32 bits and
    re-read as signed, so it wraps as int32 does, on any device."""
    h = keys.to(torch.int64) * MIX32
    h = ((h & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    h = h ^ (h >> 15)
    return (h & mask).to(torch.int32)


def filter_mask_counts_ref(cols: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, tile: int = 2048):
    """Conjunction of closed ranges per row → (mask, selected rows per tile)."""
    cols32 = cols.to(torch.float32)
    mask = ((cols32 >= lo.to(torch.float32))
            & (cols32 <= hi.to(torch.float32))).all(dim=1)
    n = mask.shape[0]
    n_pad = ((n + tile - 1) // tile) * tile
    padded = torch.zeros(n_pad, dtype=torch.bool, device=mask.device)
    padded[:n] = mask
    counts = padded.view(-1, tile).sum(dim=1).to(torch.int32)
    return mask, counts


def groupby_sum_ref(gids: torch.Tensor, values: torch.Tensor,
                    n_groups: int) -> torch.Tensor:
    """Segment-sum (N,V) by gid, dropping out-of-range gids → (G,V) f32.

    Sums in float64 and rounds once to float32, as the CUDA kernel does."""
    gids = gids.to(torch.int64)
    ok = (gids >= 0) & (gids < n_groups)
    safe = torch.where(ok, gids, n_groups)
    vals = torch.where(ok[:, None], values.to(torch.float64), 0.0)
    out = torch.zeros((n_groups + 1, values.shape[1]), dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, safe, vals)[:-1].to(torch.float32)


def hash_probe_ref(probe_keys: torch.Tensor, slots_key: torch.Tensor,
                   slots_row: torch.Tensor, max_probes: int = 32):
    """Linear-probe lookup → (build row int32, -1 where absent; found)."""
    cap = slots_key.shape[0]
    mask = cap - 1
    keys = probe_keys.to(torch.int32)
    h0 = hash32(keys, mask).to(torch.int64)
    row = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(max_probes):
        cand = (h0 + i) & mask
        k = slots_key[cand]
        r = slots_row[cand]
        hit = (~done) & (k == keys) & (r >= 0)
        empty = (~done) & (r == -1)
        row = torch.where(hit, r, row)
        done = done | hit | empty
    return row, row >= 0


def join_expand_ref(order: torch.Tensor, lo: torch.Tensor,
                    counts: torch.Tensor, counts_out: torch.Tensor,
                    total: int):
    """Expand match runs into gather indices.

    Output ``j`` belongs to the probe row whose run of ``counts_out`` covers
    it; ``total`` is the bucketed output length and the tail past the true
    size is filler the caller slices off (it lands on the last run, as the
    reference's ``jnp.repeat(..., total_repeat_length=total)`` pads with
    the last value).  → (probe_idx, build_idx, matched), each of length
    ``total``.  The run of each output is a binary search over the runs'
    inclusive ends, so nothing here waits for the device (a
    ``repeat_interleave`` would read its output size back)."""
    n = lo.shape[0]
    device = lo.device
    ends = torch.cumsum(counts_out, 0)
    j = torch.arange(total, device=device)
    probe_idx = torch.clamp(torch.searchsorted(ends, j, right=True),
                            max=max(n - 1, 0))
    intra = j - (ends - counts_out)[probe_idx]
    build_pos = lo[probe_idx] + intra
    matched = counts[probe_idx] > 0
    nb = order.shape[0]
    build_pos = torch.where(matched, torch.clamp(build_pos, 0, max(nb - 1, 0)),
                            0)
    return probe_idx, order[build_pos], matched


def topk_select_ref(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` indices (int32) of a stable ascending sort of the
    keys: ties go to the smaller row.  float32 keys (any float is taken as
    float32) treat -0.0 as +0.0, as the TPU kernel's ``==`` has it; int64
    keys (the engine's composite ranks wider than float32 holds exactly)
    sort as they are."""
    if keys.dtype != torch.int64:
        keys = keys.to(torch.float32)
        keys = torch.where(keys == 0, torch.zeros_like(keys), keys)
    return torch.sort(keys, stable=True).indices[:k].to(torch.int32)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Masked GQA decode attention: q (B,H,D), k/v (B,S,KVH,D) → (B,H,D).

    Scores in float32; position ``s`` of row ``b`` is masked (-1e30) when
    ``s >= lengths[b]``, and the softmax runs over the S cache rows only.
    So ``lengths[b] >= S`` attends all S rows and ``lengths[b] <= 0`` gives
    the uniform mean of v over all S rows (the reference's semantics; the
    Pallas kernel, which pads S to 512-row blocks, differs at both edges).
    The output has q's dtype."""
    b, h, d = q.shape
    _, s, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, kvh, g, d).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kf) / (d ** 0.5)
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    scores = torch.where(pos < lengths[:, None, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)
