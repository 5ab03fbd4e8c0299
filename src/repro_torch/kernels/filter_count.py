"""Wrapper of the fused range-filter kernel (``csrc/filter_count.cu``).

Counterpart of ``repro/kernels/filter_count.py::filter_mask_counts``.
"""
from __future__ import annotations

import torch

from . import build
from .ref import filter_mask_counts_ref

TILE = 2048


def filter_mask_counts(cols: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """cols (N, C) f32, lo/hi (C,) f32 → (mask bool[N], per-tile counts int32).

    A row passes when ``lo[c] <= cols[r, c] <= hi[c]`` for every column c.
    """
    if build.on_cpu(cols, lo, hi):
        return filter_mask_counts_ref(cols, lo, hi, TILE)
    build.require(cols, "cols", torch.float32, 2)
    build.require(lo, "lo", torch.float32, 1)
    build.require(hi, "hi", torch.float32, 1)
    n, c = cols.shape
    if lo.shape[0] != c or hi.shape[0] != c:
        raise ValueError(f"lo/hi must have {c} entries")
    mask = torch.empty(n, dtype=torch.bool, device=cols.device)
    counts = torch.zeros((n + TILE - 1) // TILE, dtype=torch.int32,
                         device=cols.device)
    if n == 0:
        return mask, counts
    index = cols.get_device()
    build.launch("filter_mask_counts", index, build.current_stream(index),
                 cols.data_ptr(), lo.data_ptr(), hi.data_ptr(), mask.data_ptr(),
                 counts.data_ptr(), n, c)
    return mask, counts
