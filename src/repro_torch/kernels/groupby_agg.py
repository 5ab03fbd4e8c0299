"""Wrapper of the group-by sum kernel (``csrc/groupby_agg.cu``).

Counterpart of ``repro/kernels/groupby_agg.py::groupby_sum``.
"""
from __future__ import annotations

import torch

from . import build
from .ref import groupby_sum_ref

SMEM_BUDGET = 96 * 1024   # bytes of shared memory for one block's float64 partial
MAX_BLOCKS = 264          # two blocks for each of the H100's 132 SMs
MIN_ROWS_PER_BLOCK = 2048


def groupby_sum(gids: torch.Tensor, values: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    """Segment-sum ``values`` (N, V) f32 by ``gids`` (N,) int32 → (G, V) f32.

    Rows with gid outside [0, n_groups) are dropped."""
    if build.on_cpu(gids, values):
        return groupby_sum_ref(gids, values, n_groups)
    build.require(gids, "gids", torch.int32, 1)
    build.require(values, "values", torch.float32, 2)
    n, v = values.shape
    g = int(n_groups)
    if gids.shape[0] != n:
        raise ValueError(f"gids has {gids.shape[0]} rows, values {n}")
    if g < 1 or v < 1 or g * 8 > SMEM_BUDGET:
        raise ValueError(f"groupby_sum takes 1..{SMEM_BUDGET // 8} groups and "
                         f">= 1 column, got G={g}, V={v}")
    out = torch.empty((g, v), dtype=torch.float32, device=values.device)
    if n == 0:
        return out.zero_()
    v_chunk = min(v, SMEM_BUDGET // (8 * g))
    n_blocks = max(1, min(MAX_BLOCKS, -(-n // MIN_ROWS_PER_BLOCK)))
    partials = torch.empty((n_blocks, g, v), dtype=torch.float64,
                           device=values.device)
    index = values.get_device()
    build.launch("groupby_sum", index, build.current_stream(index),
                 gids.data_ptr(), values.data_ptr(), partials.data_ptr(),
                 out.data_ptr(), n, v, g, n_blocks, v_chunk, g * v_chunk * 8)
    return out
