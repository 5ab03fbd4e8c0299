"""Wrapper of the top-k selection kernel (``csrc/topk.cu``).

Counterpart of ``repro/kernels/topk.py::topk_select``.
"""
from __future__ import annotations

import torch

from . import build
from .ref import topk_select_ref

TILE = 1024     # the largest tile a block sorts (csrc/topk.cu kTile)
MIN_TILE = 64   # one warp of compare-exchanges (csrc/topk.cu kMinTile)
MAX_K = 128     # the reference's contract: ORDER BY ... LIMIT k <= 128


def tile_for(n: int) -> int:
    """Keys the first round's blocks sort: for n <= TILE one block and the
    next power of two >= max(n, MIN_TILE); above, TILE."""
    return min(TILE, max(MIN_TILE, 1 << max(n - 1, 0).bit_length()))


def scratch_len(n: int, k: int) -> int:
    """uint64 candidates the kernel's rounds need: the first round's
    ceil(n/TILE)*k, then the second's (later rounds reuse the two)."""
    blocks = -(-n // TILE)
    if blocks == 1:
        return 0
    first = blocks * k
    second = -(-first // TILE) * k if first > TILE else 0
    return first + second


def topk_select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int32) of the ``k`` smallest float32 ``keys``, ties broken by
    the smaller row: the first ``k`` entries of a stable ascending sort.

    -0.0 and +0.0 are equal keys.  The order of NaN keys is unspecified
    (the engine passes integer composites, never NaN)."""
    if build.on_cpu(keys):
        return topk_select_ref(keys, k)
    build.require(keys, "keys", torch.float32, 1)
    n = keys.shape[0]
    k = int(k)
    if not 1 <= k <= min(MAX_K, n) or n >= 2**31:
        raise ValueError(f"topk_select takes 1 <= k <= min({MAX_K}, n) and "
                         f"n < 2^31, got k={k}, n={n}")
    out = torch.empty(k, dtype=torch.int32, device=keys.device)
    # one round (n <= TILE) needs no scratch: the kernel gets a null pointer
    n_scratch = scratch_len(n, k)
    scratch = (torch.empty(n_scratch, dtype=torch.int64, device=keys.device)
               if n_scratch else None)
    index = keys.get_device()
    build.launch("topk_select", index, build.current_stream(index),
                 keys.data_ptr(), n, k, tile_for(n),
                 scratch.data_ptr() if scratch is not None else None,
                 out.data_ptr())
    return out
