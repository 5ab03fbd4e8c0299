"""Wrapper of the top-k selection kernel (``csrc/topk.cu``).

Counterpart of ``repro/kernels/topk.py::topk_select``.
"""
from __future__ import annotations

import torch

from . import build
from .ref import topk_select_ref

TILE = 1024   # keys a block sorts (csrc/topk.cu kTile)
MAX_K = 128   # the reference's contract: ORDER BY ... LIMIT k <= 128


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
    scratch = torch.empty(scratch_len(n, k), dtype=torch.int64,
                          device=keys.device)
    with torch.cuda.device(keys.device):
        err = build.lib().repro_topk_select(
            keys.data_ptr(), n, k, scratch.data_ptr(), out.data_ptr(),
            build.stream_of(keys))
    build.check(err, "topk_select")
    build.count_launch("topk_select")
    return out
