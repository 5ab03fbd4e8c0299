"""Wrapper of the top-k selection kernel (``csrc/topk.cu``).

Counterpart of ``repro/kernels/topk.py::topk_select``.
"""
from __future__ import annotations

import torch

from ..observability.metrics import METRICS
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
    """Candidates the kernel's rounds need: the first round's
    ceil(n/TILE)*k, then the second's (later rounds reuse the two).  A
    candidate takes 8 bytes for float32 keys, 16 for int64 keys."""
    blocks = -(-n // TILE)
    if blocks == 1:
        return 0
    first = blocks * k
    second = -(-first // TILE) * k if first > TILE else 0
    return first + second


def topk_select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int32) of the ``k`` smallest ``keys``, ties broken by the
    smaller row: the first ``k`` entries of a stable ascending sort.

    ``keys`` is float32 or int64 (``repro_topk_select64``: composite ranks
    wider than float32 holds exactly).  For float32, -0.0 and +0.0 are
    equal keys, and the order of NaN keys is unspecified (the engine
    passes integer composites, never NaN).  ``kernel.topk_bytes`` counts
    the bytes a call must move: each key read once, each index written."""
    n = keys.shape[0]
    k = int(k)
    if build.on_cpu(keys):
        out = topk_select_ref(keys, k)
    else:
        out = _launch(keys, n, k)
    METRICS.counter("kernel.topk_bytes").inc(n * keys.element_size() + 4 * k)
    return out


def _launch(keys: torch.Tensor, n: int, k: int) -> torch.Tensor:
    wide = keys.dtype == torch.int64
    build.require(keys, "keys", torch.int64 if wide else torch.float32, 1)
    if not 1 <= k <= min(MAX_K, n) or n >= 2**31:
        raise ValueError(f"topk_select takes 1 <= k <= min({MAX_K}, n) and "
                         f"n < 2^31, got k={k}, n={n}")
    out = torch.empty(k, dtype=torch.int32, device=keys.device)
    # one round (n <= TILE) needs no scratch: the kernel gets a null pointer
    n_scratch = scratch_len(n, k) * (2 if wide else 1)
    scratch = (torch.empty(n_scratch, dtype=torch.int64, device=keys.device)
               if n_scratch else None)
    index = keys.get_device()
    build.launch("topk_select64" if wide else "topk_select", index,
                 build.current_stream(index), keys.data_ptr(), n, k,
                 tile_for(n),
                 scratch.data_ptr() if scratch is not None else None,
                 out.data_ptr())
    return out
