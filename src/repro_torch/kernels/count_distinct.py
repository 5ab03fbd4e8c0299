"""Wrapper of the count-distinct kernel (``csrc/count_distinct.cu``).

No TPU counterpart: the JAX package counts distinct values per group by a
sort of (group, value) pairs (``repro/relational/aggregate.py``).  The
card's kernel inserts the pairs into an exact hash set whose size and grid
are chosen here by pure functions that the CPU tests hold; the table is
allocated and filled per call.  ``kernel.distinct_hits`` counts the calls and
``kernel.distinct_rows`` the rows they take.
"""
from __future__ import annotations

import torch

from ..observability.metrics import METRICS
from . import build
from .ref import count_distinct_ref

THREADS = 256          # csrc repro::kThreads
BLOCKS_PER_SM = 8      # csrc __launch_bounds__(256, 8) of the grid
SLOT_BYTES = 16        # an int64 value and an int32 gid tag, padded


def table_slots(n: int) -> int:
    """Slots of the hash set for ``n`` rows: the power of two >= 2n, so that
    the table, which holds at most n distinct pairs, stays at most half
    full."""
    return 1 << max(2 * n - 1, 1).bit_length()


def grid_blocks(rows: int, sms: int) -> int:
    """Blocks of the grid over ``rows`` rows, each thread taking rows a
    grid's stride apart: BLOCKS_PER_SM an SM, fewer where there are fewer
    rows than threads."""
    return max(1, min(BLOCKS_PER_SM * sms, -(-rows // THREADS)))


def count_distinct(gids: torch.Tensor, values: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """Distinct ``values`` (N,) int64 per group of ``gids`` (N,) int32 →
    (G,) int64.  Rows with gid outside [0, n_groups) are dropped."""
    n = gids.shape[0]
    METRICS.counter("kernel.distinct_hits").inc()
    METRICS.counter("kernel.distinct_rows").inc(n)
    if build.on_cpu(gids, values):
        return count_distinct_ref(gids, values, n_groups)
    build.require(gids, "gids", torch.int32, 1)
    build.require(values, "values", torch.int64, 1)
    g = int(n_groups)
    if values.shape[0] != n:
        raise ValueError(f"gids has {n} rows, values {values.shape[0]}")
    if not 1 <= g < 2 ** 31:
        raise ValueError(f"count_distinct takes 1..2^31-1 groups, got G={g}")
    out = torch.zeros(g, dtype=torch.int64, device=values.device)
    if n == 0:
        return out
    # every byte 0xff: each slot's tag reads as the kernel's kEmpty
    slots = table_slots(n)
    table = torch.full((slots * SLOT_BYTES // 8,), -1, dtype=torch.int64,
                       device=values.device)
    index = values.get_device()
    build.launch("count_distinct", index, build.current_stream(index),
                 gids.data_ptr(), values.data_ptr(), table.data_ptr(),
                 out.data_ptr(), n, g, slots,
                 grid_blocks(n, build.sm_count(index)))
    return out
