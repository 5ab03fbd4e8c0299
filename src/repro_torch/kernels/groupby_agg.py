"""Wrapper of the group-by sum kernel (``csrc/groupby_agg.cu``).

Counterpart of ``repro/kernels/groupby_agg.py::groupby_sum``.  The kernel's
design (``one_pass``) and shapes (column chunk, lanes a column chunk takes,
rows a tile of its cp.async ring holds, grids, shared memory) are chosen
here by pure functions that the CPU tests hold; its float64 accumulator and
ticket counters live in a scratch kept per (device, stream), zero between
launches.
"""
from __future__ import annotations

import threading

import torch

from ..observability.metrics import METRICS
from . import build
from .ref import groupby_sum_ref

SMEM_BUDGET = 96 * 1024   # bytes of shared memory for one block's float64 partial
REG_GROUPS = 8            # csrc kRegGroups: gids 0..7 add in registers
MAX_CHUNK = 32            # columns a warp's lanes take at once
BLOCKS_PER_SM = 2         # csrc __launch_bounds__(256, 2)
MIN_ROWS_PER_BLOCK = 2048
STAGES = 3                # csrc kStages: tiles in the cp.async ring
STAGE_BYTES = 32 * 1024   # about the bytes of one tile (gids and values)
WARPS = 8                 # a block's warps (256 threads)
MAX_SMEM = 232_448 - 16   # the H100's shared memory a block may have, less
                          # the kernel's static 16 bytes
SHARED_GROUPS = 4096      # the most groups the register/shared design takes
WIDE_BLOCKS_PER_SM = 4    # csrc __launch_bounds__(256, 4) of the one-pass grid
THREADS = 32 * WARPS      # csrc repro::kThreads


def one_pass(g: int) -> bool:
    """Whether a call over ``g`` groups takes the one-pass design.  Above
    SHARED_GROUPS a block's (G, cw) float64 partial holds at most two
    columns, so the register/shared design would read the rows once per
    column chunk and merge about an atomic a row besides; the one-pass
    design reads each row once and adds it into the device-memory
    accumulator."""
    return g > SHARED_GROUPS


def wide_blocks(items: int, sms: int) -> int:
    """Blocks of a one-pass design's grid over ``items`` (its N rows, or
    the finishing grid's G x V cells), each thread taking items a grid's
    stride apart: WIDE_BLOCKS_PER_SM an SM, fewer where there are fewer
    items than threads."""
    return max(1, min(WIDE_BLOCKS_PER_SM * sms, -(-items // THREADS)))


def column_chunk(v: int, g: int) -> int:
    """Columns one block takes (the rest go across blockIdx.y): all V up
    to 32, fewer where G * cw float64 partials would exceed SMEM_BUDGET."""
    return max(1, min(v, MAX_CHUNK, SMEM_BUDGET // (8 * g)))


def lane_width(cw: int) -> int:
    """Lanes a row of a column chunk takes: the power of two >= cw in
    4..32, so a warp takes 32 // lane_width rows at a time."""
    w = 4
    while w < cw:
        w *= 2
    return w


def tile_rows(v: int, w: int) -> int:
    """Rows a tile of the ring holds: about STAGE_BYTES of gids and V
    values, at most 8192 // w (32 row steps a warp); a multiple of
    WARPS * (32 // w), so that every warp takes whole row steps, where
    that fits, else of 4 (each tile starts on a 16-byte boundary)."""
    step = WARPS * (32 // w)
    fit = STAGE_BYTES // (4 * (v + 1))
    if fit >= step:
        return min(8192 // w, fit // step * step)
    return max(4, fit // 4 * 4)


def smem_layout(g: int, cw: int, v: int, rows: int) -> tuple:
    """(partial bytes, total dynamic shared bytes) of one block: the (G, cw)
    float64 partial, rounded up to 16 bytes, then STAGES tiles of ``rows``
    gids and rows x V values."""
    part = -(-g * cw * 8 // 16) * 16
    return part, part + STAGES * rows * (v + 1) * 4


def grid_blocks(n: int, g: int, sms: int) -> int:
    """Blocks along the rows: about BLOCKS_PER_SM an SM, but at least
    max(MIN_ROWS_PER_BLOCK, G) rows a block, so that the blocks' partials
    (G cells each) never outweigh their rows; always at least one."""
    rows_min = max(MIN_ROWS_PER_BLOCK, g)
    return max(1, min(BLOCKS_PER_SM * sms, -(-n // rows_min)))


# (device index, stream) -> (float64 accumulator, int32 tickets): zero
# between launches; kept per stream so that launches on one stream, which
# run in order, share them
_workspaces: dict = {}
_workspaces_lock = threading.Lock()


def _workspace(index: int, stream: int, n_acc: int, n_tickets: int, device):
    key = (index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_acc or ws[1].numel() < n_tickets:
        with _workspaces_lock:
            ws = _workspaces.get(key)
            if ws is not None:   # grow; the zeroing is ordered on the stream
                n_acc = max(n_acc, ws[0].numel())
                n_tickets = max(n_tickets, ws[1].numel())
            ws = _workspaces[key] = (
                torch.zeros(n_acc, dtype=torch.float64, device=device),
                torch.zeros(n_tickets, dtype=torch.int32, device=device))
    return ws


def groupby_sum(gids: torch.Tensor, values: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    """Segment-sum ``values`` (N, V) f32 by ``gids`` (N,) int32 → (G, V) f32.

    Rows with gid outside [0, n_groups) are dropped.  One launch at any G:
    the one-pass design above SHARED_GROUPS groups (``one_pass``)."""
    if build.on_cpu(gids, values):
        return groupby_sum_ref(gids, values, n_groups)
    build.require(gids, "gids", torch.int32, 1)
    build.require(values, "values", torch.float32, 2)
    n, v = values.shape
    g = int(n_groups)
    if gids.shape[0] != n:
        raise ValueError(f"gids has {gids.shape[0]} rows, values {n}")
    if g < 1 or v < 1 or g >= 2 ** 31:
        raise ValueError(f"groupby_sum takes 1..2^31-1 groups and >= 1 "
                         f"column, got G={g}, V={v}")
    out = torch.empty((g, v), dtype=torch.float32, device=values.device)
    if n == 0:
        return out.zero_()
    index = values.get_device()
    stream = build.current_stream(index)
    if one_pass(g):
        sms = build.sm_count(index)
        acc, tickets = _workspace(index, stream, g * v, 1, values.device)
        build.launch("groupby_sum", index, stream, gids.data_ptr(),
                     values.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
                     out.data_ptr(), n, v, g, wide_blocks(n, sms), 0, 0, 0, 0,
                     0, 0, 0, wide_blocks(g * v, sms))
        METRICS.counter("kernel.groupby_wide").inc()
        return out
    cw = column_chunk(v, g)
    w = lane_width(cw)
    rows = tile_rows(v, w)
    part, smem = smem_layout(g, cw, v, rows)
    if smem > MAX_SMEM:
        raise ValueError(f"groupby_sum: V={v} columns need {smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    n_blocks = grid_blocks(n, g, build.sm_count(index))
    per_block = -(-n // n_blocks)
    per_block += -per_block % 4     # tiles start on 16-byte boundaries
    acc, tickets = _workspace(index, stream, g * v, -(-v // cw), values.device)
    aligned = gids.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    build.launch("groupby_sum", index, stream, gids.data_ptr(),
                 values.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
                 out.data_ptr(), n, v, g, n_blocks, cw, per_block, w, rows,
                 part, smem, int(aligned), 0)
    return out
