"""Wrapper of the join run-expansion kernel (``csrc/join_expand.cu``).

Counterpart of ``repro/kernels/join_expand.py::join_expand``; same
signature and semantics as ``ref.join_expand_ref``.  One grid a call scans
the runs (decoupled look-back over per-tile status words) and writes their
outputs; the grid's shape is chosen here by a pure function that the CPU
tests hold, and the status words and the tile counter live in a scratch
kept per (device, stream) that no launch has to zero.
"""
from __future__ import annotations

import threading

import torch

from . import build
from .ref import join_expand_ref

TILE_RUNS = 2048          # csrc kTileRuns: runs a block scans
SPAN_PER_HELPER = 8192    # bucket positions per helper block
MAX_HELPERS_PER_SM = 2
EPOCHS = (1 << 20) - 1    # csrc: 20 epoch bits, 0 never used
MAX_TOTAL = 1 << 40       # csrc: 41-bit saturated prefix values


def expand_grid(n: int, total: int, sms: int) -> tuple:
    """(tiles, helper blocks) of one launch: one tile of TILE_RUNS runs a
    block, so never more tiles than runs, and enough helper blocks (the
    filler, and the outputs of tiles with more than csrc kOwnOutputs) for
    SPAN_PER_HELPER bucket positions each, at most MAX_HELPERS_PER_SM an
    SM, at least one."""
    tiles = -(-n // TILE_RUNS)
    helpers = max(1, min(MAX_HELPERS_PER_SM * sms, -(-total // SPAN_PER_HELPER)))
    return tiles, helpers


class _Workspace:
    """One stream's status words (int64, grown as tiles need), its tile
    counter and the host's count of the blocks launched on it so far, and
    the epoch of the last launch.  ``lock`` is held from the choice of
    base and epoch to the launch, so launches from several threads onto
    one stream enqueue in the order of their bases."""

    def __init__(self, device):
        self.device = device
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.base = 0
        self.epoch = 0
        self.lock = threading.Lock()

    def next_launch(self, tiles: int) -> tuple:
        """(status, base, epoch) for a launch over ``tiles`` tiles; the
        caller holds ``lock`` until it has launched and added the launch's
        blocks to ``base`` (only then: a refused launch takes no ticket)."""
        if self.status.numel() < tiles:
            self.status = torch.zeros(tiles, dtype=torch.int64,
                                      device=self.device)
        self.epoch += 1
        if self.epoch > EPOCHS:   # a word of this epoch may be left over
            self.status.zero_()
            self.epoch = 1
        return self.status, self.base, self.epoch


_workspaces: dict = {}
_workspaces_lock = threading.Lock()


def _workspace(index: int, stream: int, device) -> _Workspace:
    key = (index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        with _workspaces_lock:
            ws = _workspaces.get(key)
            if ws is None:
                ws = _workspaces[key] = _Workspace(device)
    return ws


def join_expand(order: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor,
                counts_out: torch.Tensor, total: int):
    """Expand match runs into gather indices → (probe_idx int64,
    build_idx int64, matched bool), each of length ``total`` (the bucketed
    output size; positions past the true size are filler)."""
    if build.on_cpu(order, lo, counts, counts_out):
        return join_expand_ref(order, lo, counts, counts_out, total)
    for t, name in ((order, "order"), (lo, "lo"), (counts, "counts"),
                    (counts_out, "counts_out")):
        build.require(t, name, torch.int64, 1)
    n, nb = lo.shape[0], order.shape[0]
    if n == 0 or nb == 0 or counts.shape[0] != n or counts_out.shape[0] != n:
        raise ValueError("join_expand needs n >= 1 runs (lo, counts, "
                         "counts_out alike) over nb >= 1 build rows")
    if not 0 <= total < MAX_TOTAL:
        raise ValueError(f"join_expand takes a bucket below 2^40, got {total}")
    device = order.device
    probe_idx = torch.empty(total, dtype=torch.int64, device=device)
    build_idx = torch.empty(total, dtype=torch.int64, device=device)
    matched = torch.empty(total, dtype=torch.bool, device=device)
    if total == 0:
        return probe_idx, build_idx, matched
    index = order.get_device()
    tiles, helpers = expand_grid(n, total, build.sm_count(index))
    stream = build.current_stream(index)
    ws = _workspace(index, stream, device)
    with ws.lock:
        status, base, epoch = ws.next_launch(tiles)
        build.launch("join_expand", index, stream, counts_out.data_ptr(),
                     lo.data_ptr(), counts.data_ptr(), order.data_ptr(),
                     probe_idx.data_ptr(), build_idx.data_ptr(),
                     matched.data_ptr(), n, nb, total, tiles, helpers,
                     status.data_ptr(), ws.counter.data_ptr(), base, epoch)
        ws.base += tiles + helpers
    return probe_idx, build_idx, matched
