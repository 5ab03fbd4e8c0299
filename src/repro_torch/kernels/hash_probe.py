"""Wrapper of the hash-probe kernel (``csrc/hash_probe.cu``) and the table build.

Counterpart of ``repro/kernels/hash_probe.py``: ``hash_probe`` launches the
kernel; ``build_table32`` is plain torch, as the reference's is jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .ref import hash32, hash_probe_ref


def build_table32(keys32: torch.Tensor, valid: Optional[torch.Tensor] = None,
                  max_probes: int = 32):
    """Build the open-addressing table the kernel probes (32-bit hash).

    Deterministic multi-round masked scatter, with no atomics and no early
    exit (so no sync): in each of ``max_probes`` rounds every unplaced row
    bids its row id for its current candidate slot (``scatter_reduce``
    amax), empty slots take the highest bid, and a row is placed when it
    reads its own id back.  ``valid`` masks padding rows (they never place).
    Returns (slots_key int32, slots_row int32, all_placed bool tensor).
    """
    n = keys32.shape[0]
    device = keys32.device
    cap = 1 << max(int(2 * n - 1).bit_length(), 4)
    mask = cap - 1
    keys32 = keys32.to(torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=device)
    h0 = hash32(keys32, mask).to(torch.int64)
    slots_row = torch.full((cap,), -1, dtype=torch.int32, device=device)
    placed = (torch.zeros(n, dtype=torch.bool, device=device) if valid is None
              else ~valid)
    for i in range(max_probes):
        cand = (h0 + i) & mask
        attempt = torch.where(placed, -1, rows)
        bids = torch.full((cap,), -1, dtype=torch.int32, device=device)
        bids.scatter_reduce_(0, cand, attempt, "amax", include_self=True)
        empty = slots_row == -1
        slots_row = torch.where(empty & (bids >= 0), bids, slots_row)
        won = (~placed) & (slots_row[cand] == rows)
        placed = placed | won
    slots_key = torch.where(
        slots_row >= 0, keys32[torch.clamp(slots_row, 0, n - 1).long()], -1)
    return slots_key.to(torch.int32), slots_row, placed.all()


def _require_int32_vectors(probe_keys, slots_key, slots_row) -> None:
    """Raise unless the three are contiguous 1-d int32 tensors: one test of
    all three, and build.require's message for the one at fault."""
    if (probe_keys.dtype == slots_key.dtype == slots_row.dtype == torch.int32
            and probe_keys.dim() == slots_key.dim() == slots_row.dim() == 1
            and probe_keys.is_contiguous() and slots_key.is_contiguous()
            and slots_row.is_contiguous()):
        return
    build.require(probe_keys, "probe_keys", torch.int32, 1)
    build.require(slots_key, "slots_key", torch.int32, 1)
    build.require(slots_row, "slots_row", torch.int32, 1)


def hash_probe(probe_keys: torch.Tensor, slots_key: torch.Tensor,
               slots_row: torch.Tensor, max_probes: int = 32):
    """Probe int32 keys against the table → (row int32, -1 where absent; found).

    ``probe_keys`` may be a view at any offset: the kernel reads keys that
    do not start on a 16-byte boundary 4 bytes at a time."""
    if build.on_cpu(probe_keys, slots_key, slots_row):
        return hash_probe_ref(probe_keys, slots_key, slots_row, max_probes)
    _require_int32_vectors(probe_keys, slots_key, slots_row)
    cap = slots_key.shape[0]
    if cap < 1 or cap & (cap - 1) or slots_row.shape[0] != cap:
        raise ValueError(f"table capacity must be one power of two, got "
                         f"{cap} keys and {slots_row.shape[0]} rows")
    n = probe_keys.shape[0]
    # two allocations: one buffer with an int32 and a bool view of it took
    # longer on the host (kernel_turns.py's pieces)
    row = torch.empty(n, dtype=torch.int32, device=probe_keys.device)
    found = torch.empty(n, dtype=torch.bool, device=probe_keys.device)
    if n == 0:
        return row, found
    index = probe_keys.get_device()
    build.launch("hash_probe", index, build.current_stream(index),
                 probe_keys.data_ptr(), slots_key.data_ptr(),
                 slots_row.data_ptr(), row.data_ptr(), found.data_ptr(), n,
                 cap, max_probes)
    return row, found
