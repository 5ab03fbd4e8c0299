"""Wrapper of the join run-expansion kernel (``csrc/join_expand.cu``).

Counterpart of ``repro/kernels/join_expand.py::join_expand``; same
signature and semantics as ``ref.join_expand_ref``.
"""
from __future__ import annotations

import torch

from . import build
from .ref import join_expand_ref


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
    device = order.device
    probe_idx = torch.empty(total, dtype=torch.int64, device=device)
    build_idx = torch.empty(total, dtype=torch.int64, device=device)
    matched = torch.empty(total, dtype=torch.bool, device=device)
    if total == 0:
        return probe_idx, build_idx, matched
    ends = torch.cumsum(counts_out, 0)            # inclusive prefix sum
    with torch.cuda.device(device):
        err = build.lib().repro_join_expand(
            ends.data_ptr(), lo.data_ptr(), counts.data_ptr(),
            order.data_ptr(), probe_idx.data_ptr(), build_idx.data_ptr(),
            matched.data_ptr(), n, nb, total, build.stream_of(order))
    build.check(err, "join_expand")
    build.count_launch("join_expand")
    return probe_idx, build_idx, matched
