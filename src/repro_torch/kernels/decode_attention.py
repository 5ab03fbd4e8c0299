"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

Counterpart of ``repro/kernels/decode_attention.py::decode_attention`` with
the semantics of its plain version ``ref.decode_attention_ref`` (which the
reference's ``attention_decode`` computes): the two differ only where
``lengths`` is <= 0 or > S, and there the kernel follows the plain version.
"""
from __future__ import annotations

import torch

from . import build
from .ref import decode_attention_ref

MAX_HEAD_DIM = 256


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over a cache: q (B,H,D) against k/v
    (B,S,KVH,D), row ``b`` masked to its first ``lengths[b]`` positions
    → (B,H,D) in q's dtype.

    On the card: q, k and v contiguous, all bfloat16 or all float32, H a
    multiple of KVH, D a multiple of 16 up to 256, ``lengths`` int32 (B,)
    on the same device (read there: no host sync)."""
    if build.on_cpu(q, k, v, lengths):
        return decode_attention_ref(q, k, v, lengths)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_attention takes bfloat16 or float32, got "
                         f"{q.dtype}")
    build.require(q, "q", q.dtype, 3)
    build.require(k, "k", q.dtype, 4)
    build.require(v, "v", q.dtype, 4)
    build.require(lengths, "lengths", torch.int32, 1)
    b, h, d = q.shape
    _, s, kvh, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or lengths.shape[0] != b or b == 0 or s == 0 or kvh == 0
            or h % kvh or d % 16 or not 16 <= d <= MAX_HEAD_DIM):
        raise ValueError(
            f"decode_attention takes q (B,H,D), k and v (B,S,KVH,D) alike, "
            f"lengths (B,), with H a multiple of KVH and D a multiple of 16 "
            f"in [16, {MAX_HEAD_DIM}]; got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    if b >= 2**31 or s >= 2**31:
        raise ValueError(f"decode_attention takes B and S below 2^31, got "
                         f"B={b}, S={s}")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("decode_attention: q, k and v must start on a "
                         "16-byte boundary")
    with torch.cuda.device(q.device):
        err = build.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, s, h, kvh, d,
            int(q.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, "decode_attention")
    build.count_launch("decode_attention")
    return out
