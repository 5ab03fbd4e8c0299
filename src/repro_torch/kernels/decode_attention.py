"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

Counterpart of ``repro/kernels/decode_attention.py::decode_attention`` with
the semantics of its plain version ``ref.decode_attention_ref`` (which the
reference's ``attention_decode`` computes): the two differ only where
``lengths`` is <= 0 or > S, and there the kernel follows the plain version.

The kernel splits each row's cache over ``n_split`` blocks (flash
decoding) and combines their partial softmaxes in one launch; the split
count is chosen here, by a function the CPU tests hold.

On tensors that hold no data (the ``meta`` device, or fake tensors: the
dry run's shard programs, ``launch/model_dryrun.py``) the wrapper calls the
shape-only op ``torch.ops.repro_torch.decode_attention``, which the dry
run's counter sees as one operation and counts by ``decode_attention_flops``
(what the kernel would launch on the card); it launches nothing.
"""
from __future__ import annotations

import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build
from .ref import decode_attention_ref

# the shape-only op of tensors that hold no data (the dry run)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor lengths) "
            "-> Tensor")


def _shape_only(q, k, v, lengths):
    return torch.empty_like(q)


# the fake implementation serves ``meta`` tensors too
torch.library.register_fake("repro_torch::decode_attention")(_shape_only)


def decode_attention_flops(q_shape, k_shape) -> int:
    """Multiply-adds x 2 of one call over the cache's whole S, as the
    reference's jnp decode attention counts them (two batched products of
    B x H x S x D): 4 B H S D."""
    b, h, d = q_shape
    return 4 * b * h * k_shape[1] * d


def _holds_no_data(t: torch.Tensor) -> bool:
    return t.is_meta or isinstance(t, FakeTensor)


MAX_HEAD_DIM = 256
MAX_SPLITS = 64          # csrc/decode_attention.cu kMaxSplits
BLOCKS_PER_SM = 4        # the grid the split count aims at
MIN_SPLIT_ROWS = 64      # no split count that leaves full rows shorter


def group_chunk(groups: int) -> int:
    """Query heads a block takes (csrc ``by_group``): the whole group up to
    4, else up to 8 (larger groups take several blocks per KV head)."""
    return groups if groups <= 4 else 8


def split_count(b: int, kvh: int, groups: int, s: int, sms: int) -> int:
    """Blocks each (row, KV head, head chunk) splits its cache rows over:
    about BLOCKS_PER_SM blocks for each of the card's ``sms`` SMs, no split
    of a full row shorter than MIN_SPLIT_ROWS, at most MAX_SPLITS.  It
    depends on the shapes only, never on ``lengths`` (read on the device)."""
    base = b * kvh * -(-groups // group_chunk(groups))
    return max(1, min(BLOCKS_PER_SM * sms // base, -(-s // MIN_SPLIT_ROWS),
                      MAX_SPLITS))


# (device index, stream) -> (int32 tickets, float32 partials): the
# kernel's counters, zero between launches, and its split partials; kept
# per stream so that launches on one stream, which run in order, share them
_workspaces: dict = {}
_workspaces_lock = threading.Lock()


def _workspace(index: int, stream: int, n_tickets: int, n_part: int, device):
    key = (index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_tickets or ws[1].numel() < n_part:
        with _workspaces_lock:
            ws = _workspaces.get(key)
            if ws is not None:   # grow; the zeroing is ordered on the stream
                n_tickets = max(n_tickets, ws[0].numel())
                n_part = max(n_part, ws[1].numel())
            ws = _workspaces[key] = (
                torch.zeros(n_tickets, dtype=torch.int32, device=device),
                torch.empty(n_part, dtype=torch.float32, device=device))
    return ws


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over a cache: q (B,H,D) against k/v
    (B,S,KVH,D), row ``b`` masked to its first ``lengths[b]`` positions
    → (B,H,D) in q's dtype.

    On the card: q, k and v contiguous, all bfloat16 or all float32, H a
    multiple of KVH, D a multiple of 16 up to 256, ``lengths`` int32 (B,)
    on the same device (read there: no host sync)."""
    if _holds_no_data(q):
        return torch.ops.repro_torch.decode_attention(q, k, v, lengths)
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
    if b >= 2**31 or s >= 2**31 or h >= 2**16:
        raise ValueError(f"decode_attention takes B and S below 2^31 and H "
                         f"below 2^16, got B={b}, S={s}, H={h}")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("decode_attention: q, k and v must start on a "
                         "16-byte boundary")
    index = q.get_device()
    n_split = split_count(b, kvh, h // kvh, s, build.sm_count(index))
    if b * kvh * -(-(h // kvh) // group_chunk(h // kvh)) * n_split >= 2**31:
        raise ValueError(f"decode_attention: B={b} needs 2^31 blocks or more")
    stream = build.current_stream(index)
    tickets, part = _workspace(index, stream, b * h,
                               b * h * n_split * (d + 2) if n_split > 1 else 0,
                               q.device)
    build.launch("decode_attention", index, stream, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 part.data_ptr(), tickets.data_ptr(), b, s, h, kvh, d,
                 n_split, int(q.dtype == torch.bfloat16))
    return out
