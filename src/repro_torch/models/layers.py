"""Model layers of the dense family — counterpart of ``repro/models/layers.py``.

Plain functions on tensors (``rmsnorm``, ``rope_freqs``, ``apply_rope``,
``_attend_block``, ``blockwise_attention``) and ``nn.Module``s for the GQA
attention layer and the MLP.  The arithmetic follows the reference step by
step: norms and attention scores in float32, activations in the compute
dtype, the same blocking in ``blockwise_attention`` (the prefill/forward
attention, plain torch as it is plain jnp in the reference).

Differences from the reference, none of which changes a result:

- Weights are kept in the compute dtype.  The reference stores float32 and
  casts at every use; casting once at load gives the same values.
- ``Attention.decode`` writes the new key and value into the cache in place
  (the reference returns new cache arrays), so a step copies no cache.
- ``constrain`` (the reference's mesh-sharding hint) is left out: on one
  card it is the identity.
- Decode attention goes through the hand-written kernel
  (``kernels/decode_attention.py``) where the reference calls its jnp
  twin ``decode_attention_ref``; the two compute the same function.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention

NEG_INF = -1e30


def normal(gen: torch.Generator, shape, scale: float, device,
           dtype: torch.dtype) -> torch.Tensor:
    """Float32 normal draws times ``scale``, cast to ``dtype`` (the
    reference's ``normal``, cast once as it casts at use)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, cast to x's dtype, then times the weight in that dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D) with pos (..., S): rotate the first half of each head
    against the second half (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = pos[..., None].to(torch.float32) * freqs         # (...,S,D/2)
    cos = torch.cos(angles)[..., None, :]                     # (...,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise causal attention (training / prefill)
# ---------------------------------------------------------------------------


def _attend_block(q, k, v, q_off, k_off, causal, scale, kv_len):
    """q (B,H,bq,Dk) vs k (B,KVH,bk,Dk) / v (B,KVH,bk,Dv), GQA grouped
    → (block max, block sum, unnormalised output), all float32."""
    b, h, bq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, bq, d)
    s = torch.einsum("bkgqd,bkjd->bkgqj", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    kpos = k_off + torch.arange(k.shape[2], device=q.device)
    mask = (kpos < kv_len)[None, :].expand(bq, k.shape[2])
    if causal:
        qpos = q_off + torch.arange(bq, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqj,bkjd->bkgqd", p, v.to(torch.float32))
    return m, l, o


def blockwise_attention(q, k, v, causal: bool = True, block_q: int = 512,
                        block_kv: int = 1024) -> torch.Tensor:
    """Flash-style attention: q (B,Sq,H,Dk), k (B,Skv,KVH,Dk),
    v (B,Skv,KVH,Dv) → (B,Sq,H,Dv).  Sq may differ from Skv (cross-attn) and
    Dv from Dk.  Every kv block is visited (the causal mask zeroes the upper
    triangle), as in the reference."""
    b, sq, h, dk = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = 1.0 / (dk ** 0.5)
    bq = min(block_q, sq)
    bk = min(block_kv, skv)
    q_len = sq
    if sq % bq:                           # pad q
        q = F.pad(q, (0, 0, 0, 0, 0, bq - sq % bq))
        sq = q.shape[1]
    kv_len = skv
    if skv % bk:                          # pad + mask kv
        pad = bk - skv % bk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        skv += pad
    nq, nk = sq // bq, skv // bk

    qt = q.transpose(1, 2)                # (B,H,Sq,Dk)
    kt = k.transpose(1, 2)                # (B,KVH,Skv,Dk)
    vt = v.transpose(1, 2)
    blocks = []
    for qi in range(nq):
        q_blk = qt[:, :, qi * bq:(qi + 1) * bq]
        m_run = torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, h, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, bq, dv), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            m, l, o = _attend_block(q_blk, kt[:, :, kj * bk:(kj + 1) * bk],
                                    vt[:, :, kj * bk:(kj + 1) * bk],
                                    qi * bq, kj * bk, causal, scale, kv_len)
            m = m.reshape(b, h, bq)
            l = l.reshape(b, h, bq)
            o = o.reshape(b, h, bq, dv)
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)
            beta = torch.exp(m - m_new)
            l_run = l_run * alpha + l * beta
            acc = acc * alpha[..., None] + o * beta[..., None]
            m_run = m_new
        blocks.append(acc / l_run.clamp(min=1e-30)[..., None])
    out = torch.cat(blocks, dim=2).transpose(1, 2)          # (B,Sq,H,Dv)
    return out[:, :q_len].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The reference's ``init_attention`` / ``_qkv`` / ``attention_train``
    (``forward``) / ``attention_decode`` (``decode``).  Weights are (in, out)
    matrices, as the reference's, applied as ``x @ w``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        self.wq = _param(normal(gen, (d, h * hd), d ** -0.5, device, dtype))
        self.wk = _param(normal(gen, (d, kvh * hd), d ** -0.5, device, dtype))
        self.wv = _param(normal(gen, (d, kvh * hd), d ** -0.5, device, dtype))
        self.wo = _param(normal(gen, (h * hd, d), (h * hd) ** -0.5, device,
                                dtype))
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros(h * hd, dtype=dtype, device=device))
            self.bk = _param(torch.zeros(kvh * hd, dtype=dtype, device=device))
            self.bv = _param(torch.zeros(kvh * hd, dtype=dtype, device=device))
        if cfg.qk_norm:
            self.q_norm = _param(torch.ones(hd, dtype=dtype, device=device))
            self.k_norm = _param(torch.ones(hd, dtype=dtype, device=device))

    def _qkv(self, x: torch.Tensor, pos: torch.Tensor):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = x @ self.wq
        k = x @ self.wk
        v = x @ self.wv
        if cfg.qkv_bias:
            q = q + self.bq
            k = k + self.bk
            v = v + self.bv
        q = q.reshape(b, s, cfg.n_heads, hd)
        k = k.reshape(b, s, cfg.n_kv_heads, hd)
        v = v.reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        if cfg.rope_theta > 0:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        """attention_train: x (B,S,d) → (B,S,d), positions 0..S-1."""
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        q, k, v = self._qkv(x, pos)
        o = blockwise_attention(q, k, v, causal=causal)
        o = o.reshape(b, s, self.cfg.n_heads * self.cfg.resolved_head_dim)
        return o @ self.wo

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """attention_decode: x (B,1,d); cache (B,S,KVH,hd); length (B,)
        int32, the cache fill.  Writes the new key and value at row
        ``min(length, S-1)`` of each batch row, in place (the reference's
        ``dynamic_update_slice`` clamps its start the same way), then
        attends over the first ``length + 1`` rows (unclamped)."""
        b = x.shape[0]
        pos = length[:, None].to(torch.int32)                  # (B,1)
        q, k, v = self._qkv(x, pos)
        row = length.to(torch.int64).clamp(0, cache_k.shape[1] - 1)
        batch = torch.arange(b, device=x.device)
        cache_k[batch, row] = k[:, 0]
        cache_v[batch, row] = v[:, 0]
        o = decode_attention(q[:, 0], cache_k, cache_v, length + 1)
        o = o.reshape(b, 1, self.cfg.n_heads * self.cfg.resolved_head_dim)
        return o @ self.wo


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The reference's ``init_mlp`` / ``mlp``: swiglu (wg, wu, wd) or gelu
    (w1, w2; the tanh approximation, ``jax.nn.gelu``'s default)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype, d_ff: Optional[int] = None):
        super().__init__()
        self.kind = cfg.mlp_kind
        d = cfg.d_model
        ff = d_ff or cfg.d_ff
        if self.kind == "gelu":
            self.w1 = _param(normal(gen, (d, ff), d ** -0.5, device, dtype))
            self.w2 = _param(normal(gen, (ff, d), ff ** -0.5, device, dtype))
        else:
            self.wg = _param(normal(gen, (d, ff), d ** -0.5, device, dtype))
            self.wu = _param(normal(gen, (d, ff), d ** -0.5, device, dtype))
            self.wd = _param(normal(gen, (ff, d), ff ** -0.5, device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "gelu":
            return F.gelu(x @ self.w1, approximate="tanh") @ self.w2
        g = F.silu(x @ self.wg)
        return (g * (x @ self.wu)) @ self.wd
