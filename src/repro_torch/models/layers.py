"""Model layers — counterpart of ``repro/models/layers.py``.

Plain functions on tensors (``rmsnorm``, ``rope_freqs``, ``apply_rope``,
``_attend_block``, ``blockwise_attention``, ``_causal_conv``) and
``nn.Module``s for the GQA attention layer, MLA (DeepSeek-V2) attention,
the MLP, the MoE layer and Mamba-1.  The arithmetic follows the reference
step by step: norms and attention scores in float32, activations in the
compute dtype, the same blocking in ``blockwise_attention`` (the
prefill/forward attention, plain torch as it is plain jnp in the
reference), the same sort-based MoE dispatch with capacity, the same scan.

Differences from the reference, none of which changes a result:

- Weights are kept in the compute dtype.  The reference stores float32 and
  casts at every use; casting once at load gives the same values.  Two
  leaves are the exception: the MoE ``router`` and Mamba's ``a_log`` stay
  float32, because the reference's ``forward`` rounds them to the compute
  dtype in the layer stack only (it casts every stacked leaf of three or
  more dimensions before its scan) and its ``decode_step`` uses them as
  stored.  Their ``forward`` takes ``stacked`` to say which.
- ``Attention.decode`` and ``MLA.decode`` write the new rows into the cache
  in place (the reference returns new cache arrays), so a step copies no
  cache.
- ``constrain`` (the reference's mesh-sharding hint) is left out, and the
  MoE dispatch runs as one group (``_moe_groups``): on one card both are
  the identity.
- Decode attention goes through the hand-written kernel
  (``kernels/decode_attention.py``) where the reference calls its jnp
  twin ``decode_attention_ref``; the two compute the same function.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


# The reference's activations, op by op in the input's dtype: XLA rounds
# every step of jax.nn.silu (x * logistic(x), the logistic as
# 1 / (1 + exp(-x))), of jax.nn.softplus (logaddexp(x, 0)) and of
# jax.nn.gelu to bf16, where F.silu, F.softplus and F.gelu round once.


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh approximation, ``x * 0.5 * (1 + tanh(c * (x +
    0.044715 * x**3))))`` step by step in x's dtype, its two constants
    rounded to that dtype first (``x**3`` is ``(x * x) * x``)."""
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    inner = x + k * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """In float32, cast to ``dtype`` (x's by default), then times the weight
    in that dtype."""
    dtype = dtype or x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w.to(dtype)


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
    (w1, w2; the tanh approximation, ``jax.nn.gelu``'s default, as
    ``gelu`` computes it)."""

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
            return gelu(x @ self.w1) @ self.w2
        g = silu(x @ self.wg)
        return (g * (x @ self.wu)) @ self.wd


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) attention
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """The reference's ``init_mla`` / ``_mla_qkv`` (``_q`` and the
    expansion in ``forward`` and ``decode``) / ``mla_train`` (``forward``) /
    ``mla_decode`` (``decode``).  The cache holds the latent
    ``ckv`` (B,S,kv_lora_rank) and the rotated ``krope`` (B,S,rope_dim);
    every call expands the whole latent into per-head K and V, as the
    reference does."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        r = m.kv_lora_rank
        self.wq = _param(normal(gen, (d, h * qd), d ** -0.5, device, dtype))
        self.wdkv = _param(normal(gen, (d, r + m.qk_rope_head_dim), d ** -0.5,
                                  device, dtype))
        self.wuk = _param(normal(gen, (r, h * m.qk_nope_head_dim), r ** -0.5,
                                 device, dtype))
        self.wuv = _param(normal(gen, (r, h * m.v_head_dim), r ** -0.5,
                                 device, dtype))
        self.wo = _param(normal(gen, (h * m.v_head_dim, d),
                                (h * m.v_head_dim) ** -0.5, device, dtype))
        self.kv_norm = _param(torch.ones(r, dtype=dtype, device=device))

    def _latent(self, x: torch.Tensor, pos: torch.Tensor):
        """x (B,S,d) → the normed latent c_kv (B,S,r) and the rotated shared
        rope key (B,S,rope_dim)."""
        cfg, m = self.cfg, self.cfg.mla
        c_kv, k_rope = (x @ self.wdkv).split(
            [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
        c_kv = rmsnorm(c_kv, self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(k_rope[:, :, None], pos, cfg.rope_theta)[:, :, 0]
        return c_kv, k_rope

    def _q(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The rope-augmented query (B,S,H,nope+rope)."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        q = (x @ self.wq).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim
                                  + m.qk_rope_head_dim)
        q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
        return torch.cat([q_nope, apply_rope(q_rope, pos, cfg.rope_theta)],
                         dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mla_train: x (B,S,d) → (B,S,d), positions 0..S-1.  The latent is
        expanded into per-head k (B,S,H,nope+rope) and v (B,S,H,v)."""
        m = self.cfg.mla
        b, s, _ = x.shape
        h = self.cfg.n_heads
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        c_kv, k_rope = self._latent(x, pos)
        k_nope = (c_kv @ self.wuk).reshape(b, s, h, m.qk_nope_head_dim)
        v = (c_kv @ self.wuv).reshape(b, s, h, m.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        o = blockwise_attention(self._q(x, pos), k, v, causal=True)
        return o.reshape(b, s, -1) @ self.wo

    def decode(self, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """mla_decode: x (B,1,d); writes the new latent row at
        ``min(length, S-1)`` in place (``dynamic_update_slice``'s clamp),
        then expands every cache row into per-head K and V, as the reference
        does, and attends in float32 over the rows below ``length + 1``."""
        m = self.cfg.mla
        b, h = x.shape[0], self.cfg.n_heads
        pos = length[:, None].to(torch.int32)
        c_kv, k_rope = self._latent(x, pos)
        row = length.to(torch.int64).clamp(0, cache_ckv.shape[1] - 1)
        batch = torch.arange(b, device=x.device)
        cache_ckv[batch, row] = c_kv[:, 0]
        cache_krope[batch, row] = k_rope[:, 0]
        q = self._q(x, pos)[:, 0].to(torch.float32)              # (B,H,qd)
        sl, nope = cache_ckv.shape[1], m.qk_nope_head_dim
        # K and V written in float32 as (B,H,S,D) while they are converted,
        # so that the two products read them with no further copy
        k = torch.empty((b, h, sl, q.shape[-1]), dtype=torch.float32,
                        device=x.device)
        k[..., :nope] = (cache_ckv @ self.wuk).reshape(
            b, sl, h, nope).transpose(1, 2)
        k[..., nope:] = cache_krope[:, None]
        v = (cache_ckv @ self.wuv).reshape(b, sl, h, m.v_head_dim).transpose(
            1, 2).to(torch.float32, memory_format=torch.contiguous_format)
        s_ = (q[:, :, None] @ k.transpose(-1, -2))[:, :, 0] \
            / (q.shape[-1] ** 0.5)                                 # (B,H,S)
        mask = torch.arange(sl, device=x.device)[None, None] \
            < (length + 1)[:, None, None]
        pr = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
        o = (pr[:, :, None] @ v)[:, :, 0].to(x.dtype)             # (B,H,v)
        return o.reshape(b, 1, -1) @ self.wo


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_combine(contrib: torch.Tensor, tok: torch.Tensor,
                t: int) -> torch.Tensor:
    """Sum the (t·k, d) contributions into (t, d) rows by token ``tok`` in
    the order the rows come, one add at a time in their dtype: what the
    reference's ``zeros(...).at[tok].add(contrib)`` computes (its scatter
    applies the updates in order).  Each token's ``k`` rows are gathered
    and added in turn, with no atomics, so the card gives the same bits on
    every call."""
    k = contrib.shape[0] // t
    # the positions of each token's rows, ascending
    where = torch.sort(tok, stable=True).indices.reshape(t, k)
    y = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(k):
        y = y + contrib[where[:, j]]
    return y


class MoE(nn.Module):
    """The reference's ``init_moe`` / ``moe``: grouped sort-based token
    dispatch with capacity, as one group.  Route top-k in float32, sort the
    (token, expert) pairs by expert (stable), pack each expert's first
    ``cap`` rows into an (E, cap, d) buffer (the overflow is dropped), run
    the expert SwiGLU as batched products, and combine with the normalised
    gate weights (0 for a dropped pair).  ``n_shared`` shared experts are
    one MLP of ``n_shared * expert_d_ff``.  The router stays float32 (see
    the module docstring)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, ff, e = cfg.d_model, m.expert_d_ff, m.n_experts
        self.router = _param(normal(gen, (d, e), d ** -0.5, device,
                                    torch.float32))
        self.wg = _param(normal(gen, (e, d, ff), d ** -0.5, device, dtype))
        self.wu = _param(normal(gen, (e, d, ff), d ** -0.5, device, dtype))
        self.wd = _param(normal(gen, (e, ff, d), ff ** -0.5, device, dtype))
        self.shared = MLP(cfg, gen, device, dtype, d_ff=m.n_shared * ff) \
            if m.n_shared else None

    def route(self, xf: torch.Tensor, router: torch.Tensor):
        """xf (t,d) → (slot, tok, w, cap): over the t·k (token, expert)
        pairs in expert order, the buffer row of each pair (E·cap for a
        dropped one), its token and its gate weight (0 where dropped); and
        the rows per expert."""
        m = self.cfg.moe
        t = xf.shape[0]
        e, k = m.n_experts, m.top_k
        # rows per expert: k·t·capacity_factor/E up to a multiple of 8, >= 8
        cap = max((int(t * k * m.capacity_factor / e) + 7) // 8 * 8, 8)
        logits = xf.to(torch.float32) @ router.to(torch.float32)
        gates = torch.softmax(logits, dim=-1)
        # torch.topk fixes no order among exact ties (jax.lax.top_k takes
        # the lower index); float32 gates of real inputs have none
        top_w, top_e = torch.topk(gates, k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        flat_e = top_e.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        e_sorted = flat_e[order]
        tok_sorted = order // k
        w_sorted = top_w.reshape(-1)[order]
        starts = torch.searchsorted(
            e_sorted, torch.arange(e, device=xf.device, dtype=e_sorted.dtype))
        pos = torch.arange(t * k, device=xf.device) - starts[e_sorted]
        keep = pos < cap
        slot = torch.where(keep, e_sorted * cap + pos,
                           torch.full_like(pos, e * cap))
        return slot, tok_sorted, w_sorted * keep, cap

    def forward(self, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """x (B,S,d) → (B,S,d).  ``stacked``: the layer is in the
        reference's scanned stack, whose forward rounds the router to the
        compute dtype first."""
        m = self.cfg.moe
        b, s, d = x.shape
        t = b * s
        e = m.n_experts
        xf = x.reshape(t, d)
        router = self.router.to(x.dtype) if stacked else self.router
        slot, tok, w, cap = self.route(xf, router)
        xbuf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        xbuf[slot] = xf[tok]
        xb = xbuf[:-1].reshape(e, cap, d)
        yb = (silu(torch.bmm(xb, self.wg)) * torch.bmm(xb, self.wu))
        yb = torch.bmm(yb, self.wd).reshape(e * cap, d)
        contrib = yb[slot.clamp(0, e * cap - 1)] * w.to(x.dtype)[:, None]
        y = moe_combine(contrib, tok, t)
        if self.shared is not None:
            y = y + self.shared(xf)
        return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM)
# ---------------------------------------------------------------------------


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,din), w (K,din), tap by tap in x's
    dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i: i + x.shape[1]] * w[i].to(x.dtype)
    return out


class Mamba(nn.Module):
    """The reference's ``init_mamba`` / ``mamba_train`` (``forward``, the
    full scan) / ``mamba_decode`` (``decode``, one step over the
    (conv, ssm) state).  The scan runs in float32.  ``a_log`` stays float32
    (see the module docstring); the other weights are in the compute
    dtype."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        mm = cfg.mamba
        d = cfg.d_model
        din = mm.expand * d
        r = _dt_rank(cfg)
        self.win = _param(normal(gen, (d, 2 * din), d ** -0.5, device, dtype))
        self.conv = _param(normal(gen, (mm.d_conv, din), 0.2, device, dtype))
        self.wx = _param(normal(gen, (din, r + 2 * mm.d_state), din ** -0.5,
                                device, dtype))
        self.wdt = _param(normal(gen, (r, din), r ** -0.5, device, dtype))
        u = torch.rand(din, generator=gen, dtype=torch.float32, device=device)
        self.dt_bias = _param(torch.log(torch.expm1(
            (u * 0.1).clamp(min=1e-3))).to(dtype))
        self.a_log = _param(torch.log(torch.arange(
            1, mm.d_state + 1, dtype=torch.float32, device=device)).expand(
                din, mm.d_state).contiguous())
        self.d_skip = _param(torch.ones(din, dtype=dtype, device=device))
        self.wout = _param(normal(gen, (din, d), din ** -0.5, device, dtype))

    def _ssm_inputs(self, xin: torch.Tensor, a_log: torch.Tensor):
        """xin (...,din) after the conv → (da, dbx, C) of the recurrence
        h = da * h + dbx, y = h·C: da and dbx (...,din,N) float32.  The
        recurrence runs as one fused multiply-add (``addcmul``), as XLA
        compiles the reference's."""
        mm = self.cfg.mamba
        r = _dt_rank(self.cfg)
        dt_r, bmat, cmat = (xin @ self.wx).split([r, mm.d_state, mm.d_state],
                                                 dim=-1)
        delta = softplus(dt_r @ self.wdt + self.dt_bias.to(xin.dtype))
        a = -torch.exp(a_log)
        da = torch.exp(delta.to(torch.float32)[..., None] * a)
        # delta * xin in float32: XLA drops the bf16 rounding of a product
        # that is cast to float32 at once (a bf16 product is exact there)
        dbx = (delta.to(torch.float32) * xin.to(torch.float32))[..., None] \
            * bmat.to(torch.float32)[..., None, :]
        return da, dbx, cmat.to(torch.float32)

    def _out(self, y: torch.Tensor, xin: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
        y = y.to(xin.dtype) + xin * self.d_skip.to(xin.dtype)
        return (y * silu(z)) @ self.wout

    def forward(self, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """mamba_train: x (B,S,d) → (B,S,d).  ``stacked``: the layer is in
        the reference's scanned stack, whose forward rounds ``a_log`` to
        the compute dtype first (so ``a = -exp(a_log)`` is computed in
        it)."""
        xin, z = (x @ self.win).chunk(2, dim=-1)
        xin = silu(_causal_conv(xin, self.conv))
        a_log = self.a_log.to(x.dtype) if stacked else self.a_log
        da, dbx, cmat = self._ssm_inputs(xin, a_log)
        b, s = x.shape[:2]
        h = torch.zeros(da.shape[0], *da.shape[2:], dtype=torch.float32,
                        device=x.device)
        ys = []
        for i in range(s):
            h = torch.addcmul(dbx[:, i], da[:, i], h)
            ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, i]))
        del da, dbx
        return self._out(torch.stack(ys, dim=1), xin, z)

    def decode(self, x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
        """mamba_decode: x (B,1,d), conv_state (B,K-1,din), ssm_state
        (B,din,N) float32 → (out (B,1,d), new conv state, new ssm state)."""
        xin, z = (x[:, 0] @ self.win).chunk(2, dim=-1)
        window = torch.cat([conv_state, xin[:, None]], dim=1)   # (B,K,din)
        xin = silu(torch.einsum("bkd,kd->bd", window, self.conv))
        da, dbx, cmat = self._ssm_inputs(xin, self.a_log)
        h = torch.addcmul(dbx, da, ssm_state)
        y = torch.einsum("bdn,bn->bd", h, cmat)
        return self._out(y, xin, z)[:, None], window[:, 1:], h
