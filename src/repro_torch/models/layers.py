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
- The reference's mesh-dependent paths take an ambient ``MeshContext``
  (``mesh_context``; the reference's ``compat.set_mesh``), ``None`` on one
  card, where every one of them is the identity and the MoE dispatches in
  one group.  Under a mesh ``constrain`` records the layout it pins and
  the MoE dispatches in as many groups as the mesh has data shards, each
  with its own capacity (``_moe_groups``), as the reference's.  A shard
  program (``launch/model_dryrun.py``) is a ``MeshContext`` that runs one
  shard at its local widths: the hooks below (``tp_in`` / ``tp_out``
  around each mixer and ffn, ``tp_sum``, ``heads_kv``, the embedding and
  vocabulary hooks, the decode overrides, the loop helpers) let it make
  the collectives its layouts force; every one of them is the identity
  without it.
- Decode attention goes through the hand-written kernel
  (``kernels/decode_attention.py``) where the reference calls its jnp
  twin ``decode_attention_ref``; the two compute the same function.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the ambient mesh (the reference's compat.set_mesh / get_abstract_mesh)
# ---------------------------------------------------------------------------


class MeshContext:
    """An ambient mesh: axis names and sizes (``axes``, as a ``ShardMesh``'s),
    and what the mesh-dependent paths did under it: ``pins`` holds the
    layout each ``constrain`` pinned.  Its methods are the model's hooks;
    here they are the logical program's, one tensor for the whole mesh
    (the identity but for the MoE's groups), and a shard program
    (``launch/model_dryrun.py::ShardProgram``) overrides them."""

    partitioned = False       # True: one shard's program at local widths

    def __init__(self, axes):
        self.axes = tuple(axes)
        self.sizes: Dict[str, int] = dict(self.axes)
        self.pins: List[Tuple[Tuple[int, ...], tuple]] = []

    def data_shards(self) -> int:
        return math.prod(self.sizes.get(a, 1) for a in ("pod", "data"))

    def pin(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        self.pins.append((tuple(x.shape), spec))
        return x

    def moe_groups(self, t: int) -> int:
        """The reference's ``_moe_groups``: the data shards, where they
        divide the tokens and the mesh has a ``model`` axis, else 1."""
        if "model" not in self.sizes:
            return 1
        n = self.data_shards()
        return n if n > 0 and t % n == 0 else 1

    # the tensor-parallel hooks (see the module docstring)
    def tp_in(self, h: torch.Tensor) -> torch.Tensor:
        """Into a mixer or an ffn (a shard gathers a sequence-parallel
        stream)."""
        return h

    def tp_out(self, o: torch.Tensor) -> torch.Tensor:
        """Out of a mixer or an ffn (a shard sums its row-parallel partial
        outputs)."""
        return o

    def tp_sum(self, p: torch.Tensor) -> torch.Tensor:
        """A product whose contracted width a shard splits (its partial
        sums, all-reduced)."""
        return p

    def kv_columns(self, t: torch.Tensor) -> torch.Tensor:
        """A column-split projection whose heads a shard needs whole (k and
        v where the KV heads do not divide the model axis, MLA's latent)."""
        return t

    def heads_kv(self, q, k, v):
        """k and v for q's heads (a shard holding fewer query heads than KV
        heads picks those its heads read)."""
        return k, v

    def sequence_parallel(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def embed_rows(self, embed: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
        return embed[tokens]

    def vocab_log_softmax(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(logits, dim=-1)

    def vocab_take(self, logp: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """logp (..., V) at ``targets`` (...) → (...)."""
        return logp.gather(-1, targets[..., None])[..., 0]

    def last_position(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden[:, -1:]

    def cache_enc_out(self, enc_out: torch.Tensor) -> torch.Tensor:
        return enc_out

    # loops of identical iterations (a shard program may sample them)
    def loop_map(self, n: int, body: Callable) -> list:
        """``[body(i) for i in range(n)]``."""
        return [body(i) for i in range(n)]

    def loop_fold(self, n: int, body: Callable, carry):
        """``carry = body(i, carry)`` for i in range(n)."""
        for i in range(n):
            carry = body(i, carry)
        return carry

    def loop_scan(self, n: int, body: Callable, carry):
        """``carry, y = body(i, carry)`` for i in range(n) → (carry,
        [y...])."""
        ys = []
        for i in range(n):
            carry, y = body(i, carry)
            ys.append(y)
        return carry, ys

    def stack_steps(self, ys: list, dim: int) -> torch.Tensor:
        """``torch.stack`` of a ``loop_scan``'s outputs."""
        return torch.stack(ys, dim=dim)


_MESH: Optional[MeshContext] = None
_ONE_CARD = MeshContext(())          # no mesh: every hook as on one card


def get_mesh() -> Optional[MeshContext]:
    return _MESH


def hooks() -> MeshContext:
    """The ambient mesh, or the one-card context where none is set."""
    return _MESH or _ONE_CARD


def tp_in(h: torch.Tensor) -> torch.Tensor:
    return hooks().tp_in(h)


def tp_out(o: torch.Tensor) -> torch.Tensor:
    return hooks().tp_out(o)


@contextlib.contextmanager
def mesh_context(mesh: Optional[MeshContext]):
    """Install ``mesh`` as the ambient mesh for the block (``None``: one
    card), restoring the previous one after."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def constrain_spec(shape, axes, sizes: Dict[str, int]) -> Optional[tuple]:
    """The reference's ``constrain`` rule: per dimension ``"batch"`` (the
    mesh's ``pod``/``data`` axes where they divide it), ``"model"`` (where
    it divides) or None; None for the whole spec where the mesh has no
    ``model`` axis."""
    if "model" not in sizes:
        return None
    baxes = tuple(n for n in ("pod", "data") if n in sizes)
    batch = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    spec = []
    for dim, a in zip(shape, axes):
        if a == "batch":
            n = math.prod(sizes[ax] for ax in baxes)
            spec.append(batch if n and dim % n == 0 else None)
        elif a == "model":
            spec.append("model" if dim % sizes["model"] == 0 else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Ambient-mesh layout constraint (the reference's ``constrain``):
    identity on values; under a mesh it records the layout it pins."""
    if _MESH is None:
        return x
    spec = constrain_spec(x.shape, axes, _MESH.sizes)
    return x if spec is None else _MESH.pin(x, spec)


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
    # the reference pins heads over 'model' through the block scans (k/v
    # replicated where KVH does not divide the axis)
    qt = constrain(qt, "batch", "model", None, None)
    kt = constrain(kt, "batch", "model", None, None)
    vt = constrain(vt, "batch", "model", None, None)

    def q_block(qi):
        q_blk = qt[:, :, qi * bq:(qi + 1) * bq]

        def kv_step(kj, carry):
            m_run, l_run, acc = carry
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
            return m_new, l_run, acc

        carry = (torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((b, h, bq), dtype=torch.float32, device=q.device),
                 torch.zeros((b, h, bq, dv), dtype=torch.float32,
                             device=q.device))
        _, l_run, acc = hooks().loop_fold(nk, kv_step, carry)
        return acc / l_run.clamp(min=1e-30)[..., None]

    blocks = hooks().loop_map(nq, q_block)
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
        k, v = hooks().kv_columns(k), hooks().kv_columns(v)
        # the heads this program holds (all of them on one card)
        q = q.reshape(b, s, -1, hd)
        k = k.reshape(b, s, -1, hd)
        v = v.reshape(b, s, -1, hd)
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
        k, v = hooks().heads_kv(q, k, v)
        o = blockwise_attention(q, k, v, causal=causal)
        return o.reshape(b, s, -1) @ self.wo

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
        if _MESH is not None and _MESH.partitioned:
            return _MESH.attention_decode(self, q, k, v, cache_k, cache_v,
                                          length)
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
        c_kv, k_rope = hooks().kv_columns(x @ self.wdkv).split(
            [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
        c_kv = rmsnorm(c_kv, self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(k_rope[:, :, None], pos, cfg.rope_theta)[:, :, 0]
        return c_kv, k_rope

    def _q(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The rope-augmented query (B,S,H,nope+rope)."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        q = (x @ self.wq).reshape(b, s, -1, m.qk_nope_head_dim
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
        wuk = self.wuk
        h = wuk.shape[1] // m.qk_nope_head_dim          # the heads held
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        c_kv, k_rope = self._latent(x, pos)
        k_nope = (c_kv @ wuk).reshape(b, s, h, m.qk_nope_head_dim)
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
        if _MESH is not None and _MESH.partitioned:
            return _MESH.mla_decode(self, x, cache_ckv, cache_krope, length)
        b = x.shape[0]
        pos = length[:, None].to(torch.int32)
        c_kv, k_rope = self._latent(x, pos)
        row = length.to(torch.int64).clamp(0, cache_ckv.shape[1] - 1)
        batch = torch.arange(b, device=x.device)
        cache_ckv[batch, row] = c_kv[:, 0]
        cache_krope[batch, row] = k_rope[:, 0]
        q = self._q(x, pos)[:, 0].to(torch.float32)              # (B,H,qd)
        o = self.attend_latent(q, cache_ckv, cache_krope, length, self.wuk,
                               self.wuv, x.dtype)
        return o.reshape(b, 1, -1) @ self.wo

    def attend_latent(self, q: torch.Tensor, cache_ckv: torch.Tensor,
                      cache_krope: torch.Tensor, length: torch.Tensor,
                      wuk: torch.Tensor, wuv: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """q (B,H,qd) float32 against every cache row expanded by ``wuk`` /
        ``wuv`` into per-head K and V, in float32 over the rows below
        ``length + 1`` → (B,H,v) in ``dtype``."""
        m = self.cfg.mla
        b, h = q.shape[:2]
        sl, nope = cache_ckv.shape[1], m.qk_nope_head_dim
        # K and V written in float32 as (B,H,S,D) while they are converted,
        # so that the two products read them with no further copy
        k = torch.empty((b, h, sl, q.shape[-1]), dtype=torch.float32,
                        device=q.device)
        k[..., :nope] = (cache_ckv @ wuk).reshape(
            b, sl, h, nope).transpose(1, 2)
        k[..., nope:] = cache_krope[:, None]
        v = (cache_ckv @ wuv).reshape(b, sl, h, m.v_head_dim).transpose(
            1, 2).to(torch.float32, memory_format=torch.contiguous_format)
        s_ = (q[:, :, None] @ k.transpose(-1, -2))[:, :, 0] \
            / (q.shape[-1] ** 0.5)                                 # (B,H,S)
        mask = torch.arange(sl, device=q.device)[None, None] \
            < (length + 1)[:, None, None]
        pr = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
        return (pr[:, :, None] @ v)[:, :, 0].to(dtype)


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
        compute dtype first.

        The t = B·S tokens dispatch in ``_moe_groups(t)`` groups of t / G
        consecutive tokens (one on one card), each routed, packed and
        combined on its own with its own capacity; the expert products run
        over all groups' buffers at once.  A shard program holding
        ``wg.shape[0]`` of the E experts (from ``expert_offset``) packs and
        runs only theirs, and its output is their partial sum."""
        m = self.cfg.moe
        b, s, d = x.shape
        t = b * s
        wg, wu, wd = self.wg, self.wu, self.wd
        e, el = m.n_experts, wg.shape[0]
        off = _MESH.expert_offset(e) if el != e else 0
        ng = _moe_groups(t)
        tl = t // ng
        xf = x.reshape(t, d)
        if _MESH is not None:
            constrain(xf.reshape(ng, tl, d), "batch", None, None)
        router = self.router.to(x.dtype) if stacked else self.router
        routes = [self.route(xf[g * tl:(g + 1) * tl], router)
                  for g in range(ng)]
        cap = routes[0][3]
        bufs = []
        for g, (slot, tok, _, _) in enumerate(routes):
            if el != e:      # this shard's experts only
                slot = slot - off * cap
                slot = torch.where((slot >= 0) & (slot < el * cap), slot,
                                   torch.full_like(slot, el * cap))
            xbuf = torch.zeros((el * cap + 1, d), dtype=x.dtype,
                               device=x.device)
            xbuf[slot] = xf[g * tl:(g + 1) * tl][tok]
            bufs.append(xbuf[:-1].reshape(el, cap, d))
        xb = bufs[0] if ng == 1 else torch.stack(bufs, 1).reshape(
            el, ng * cap, d)
        if _MESH is not None:
            constrain(xb.reshape(el, ng, cap, d).transpose(0, 1),
                      "batch", "model", None, None)
        yb = (silu(torch.bmm(xb, wg)) * torch.bmm(xb, wu))
        yb = torch.bmm(yb, wd)
        if _MESH is not None:
            constrain(yb.reshape(el, ng, cap, d).transpose(0, 1),
                      "batch", "model", None, None)
        ys = []
        for g, (slot, tok, w, _) in enumerate(routes):
            ybg = (yb if ng == 1 else yb[:, g * cap:(g + 1) * cap]).reshape(
                el * cap, d)
            if el != e:
                slot = slot - off * cap
                w = w * ((slot >= 0) & (slot < el * cap))
            contrib = ybg[slot.clamp(0, el * cap - 1)] * w.to(x.dtype)[:, None]
            ys.append(moe_combine(contrib, tok, tl))
        y = ys[0] if ng == 1 else torch.cat(ys)
        if self.shared is not None:
            y = y + self.shared(xf)
        return y.reshape(b, s, d)


def _moe_groups(t: int) -> int:
    """Dispatch groups: the ambient mesh's data shards (1 when unset), the
    reference's ``_moe_groups``."""
    return hooks().moe_groups(t)


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
        dt_r, bmat, cmat = hooks().tp_sum(xin @ self.wx).split(
            [r, mm.d_state, mm.d_state], dim=-1)
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
        if _MESH is not None:     # the reference pins the scan's din
            constrain(da, "batch", None, "model", None)
            constrain(dbx, "batch", None, "model", None)
        s = x.shape[1]
        h = torch.zeros(da.shape[0], *da.shape[2:], dtype=torch.float32,
                        device=x.device)
        if _MESH is not None:
            constrain(h, "batch", "model", None)

        def step(i, h):
            h = torch.addcmul(dbx[:, i], da[:, i], h)
            return h, torch.einsum("bdn,bn->bd", h, cmat[:, i])

        _, ys = hooks().loop_scan(s, step, h)
        del da, dbx
        return self._out(hooks().stack_steps(ys, 1), xin, z)

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
