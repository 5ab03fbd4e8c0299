"""Causal LM — counterpart of ``repro/models/lm.py``.

A configuration's layers are planned as (mixer, ffn) block kinds, mixer in
{attn, mla, mamba} and ffn in {mlp, moe, none}: the dense, MoE (phi3.5-moe),
MLA + MoE (deepseek-v2-lite, whose layer 0 is a dense prefix block),
Mamba (falcon-mamba) and hybrid (jamba: periods of 8 layers) families, the
encoder-decoder (whisper: a non-causal encoder over precomputed frame
embeddings, learned decoder positions, cross-attention after every decoder
block) and the VLM (llava: precomputed patch embeddings prepended to the
tokens).  ``CausalLM`` holds a ``ModuleList`` of blocks where the reference
has an unrolled prefix and a ``lax.scan`` over stacked periods; the layers
run in the same order with the same arithmetic.  Entry points: ``forward``
(→ final hidden states), ``encode``, ``logits_fn``, ``prefill``,
``loss_fn``, ``init_cache`` and ``decode_step``.

Where autograd records (a training step), each scan step of the reference
(one period, or a decoder block and its cross-attention) is recomputed in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does.

The model runs on the current CUDA device unless ``device="cpu"`` is
passed, and raises without a card.  On the card its decode attention is the
hand-written kernel ``csrc/decode_attention.cu``; on the CPU the wrapper
runs its plain version.  ``device="meta"`` builds the shapes only (the dry
run's shard programs, ``launch/model_dryrun.py``).

Under an ambient mesh (``layers.mesh_context``) the residual stream is
pinned sequence-parallel (``_constrain_sp``) at the stack's input and
after every scan step, as the reference's; a shard program gathers and
scatters it around each mixer and ffn (``layers.tp_in`` / ``tp_out``), and
takes the embedding, the vocabulary and the last position through the
hooks ``embed_rows``, ``vocab_log_softmax``, ``vocab_take`` and
``last_position`` (``layers.MeshContext``).  Without a mesh each is what
it was on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L


@dataclasses.dataclass(frozen=True)
class BlockKind:
    mixer: str   # attn | mla | mamba
    ffn: str     # mlp | moe | none


def layer_plan(cfg: ArchConfig) -> List[BlockKind]:
    plan = []
    for li in range(cfg.n_layers):
        if cfg.family == "ssm":
            plan.append(BlockKind("mamba", "none"))
            continue
        in_p = li % cfg.period
        if cfg.family == "hybrid":
            mixer = "attn" if in_p in cfg.attn_idx_in_period else "mamba"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = "attn"
        if cfg.moe is not None and li >= cfg.first_dense_layers \
                and li % cfg.moe_every == (cfg.moe_every - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        plan.append(BlockKind(mixer, ffn))
    return plan


def _period_len(cfg: ArchConfig) -> int:
    p = cfg.period
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe_every)
    return p


def default_device() -> torch.device:
    """The card the model runs on; there is no silent fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: CausalLM runs on the GPU; pass device='cpu' to "
            "run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def _constrain_sp(x: torch.Tensor) -> torch.Tensor:
    """The reference's sequence-parallel constraint of the (B, S, d)
    residual stream: (batch axes, 'model', None) where S divides the model
    axis (the batch axes where they divide B), else the identity.  A shard
    program keeps its own rows of S from here on."""
    mesh = L.get_mesh()
    if mesh is None or "model" not in mesh.sizes or x.dim() != 3:
        return x
    m = mesh.sizes["model"]
    if x.shape[1] % m != 0:
        return x
    baxes = tuple(n for n in ("pod", "data") if n in mesh.sizes)
    if baxes and x.shape[0] % math.prod(mesh.sizes[a] for a in baxes):
        baxes = ()
    spec = (baxes if len(baxes) > 1 else (baxes[0] if baxes else None),
            "model", None)
    return mesh.sequence_parallel(mesh.pin(x, spec))


def _add(x: torch.Tensor, o: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The residual add ``x + o`` in x's dtype, and its float32 value before
    rounding.  The reference's norm reads the second: XLA computes a bf16
    op whose result is cast to float32 at once (rmsnorm's first step) in
    float32, so a norm of a residual sum made in the same compiled step
    sees it unrounded."""
    s = x.to(torch.float32) + o
    return s.to(x.dtype), s


class Block(nn.Module):
    """One layer of any ``BlockKind``: the reference's ``_init_block``,
    with its parameter names (``attn`` for both attention kinds, ``mamba``,
    ``ffn``; no ``ln2`` where the ffn is ``none``)."""

    def __init__(self, cfg: ArchConfig, kind: BlockKind, gen: torch.Generator,
                 device, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.eps = cfg.norm_eps

        def norm():
            return nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device), requires_grad=False)

        self.ln1 = norm()
        if kind.mixer == "attn":
            self.attn = L.Attention(cfg, gen, device, dtype)
        elif kind.mixer == "mla":
            self.attn = L.MLA(cfg, gen, device, dtype)
        else:
            self.mamba = L.Mamba(cfg, gen, device, dtype)
        if kind.ffn != "none":
            self.ln2 = norm()
            self.ffn = (L.MoE(cfg, gen, device, dtype) if kind.ffn == "moe"
                        else L.MLP(cfg, gen, device, dtype))

    def _ffn(self, x: torch.Tensor, x32: torch.Tensor,
             stacked: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kind.ffn == "none":
            return x, x32
        h = L.tp_in(L.rmsnorm(x32, self.ln2, self.eps, x.dtype))
        return _add(x, L.tp_out(self.ffn(h, stacked) if self.kind.ffn == "moe"
                                else self.ffn(h)))

    def forward(self, x: torch.Tensor, x32: Optional[torch.Tensor] = None,
                stacked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_block_train``: x (B,S,d) → (x, its float32
        value before rounding).  ``x32``: the float32 value of ``x`` where it
        is a residual sum of the same scan step (None where ``x`` comes
        from the embedding or a step's carry).  ``stacked``: the block is in
        the scanned stack (not the prefix), whose forward rounds the router
        and ``a_log`` to the compute dtype."""
        h = L.tp_in(L.rmsnorm(x if x32 is None else x32, self.ln1, self.eps,
                              x.dtype))
        if self.kind.mixer == "mamba":
            x, x32 = _add(x, L.tp_out(self.mamba(h, stacked)))
        else:
            x, x32 = _add(x, L.tp_out(self.attn(h)))
        return self._ffn(x, x32, stacked)

    def decode(self, x: torch.Tensor, x32: Optional[torch.Tensor],
               cache: Dict, length: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_block_decode``, as ``forward`` with a cache
        that it advances in place."""
        h = L.tp_in(L.rmsnorm(x if x32 is None else x32, self.ln1, self.eps,
                              x.dtype))
        if self.kind.mixer == "attn":
            o = self.attn.decode(h, cache["k"], cache["v"], length)
        elif self.kind.mixer == "mla":
            o = self.attn.decode(h, cache["ckv"], cache["krope"], length)
        else:
            o, cache["conv"], cache["ssm"] = self.mamba.decode(
                h, cache["conv"], cache["ssm"])
        x, x32 = _add(x, L.tp_out(o))
        return self._ffn(x, x32, stacked=False)


def _norm(cfg: ArchConfig, device, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device),
                        requires_grad=False)


class CrossAttention(nn.Module):
    """The reference's ``_cross_attend`` (whisper): ``ln`` and an ``attn``
    of the GQA layer's weights; queries from the decoder's stream, keys and
    values projected from the encoder output at every call (the reference
    recomputes them every decode step too), no RoPE, non-causal blockwise
    attention over every encoder row."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln = _norm(cfg, device, dtype)
        self.attn = L.Attention(cfg, gen, device, dtype)

    def forward(self, x: torch.Tensor, x32: Optional[torch.Tensor],
                enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B,S,d) (``x32``: its float32 value before rounding, which the
        norm reads), enc_out (B,S_enc,d) → (x + attention, its float32
        value before rounding)."""
        cfg, ap = self.cfg, self.attn
        h = L.tp_in(L.rmsnorm(x if x32 is None else x32, self.ln,
                              cfg.norm_eps, x.dtype))
        b, s = h.shape[:2]
        se, hd = enc_out.shape[1], cfg.resolved_head_dim
        q = (h @ ap.wq).reshape(b, s, -1, hd)
        k = L.hooks().kv_columns(enc_out @ ap.wk).reshape(b, se, -1, hd)
        v = L.hooks().kv_columns(enc_out @ ap.wv).reshape(b, se, -1, hd)
        k, v = L.hooks().heads_kv(q, k, v)
        o = L.blockwise_attention(q, k, v, causal=False)
        return _add(x, L.tp_out(o.reshape(b, s, -1) @ ap.wo))


class EncoderLayer(nn.Module):
    """One layer of the reference's ``_encoder``: ``ln1``, a non-causal
    ``attn``, ``ln2``, a (gelu) ``ffn``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm(cfg, device, dtype)
        self.attn = L.Attention(cfg, gen, device, dtype)
        self.ln2 = _norm(cfg, device, dtype)
        self.ffn = L.MLP(cfg, gen, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B,S_enc,d), the scan's carry (rounded) → the next carry.  The
        second norm reads the fresh residual sum unrounded (``_add``)."""
        x, x32 = _add(x, L.tp_out(self.attn(
            L.tp_in(L.rmsnorm(x, self.ln1, self.eps)), causal=False)))
        h = L.tp_in(L.rmsnorm(x32, self.ln2, self.eps, x.dtype))
        return _add(x, L.tp_out(self.ffn(h)))[0]


def _run(fn, i: int, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(i, x, *args)``, recomputed in the backward pass where autograd
    records the stream (a training step: the reference's
    ``jax.checkpoint`` of a scan step)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fn, i, x, *args, use_reentrant=False)
    return fn(i, x, *args)


# rows of whisper's learned decoder positions (the reference's table)
DEC_POS_ROWS = 32768


class CausalLM(nn.Module):
    """A causal LM with random weights at the reference's scales.

    ``dtype`` is the compute dtype (the config's by default); matmul weights
    and norms are kept in it (the MoE router and Mamba's ``a_log`` in
    float32: ``models/layers.py``).  The embedding (and an untied head) stay
    float32, as ``logits_fn`` multiplies in float32; the token lookup casts
    the gathered rows.  Weights are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the model's device, so one seed gives one model per
    device type (not the reference's numbers: ``models/convert.py`` loads
    those)."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        plan = layer_plan(cfg)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = dtype or getattr(torch, cfg.dtype)
        self.plan = plan
        self.n_prefix = cfg.first_dense_layers
        self.period = _period_len(cfg)
        gen = None
        if self.device.type != "meta":     # meta: shapes only
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        dev, f32 = self.device, torch.float32
        self.embed = nn.Parameter(L.normal(
            gen, (cfg.padded_vocab, cfg.d_model), 0.02, dev, f32),
            requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(
            cfg.d_model, dtype=self.dtype, device=dev), requires_grad=False)
        self.head = None if cfg.tie_embeddings else nn.Parameter(L.normal(
            gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dev,
            f32), requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, gen, dev, self.dtype) for kind in plan)
        if cfg.enc_layers:          # whisper: encoder, positions, cross-attn
            self.enc_pos = nn.Parameter(L.normal(
                gen, (cfg.enc_seq, cfg.d_model), 0.02, dev, f32),
                requires_grad=False)
            self.enc = nn.ModuleList(EncoderLayer(cfg, gen, dev, self.dtype)
                                     for _ in range(cfg.enc_layers))
            self.dec_pos = nn.Parameter(L.normal(
                gen, (DEC_POS_ROWS, cfg.d_model), 0.02, dev, f32),
                requires_grad=False)
            self.cross = nn.ModuleList(CrossAttention(cfg, gen, dev, self.dtype)
                                       for _ in plan)

    # -- forward / prefill -------------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The reference's ``_encoder``: frames (B,enc_seq,d) precomputed
        frame embeddings → encoder output (B,enc_seq,d) in the compute
        dtype."""
        x = frames.to(self.dtype) + self.enc_pos.to(self.dtype)
        for layer in self.enc:
            x = layer(x)
        return x

    def forward(self, tokens: torch.Tensor,
                img_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B,S) → final hidden states (B,S_total,d).  A VLM takes
        ``img_embeds`` (B,P,d), prepended to the token embeddings
        (S_total = P + S); an encoder-decoder takes ``frames``
        (B,enc_seq,d) for its encoder."""
        cfg = self.cfg
        x = L.hooks().embed_rows(self.embed, tokens).to(self.dtype)
        if cfg.n_img_tiles:
            if img_embeds is None:
                raise ValueError(f"{cfg.name} needs img_embeds")
            x = torch.cat([img_embeds.to(self.dtype), x], dim=1)
        enc_out = None
        if cfg.enc_layers:
            if frames is None:
                raise ValueError(f"{cfg.name} needs frames")
            enc_out = self.encode(frames)
            x = x + self.dec_pos[:x.shape[1]].to(self.dtype)
        for i, block in enumerate(self.blocks):
            if i == self.n_prefix:
                x = _constrain_sp(x)
            if i < self.n_prefix:     # each prefix block alone
                x = block(x)[0]
            elif enc_out is not None:
                x = _run(self._decoder_layer, i, x, enc_out)
            elif (i - self.n_prefix) % self.period == 0:
                x = _run(self._period, i, x)
        return L.rmsnorm(x, self.final_norm, cfg.norm_eps)

    def _period(self, first: int, x: torch.Tensor) -> torch.Tensor:
        """One scan step of the reference's stack: the period of blocks
        from ``first``, its carry in and out rounded; inside the period a
        block's first norm reads the previous block's float32 sum."""
        x32 = None
        for i in range(first, first + self.period):
            x, x32 = self.blocks[i](x, x32, stacked=True)
        return _constrain_sp(x)

    def _decoder_layer(self, i: int, x: torch.Tensor,
                       enc_out: torch.Tensor) -> torch.Tensor:
        """One scan step of the reference's encoder-decoder stack: block
        ``i``, then its cross-attention, whose norm reads the block's
        float32 sum (the next block reads the rounded carry)."""
        x, x32 = self.blocks[i](x, None, stacked=True)
        return _constrain_sp(self.cross[i](x, x32, enc_out)[0])

    def _x32(self, i: int, x32: torch.Tensor) -> Optional[torch.Tensor]:
        """What block ``i`` reads of the previous block's float32 sum: the
        reference runs each prefix block alone and the stack one period a
        scan step, so only a block inside a period gets it (the first
        block of a step reads the carry, rounded)."""
        j = i - self.n_prefix
        return x32 if j > 0 and j % self.period else None

    def logits_fn(self, hidden: torch.Tensor) -> torch.Tensor:
        """float32 hidden @ float32 head (the tied embedding's transpose),
        the padded vocabulary tail set to -1e30."""
        head = self.head
        if head is None:
            head = self.embed.T
        logits = hidden.to(torch.float32) @ head.to(torch.float32)
        if logits.shape[-1] > self.cfg.vocab:    # (a shard's slice: none)
            logits[..., self.cfg.vocab:] = L.NEG_INF
        return logits

    def prefill(self, tokens: torch.Tensor,
                img_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward → logits of the last position (B,1,V)."""
        return self.logits_fn(L.hooks().last_position(
            self.forward(tokens, img_embeds, frames)))

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The reference's ``loss_fn``: next-token cross entropy of
        ``batch["tokens"]`` against ``batch["targets"]`` (B,S), float32
        log-softmax, targets < 0 ignored, the sum over the kept positions
        divided by their count (at least 1).  A VLM's image positions
        carry no loss."""
        tokens = batch["tokens"]
        hidden = self.forward(tokens, batch.get("img_embeds"),
                              batch.get("frames"))
        hidden = L.tp_in(hidden)
        if self.cfg.n_img_tiles:
            hidden = hidden[:, -tokens.shape[1]:]
        logp = L.hooks().vocab_log_softmax(self.logits_fn(hidden))
        targets = batch["targets"]
        mask = targets >= 0
        nll = -L.hooks().vocab_take(logp,
                                    targets.clamp(min=0).to(torch.int64))
        return (nll * mask).sum() / mask.sum().clamp(min=1)

    # -- serving -----------------------------------------------------------

    def _block_cache(self, kind: BlockKind, batch: int,
                     max_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if kind.mixer == "attn":
            shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape)}
        if kind.mixer == "mla":
            m = cfg.mla
            return {"ckv": zeros(batch, max_len, m.kv_lora_rank),
                    "krope": zeros(batch, max_len, m.qk_rope_head_dim)}
        mm = cfg.mamba
        din = mm.expand * cfg.d_model
        return {"conv": zeros(batch, mm.d_conv - 1, din),
                "ssm": zeros(batch, din, mm.d_state, dtype=torch.float32)}

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """{"layers": one dict per layer — {"k", "v"} (B,max_len,KVH,hd)
        for attention, {"ckv", "krope"} (B,max_len,rank / rope_dim) for MLA,
        {"conv" (B,K-1,din), "ssm" (B,din,N) float32} for Mamba —, "length":
        (B,) int32 fill; an encoder-decoder's "enc_out" (B,enc_seq,d), zeros
        until the caller stores ``encode(frames)`` there}."""
        cache = {"layers": [self._block_cache(kind, batch, max_len)
                            for kind in self.plan],
                 "length": torch.zeros(batch, dtype=torch.int32,
                                       device=self.device)}
        if self.cfg.enc_layers:
            cache["enc_out"] = torch.zeros(
                (batch, self.cfg.enc_seq, self.cfg.d_model), dtype=self.dtype,
                device=self.device)
        return cache

    def decode_step(self, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) → (logits (B,1,V), cache).  The cache is advanced in
        place: each layer's rows or state are written and ``length`` becomes
        ``length + 1``; the same dict is returned."""
        length = cache["length"]
        x = L.hooks().embed_rows(self.embed, tokens).to(self.dtype)
        if self.cfg.enc_layers:       # learned positions, clipped to the table
            row = length.to(torch.int64).clamp(0, DEC_POS_ROWS - 1)
            x = x + self.dec_pos.to(self.dtype)[row][:, None]
        enc_out = None
        if self.cfg.enc_layers:       # a shard program's cache splits d
            enc_out = L.hooks().cache_enc_out(cache["enc_out"])
        x32 = None
        for i, (block, c) in enumerate(zip(self.blocks, cache["layers"])):
            x, x32 = block.decode(x, self._x32(i, x32), c, length)
            if enc_out is not None:
                x, x32 = self.cross[i](x, x32, enc_out)
                x32 = None            # the next block reads the carry
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.logits_fn(x)
        cache["length"] = length + 1
        return logits, cache
