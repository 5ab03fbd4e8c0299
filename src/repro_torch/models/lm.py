"""Causal LM — counterpart of ``repro/models/lm.py``.

A configuration's layers are planned as (mixer, ffn) block kinds, mixer in
{attn, mla, mamba} and ffn in {mlp, moe, none}: the dense, MoE (phi3.5-moe),
MLA + MoE (deepseek-v2-lite, whose layer 0 is a dense prefix block),
Mamba (falcon-mamba) and hybrid (jamba: periods of 8 layers) families.
``CausalLM`` holds a ``ModuleList`` of blocks where the reference has an
unrolled prefix and a ``lax.scan`` over stacked periods; the layers run in
the same order with the same arithmetic.  Entry points: ``forward`` (→
final hidden states), ``logits_fn``, ``prefill``, ``init_cache`` and
``decode_step``.

A configuration with an encoder (whisper) or image tokens (llava) raises
``NotImplementedError`` (ROADMAP.md, queue 1, LM stack).

The model runs on the current CUDA device unless ``device="cpu"`` is
passed, and raises without a card.  On the card its decode attention is the
hand-written kernel ``csrc/decode_attention.cu``; on the CPU the wrapper
runs its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

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
        h = L.rmsnorm(x32, self.ln2, self.eps, x.dtype)
        return _add(x, self.ffn(h, stacked) if self.kind.ffn == "moe"
                    else self.ffn(h))

    def forward(self, x: torch.Tensor, x32: Optional[torch.Tensor] = None,
                stacked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_block_train``: x (B,S,d) → (x, its float32
        value before rounding).  ``x32``: the float32 value of ``x`` where it
        is a residual sum of the same scan step (None where ``x`` comes
        from the embedding or a step's carry).  ``stacked``: the block is in
        the scanned stack (not the prefix), whose forward rounds the router
        and ``a_log`` to the compute dtype."""
        h = L.rmsnorm(x if x32 is None else x32, self.ln1, self.eps, x.dtype)
        if self.kind.mixer == "mamba":
            x, x32 = _add(x, self.mamba(h, stacked))
        else:
            x, x32 = _add(x, self.attn(h))
        return self._ffn(x, x32, stacked)

    def decode(self, x: torch.Tensor, x32: Optional[torch.Tensor],
               cache: Dict, length: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_block_decode``, as ``forward`` with a cache
        that it advances in place."""
        h = L.rmsnorm(x if x32 is None else x32, self.ln1, self.eps, x.dtype)
        if self.kind.mixer == "attn":
            o = self.attn.decode(h, cache["k"], cache["v"], length)
        elif self.kind.mixer == "mla":
            o = self.attn.decode(h, cache["ckv"], cache["krope"], length)
        else:
            o, cache["conv"], cache["ssm"] = self.mamba.decode(
                h, cache["conv"], cache["ssm"])
        x, x32 = _add(x, o)
        return self._ffn(x, x32, stacked=False)


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
        if cfg.enc_layers or cfg.n_img_tiles:
            raise NotImplementedError(
                f"{cfg.name}: the encoder and image-token prefix are not "
                f"ported; see ROADMAP.md (queue 1, LM stack)")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = dtype or getattr(torch, cfg.dtype)
        self.plan = plan
        self.n_prefix = cfg.first_dense_layers
        self.period = _period_len(cfg)
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

    # -- forward / prefill -------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B,S) → final hidden states (B,S,d)."""
        x, x32 = self.embed[tokens].to(self.dtype), None
        for i, block in enumerate(self.blocks):
            x, x32 = block(x, self._x32(i, x32), stacked=i >= self.n_prefix)
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)

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
        head = self.embed.T if self.head is None else self.head
        logits = hidden.to(torch.float32) @ head
        if self.cfg.padded_vocab != self.cfg.vocab:
            logits[..., self.cfg.vocab:] = L.NEG_INF
        return logits

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward → logits of the last position (B,1,V)."""
        return self.logits_fn(self.forward(tokens)[:, -1:])

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
        (B,) int32 fill}."""
        return {"layers": [self._block_cache(kind, batch, max_len)
                           for kind in self.plan],
                "length": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device)}

    def decode_step(self, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) → (logits (B,1,V), cache).  The cache is advanced in
        place: each layer's rows or state are written and ``length`` becomes
        ``length + 1``; the same dict is returned."""
        length = cache["length"]
        x = self.embed[tokens].to(self.dtype)
        x32 = None
        for i, (block, c) in enumerate(zip(self.blocks, cache["layers"])):
            x, x32 = block.decode(x, self._x32(i, x32), c, length)
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.logits_fn(x)
        cache["length"] = length + 1
        return logits, cache
