"""Causal LM of the dense family — counterpart of ``repro/models/lm.py``.

``CausalLM`` holds a ``ModuleList`` of blocks where the reference has a
``lax.scan`` over stacked parameters; the layers run in the same order
with the same arithmetic.  Entry points: ``forward`` (→ final hidden
states), ``logits_fn``, ``prefill``, ``init_cache`` and ``decode_step``.

Only blocks of kind (``attn``, ``mlp``) are ported: a configuration whose
plan has MLA, Mamba or MoE layers, an encoder or image tokens raises
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


DENSE = BlockKind("attn", "mlp")


def default_device() -> torch.device:
    """The card the model runs on; there is no silent fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: CausalLM runs on the GPU; pass device='cpu' to "
            "run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


class Block(nn.Module):
    """One (attn, mlp) layer: the reference's ``_init_block``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device), requires_grad=False)
        self.attn = L.Attention(cfg, gen, device, dtype)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                           device=device), requires_grad=False)
        self.ffn = L.MLP(cfg, gen, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``_block_train``."""
        eps = self.attn.cfg.norm_eps
        x = x + self.attn(L.rmsnorm(x, self.ln1, eps))
        return x + self.ffn(L.rmsnorm(x, self.ln2, eps))


class CausalLM(nn.Module):
    """A dense causal LM with random weights at the reference's scales.

    ``dtype`` is the compute dtype (the config's by default); matmul weights
    and norms are kept in it.  The embedding (and an untied head) stay
    float32, as ``logits_fn`` multiplies in float32; the token lookup casts
    the gathered rows.  Weights are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the model's device, so one seed gives one model per
    device type (not the reference's numbers: ``models/convert.py`` loads
    those)."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        plan = layer_plan(cfg)
        if cfg.enc_layers or cfg.n_img_tiles or any(k != DENSE for k in plan):
            raise NotImplementedError(
                f"{cfg.name}: only (attn, mlp) blocks without encoder or "
                f"image tokens are ported; see ROADMAP.md (queue 1, LM stack)")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = dtype or getattr(torch, cfg.dtype)
        self.plan = plan
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
            Block(cfg, gen, dev, self.dtype) for _ in plan)

    # -- forward / prefill -------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B,S) → final hidden states (B,S,d)."""
        x = self.embed[tokens].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)

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
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def init_cache(self, batch: int, max_len: int) -> Dict:
        """{"layers": one {"k", "v"} (B,max_len,KVH,hd) pair per layer,
        "length": (B,) int32 fill}."""
        return {"layers": [self._block_cache(kind, batch, max_len)
                           for kind in self.plan],
                "length": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device)}

    def _block_decode(self, block: Block, x: torch.Tensor, cache: Dict,
                      length: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h = L.rmsnorm(x, block.ln1, eps)
        x = x + block.attn.decode(h, cache["k"], cache["v"], length)
        return x + block.ffn(L.rmsnorm(x, block.ln2, eps))

    def decode_step(self, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) → (logits (B,1,V), cache).  The cache is advanced in
        place: each layer's k/v rows are written and ``length`` becomes
        ``length + 1``; the same dict is returned."""
        length = cache["length"]
        x = self.embed[tokens].to(self.dtype)
        for block, c in zip(self.blocks, cache["layers"]):
            x = self._block_decode(block, x, c, length)
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.logits_fn(x)
        cache["length"] = length + 1
        return logits, cache
