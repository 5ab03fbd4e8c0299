"""Architecture config schema — counterpart of ``repro/configs/base.py``.

The reference's ``ArchConfig`` with its MoE, Mamba and MLA sub-configs, the
shape set, the registry, ``reduced()``, ``param_count()`` and
``active_param_count()`` (pure Python, kept here so the port imports nothing
of ``repro``): a configuration is the same record in both packages, and the
registry holds the same ten.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class MoECfg:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass
class MambaCfg:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    dt_rank: Optional[int] = None          # default ceil(d_model/16)


@dataclasses.dataclass
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                               # train | prefill | decode


# the assigned shape set (LM family)
LM_SHAPES = [
    Shape("train_4k", 4_096, 256, "train"),
    Shape("prefill_32k", 32_768, 32, "prefill"),
    Shape("decode_32k", 32_768, 128, "decode"),
    Shape("long_500k", 524_288, 1, "decode"),
]


@dataclasses.dataclass
class ArchConfig:
    name: str
    family: str                             # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    moe_every: int = 1                      # MoE layer cadence (jamba: 2)
    first_dense_layers: int = 0             # deepseek: layer 0 is dense FFN
    mamba: Optional[MambaCfg] = None
    mla: Optional[MLACfg] = None
    # hybrid pattern: for each layer index in a period, 'attn' or 'mamba'
    period: int = 1
    attn_idx_in_period: Tuple[int, ...] = (0,)
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                        # fixed encoder frames (stub frontend)
    # vlm (llava)
    n_img_tiles: int = 0                    # anyres tiles per sample
    img_patches: int = 0                    # patch embeddings per tile
    dtype: str = "bfloat16"
    mlp_kind: str = "swiglu"                # swiglu (3 mats) | gelu (2 mats)
    # which assigned shapes apply (long_500k only for sub-quadratic archs)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 for even ('model',) sharding of the
        embedding/head tables (MaxText-style padding; loss masks the tail)."""
        return ((self.vocab + 255) // 256) * 256

    def shapes(self) -> List[Shape]:
        out = [s for s in LM_SHAPES if s.name not in self.skip_shapes]
        return out

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        per_layer_attn = 0
        if self.mla is not None:
            m = self.mla
            q_dim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer_attn = (d * q_dim                       # W_q
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * self.n_heads
                              * (m.qk_nope_head_dim + m.v_head_dim)
                              + self.n_heads * m.v_head_dim * d)
        else:
            per_layer_attn = (d * self.n_heads * hd
                              + 2 * d * self.n_kv_heads * hd
                              + self.n_heads * hd * d)

        def ffn_params(ff):
            return (3 if self.mlp_kind == "swiglu" else 2) * d * ff

        def moe_params():
            m = self.moe
            routed = m.n_experts * ffn_params(m.expert_d_ff)
            shared = m.n_shared * ffn_params(m.expert_d_ff)
            return routed + shared + d * m.n_experts

        def mamba_params():
            mm = self.mamba
            d_in = mm.expand * d
            dt_rank = mm.dt_rank or -(-d // 16)
            return (d * 2 * d_in + d_in * mm.d_conv
                    + d_in * (dt_rank + 2 * mm.d_state) + dt_rank * d_in
                    + d_in * mm.d_state + d_in + d_in * d)

        total = 0
        for li in range(self.n_layers):
            in_period = li % self.period
            is_attn = in_period in self.attn_idx_in_period
            if self.family in ("ssm",) or (self.family == "hybrid" and not is_attn):
                total += mamba_params()
            else:
                total += per_layer_attn
            if self.moe is not None and li >= self.first_dense_layers \
                    and (li % self.moe_every == (self.moe_every - 1)):
                total += moe_params()
            elif self.family != "ssm":
                total += ffn_params(self.d_ff)
            total += 2 * d  # norms
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        total += d  # final norm
        if self.enc_layers:
            total += self.enc_layers * (per_layer_attn + ffn_params(self.d_ff)
                                        + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(
            1 for li in range(self.n_layers)
            if li >= self.first_dense_layers
            and li % self.moe_every == (self.moe_every - 1))
        per_expert = 3 * self.d_model * m.expert_d_ff
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return full - inactive


_REGISTRY: Dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from . import (  # noqa: F401
        deepseek_v2_lite_16b, falcon_mamba_7b, jamba_v01_52b, llama32_3b,
        llava_next_mistral_7b, phi35_moe_42b, qwen2_72b, qwen2_7b, qwen3_4b,
        whisper_medium,
    )


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    small = dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, max(cfg.period, 2) * 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        head_dim=16,
        d_ff=128,
        vocab=503,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=32 if cfg.enc_seq else 0,
        n_img_tiles=2 if cfg.n_img_tiles else 0,
        img_patches=8 if cfg.img_patches else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        small.moe = MoECfg(n_experts=min(cfg.moe.n_experts, 8),
                           top_k=min(cfg.moe.top_k, 2),
                           expert_d_ff=64, n_shared=cfg.moe.n_shared and 1)
    if cfg.mamba is not None:
        small.mamba = MambaCfg(d_state=8, expand=2, d_conv=4)
    if cfg.mla is not None:
        small.mla = MLACfg(kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16)
    return small
