"""Architecture config schema — counterpart of ``repro/configs/base.py``.

The dense-family part of the reference's ``ArchConfig``, shape set,
registry, ``reduced()`` and ``param_count()`` (pure Python, kept here so the
port imports nothing of ``repro``).  ``ArchConfig`` keeps every field of the
reference's, so a dense configuration is the same record in both packages;
the MoE, Mamba and MLA sub-configs stay opaque (``layer_plan`` reads only
whether one is set) until the slice that ports their family.  ``get_config``
of a configuration of another family raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


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
    moe: Optional[object] = None            # MoE sub-config (not ported)
    moe_every: int = 1                      # MoE layer cadence (jamba: 2)
    first_dense_layers: int = 0             # deepseek: layer 0 is dense FFN
    mamba: Optional[object] = None          # Mamba sub-config (not ported)
    mla: Optional[object] = None            # MLA sub-config (not ported)
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
        """Total parameters (embedding included once if tied); dense family
        only."""
        if self.family != "dense":
            raise NotImplementedError(f"{self.name}: param_count of the "
                                      f"{self.family} family is not ported")
        d, hd = self.d_model, self.resolved_head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        ffn = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        return (self.n_layers * (attn + ffn + 2 * d)          # 2 norms a layer
                + self.vocab * d * (1 if self.tie_embeddings else 2)
                + d)                                           # final norm


_REGISTRY: Dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# configurations of the reference whose families (MoE, MLA, Mamba, hybrid,
# encoder-decoder, VLM) the port does not run yet
NOT_PORTED = ("deepseek-v2-lite-16b", "falcon-mamba-7b", "jamba-v0.1-52b",
              "llava-next-mistral-7b", "phi3.5-moe-42b-a6.6b", "whisper-medium")


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: only the dense family is ported to PyTorch so far; "
            f"the other families are queued in ROADMAP.md (queue 1, LM stack)")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from . import llama32_3b, qwen2_72b, qwen2_7b, qwen3_4b  # noqa: F401


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant of a dense configuration: same topology, tiny
    dims."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, max(cfg.period, 2) * 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        head_dim=16,
        d_ff=128,
        vocab=503,
        dtype="float32",
    )
