"""qwen3-4b [dense] — 36L d=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm + GQA; head_dim=128 per the HF config (not d_model/n_heads).
[hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),   # pure full attention: no sub-quadratic path
))
