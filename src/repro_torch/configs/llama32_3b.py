"""llama3.2-3b [dense] — 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=128, rope_theta=500_000.0, tie_embeddings=True,
    skip_shapes=("long_500k",),
))
