"""phi3.5-moe-42b-a6.6b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=6400 vocab=32064.

16 experts, top-2 routing, every layer MoE.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, head_dim=128,
    moe=MoECfg(n_experts=16, top_k=2, expert_d_ff=6400, n_shared=0),
    skip_shapes=("long_500k",),
))
