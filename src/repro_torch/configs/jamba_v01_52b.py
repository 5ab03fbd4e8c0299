"""jamba-v0.1-52b [hybrid] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Mamba+attention 1:7 interleave (period 8, attention at in-period index 4),
MoE 16 experts top-2 on every 2nd layer.  Runs long_500k (hybrid is
sub-quadratic-dominated).  [arXiv:2403.19887; hf]
"""
from .base import ArchConfig, MambaCfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    mamba=MambaCfg(d_state=16, expand=2, d_conv=4),
    moe=MoECfg(n_experts=16, top_k=2, expert_d_ff=14336, n_shared=0),
    moe_every=2,
    period=8, attn_idx_in_period=(4,),
))
