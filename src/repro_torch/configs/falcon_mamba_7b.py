"""falcon-mamba-7b [ssm] — 64L d=4096 attn-free vocab=65024 ssm_state=16.

Mamba1 architecture (selective SSM, depthwise causal conv, expand=2).
Runs long_500k (sub-quadratic decode).  [arXiv:2410.05355; unverified]
"""
from .base import ArchConfig, MambaCfg, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024, mamba=MambaCfg(d_state=16, expand=2, d_conv=4),
    attn_idx_in_period=(),   # no attention layers at all
))
