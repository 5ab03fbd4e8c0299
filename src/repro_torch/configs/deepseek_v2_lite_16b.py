"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H d_ff(expert)=1408 vocab=102400.

MLA attention (kv_lora_rank=512, rope head 64, nope 128, v 128); MoE with
64 routed experts top-6 + 2 shared; layer 0 dense FFN (d_ff=10944).
The assignment line lists both "64e top-6" and "160 routed"; we follow the
HF V2-Lite config (64 routed) — see DESIGN.md §Config fidelity.
[arXiv:2405.04434; hf]
"""
from .base import ArchConfig, MLACfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400,
    mla=MLACfg(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
               v_head_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, expert_d_ff=1408, n_shared=2),
    first_dense_layers=1,
    skip_shapes=("long_500k",),   # MLA is still full attention
))
