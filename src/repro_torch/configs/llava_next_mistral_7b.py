"""llava-next-mistral-7b [vlm] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Transformer BACKBONE only; the anyres vision frontend is a STUB —
input_specs() provides precomputed patch embeddings (16 tiles x 576 patches)
prepended to the token sequence.  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, rope_theta=1_000_000.0,
    n_img_tiles=16, img_patches=576,
    skip_shapes=("long_500k",),
))
