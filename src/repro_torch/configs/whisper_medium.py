"""whisper-medium [audio] — 24+24L d=1024 16H d_ff=4096 vocab=51865.

Encoder-decoder; conv frontend is a STUB — input_specs() provides 1500
precomputed frame embeddings.  Decoder runs the decode shapes (enc-dec, not
encoder-only); decoder positions beyond the trained 448 are a shape exercise,
noted in DESIGN.md.  [arXiv:2212.04356; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, rope_theta=0.0,      # learned/sinusoidal positions, no rope
    enc_layers=24, enc_seq=1500, mlp_kind="gelu",
    skip_shapes=("long_500k",),
))
