"""seamless-m4t-medium [audio] — arXiv:2308.11596 / hf facebook/seamless-m4t-medium.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206; encoder-decoder.
Audio frontend is a STUB: ``input_specs`` supplies precomputed frame
embeddings (B, S_enc, D) per the brief.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    frontend="audio_stub",
    ckpt_compress="zfp",
)
