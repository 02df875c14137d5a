"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B family.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936; QKV bias.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    ckpt_compress="zfp",
)
