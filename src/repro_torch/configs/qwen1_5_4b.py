"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5-4B family.

40L d_model=2560 20H (kv=20, full MHA) d_ff=6912 vocab=151936; QKV bias.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=5000000.0,
    ckpt_compress="zfp",
)
