"""minicpm-2b [dense] — arXiv:2404.06395 / hf openbmb/MiniCPM-2B.

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753; llama-like with μP
scaling (scale_emb=12, scale_depth=1.4, dim_model_base=256) and the WSD
schedule (implemented in optim/schedule.py).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    dim_model_base=256,
    ckpt_compress="zfp",
)
