"""deepseek-67b [dense] — arXiv:2401.02954 / hf deepseek-ai/deepseek-llm-67b.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400; llama-arch.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    fsdp=True,
    ckpt_compress="zfp",
)
