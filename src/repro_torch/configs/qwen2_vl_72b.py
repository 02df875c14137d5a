"""qwen2-vl-72b [vlm] — arXiv:2409.12191 / hf Qwen/Qwen2-VL-72B.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; M-RoPE
(t/h/w rotary sections), dynamic-resolution vision frontend is a STUB
(``input_specs`` supplies patch embeddings + 3-D position triplets).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    frontend="vision_stub",
    fsdp=True,
    ckpt_compress="zfp",
)
