"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192(expert) vocab=202048;
MoE: 16 routed experts top-1 + 1 shared, every layer.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        n_shared=1,
        d_ff_expert=8192,
        first_dense_layers=0,
    ),
    rope_theta=500000.0,
    fsdp=True,
    ckpt_compress="zfp",
)
