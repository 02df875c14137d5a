"""deepseek-v3-671b [moe] — arXiv:2412.19437 / hf deepseek-ai/DeepSeek-V3.

61L d_model=7168 128H (MLA) d_ff=2048(expert) vocab=129280;
MoE: 1 shared + 256 routed top-8; first 3 layers dense (d_ff 18432); MTP.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                    # dense-layer FFN width
    vocab=129280,
    head_dim=128,
    attn_type="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        first_dense_layers=3,
        d_ff_dense=18432,
    ),
    mtp=True,
    fsdp=True,
    ckpt_compress="zfp",
)
