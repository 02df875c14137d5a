"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin) (unverified).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000;
RG-LRU + local attention, pattern (rec, rec, attn); window 2048.
Sub-quadratic decode state ⇒ runs long_500k.
"""

from .base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    hybrid=HybridConfig(
        pattern=("rec", "rec", "attn"),
        lru_width=4096,
        window=2048,
        conv_width=4,
    ),
    tie_embeddings=True,
    supports_long_context=True,
    ckpt_compress="zfp",
)
