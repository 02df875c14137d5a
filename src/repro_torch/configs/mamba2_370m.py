"""mamba2-370m [ssm] — arXiv:2405.21060 (unverified).

48L d_model=1024 attention-free, ssm_state=128, vocab=50280;
SSD (state-space duality) blocks.  O(1) decode state ⇒ runs long_500k.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,              # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    tie_embeddings=True,
    supports_long_context=True,
    ckpt_compress="zfp",
)
