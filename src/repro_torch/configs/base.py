"""Model/shape configuration schema (a copy of ``repro.configs.base``).

The port keeps its own copy: it imports nothing of ``repro``.  The fields
are the reference's, so a config names the same model in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0              # d_ff of those dense layers
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128                 # SSD chunk length (MXU-friendly)


@dataclass(frozen=True)
class HybridConfig:
    pattern: tuple[str, ...] = ("rec", "rec", "attn")  # RG 1 attn : 2 recurrent
    lru_width: int = 0               # 0 → d_model
    window: int = 2048               # local attention window
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    attn_type: str = "gqa"           # gqa | mla
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stub: none | audio_stub | vision_stub
    frontend: str = "none"
    mrope: bool = False              # qwen2-vl M-RoPE (3 rotary sections)
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # t/h/w splits of head_dim/2
    mtp: bool = False                # deepseek-v3 multi-token prediction head
    # minicpm μP-style scaling
    scale_emb: float = 1.0
    scale_depth: float = 0.0         # 0 → no residual scaling
    dim_model_base: int = 256
    # training-system knobs
    fsdp: bool = False               # additionally shard params over data axis
    remat: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # performance levers (§Perf hillclimb; defaults = paper-faithful baseline)
    sharding_policy: str = "tp"      # tp | fsdp_dp (pure DP + ZeRO-3 params)
    moe_group_size: int = 0          # >0: group-blocked MoE dispatch (GShard groups)
    moe_impl: str = "gshard"         # gshard (einsum dispatch) | a2a (shard_map
                                     # expert-parallel all-to-all routing)
    kv_replicate: int = 1            # decode: physically replicate KV heads to
                                     # fill the model axis (head-sharded cache)
    decode_masked_update: bool = False  # decode cache write via masked where
                                        # (shard-local on a seq-sharded cache)
                                        # instead of dynamic_update_slice
    # shape applicability
    supports_long_context: bool = False   # sub-quadratic decode state
    # HPDR integration defaults
    ckpt_compress: str = "zfp"       # checkpoint compression pipeline
    ckpt_rate: int = 16
    grad_compress_bits: int = 8      # cross-pod gradient compression

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = {
            "n_layers": min(self.n_layers, 4),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            "d_ff": 128,
            "vocab": 256,
            "head_dim": 16,
            "n_enc_layers": min(self.n_enc_layers, 2),
            "n_dec_layers": min(self.n_dec_layers, 2),
            "fsdp": False,
            "dtype": "float32",
            "param_dtype": "float32",
        }
        if self.moe is not None:
            small["moe"] = replace(
                self.moe,
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=128,
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.ssm is not None:
            small["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.hybrid is not None:
            small["hybrid"] = replace(self.hybrid, lru_width=64, window=32)
        if self.mrope:
            small["mrope_sections"] = (2, 3, 3)  # scaled to head_dim 16
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells for this arch; long_500k only for sub-quadratic decode."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        shapes.append("long_500k")
    return shapes
