"""Architecture config registry (counterpart of ``repro.configs``).

The port registers every config of the reference: the dense decoder
(qwen2.5-3b, qwen1.5-4b, minicpm-2b, deepseek-67b), the vlm family
(qwen2-vl-72b: the dense block with M-RoPE), the ssm family (mamba2-370m),
the moe family (deepseek-v3-671b: MLA, routed experts, MTP;
llama4-scout-17b-a16e: GQA, routed experts), the hybrid family
(recurrentgemma-9b: RG-LRU blocks with local attention) and the encdec
family (seamless-m4t-medium: an encoder over frame embeddings, a decoder
with cross-attention).
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, applicable_shapes  # noqa: F401

from . import (  # noqa: E402
    deepseek_67b, deepseek_v3_671b, llama4_scout_17b_a16e, mamba2_370m, minicpm_2b, qwen1_5_4b,
    qwen2_5_3b, qwen2_vl_72b, recurrentgemma_9b, seamless_m4t_medium)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_v3_671b, llama4_scout_17b_a16e, recurrentgemma_9b, mamba2_370m,
              seamless_m4t_medium, qwen2_5_3b, qwen1_5_4b, minicpm_2b, deepseek_67b,
              qwen2_vl_72b)
}

# the reference's registry names no config the port lacks
NOT_PORTED: tuple[str, ...] = ()


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
