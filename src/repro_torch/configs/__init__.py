"""Architecture config registry (counterpart of ``repro.configs``).

The port registers the families it runs: the dense decoder (qwen2.5-3b,
qwen1.5-4b, minicpm-2b, deepseek-67b), the vlm family (qwen2-vl-72b: the
dense block with M-RoPE), the ssm family (mamba2-370m) and the moe family
(deepseek-v3-671b: MLA, routed experts, MTP; llama4-scout-17b-a16e: GQA,
routed experts).  The reference's other configs (hybrid, encdec) join as
their families are ported; ``ROADMAP.md`` lists them.
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, applicable_shapes  # noqa: F401

from . import (  # noqa: E402
    deepseek_67b, deepseek_v3_671b, llama4_scout_17b_a16e, mamba2_370m, minicpm_2b, qwen1_5_4b,
    qwen2_5_3b, qwen2_vl_72b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_v3_671b, llama4_scout_17b_a16e, mamba2_370m, qwen2_5_3b, qwen1_5_4b,
              minicpm_2b, deepseek_67b, qwen2_vl_72b)
}

# the reference's registry names these too; their families are not ported yet
NOT_PORTED = ("recurrentgemma-9b", "seamless-m4t-medium")


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (see ROADMAP.md); "
                       f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
