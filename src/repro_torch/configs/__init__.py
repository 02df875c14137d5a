"""Architecture config registry (counterpart of ``repro.configs``).

The port registers the families it runs: so far the dense decoder
(qwen2.5-3b, qwen1.5-4b, minicpm-2b, deepseek-67b).  The reference's other
configs (moe, ssm, hybrid, encdec, vlm) join as their families are ported;
``ROADMAP.md`` lists them.
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, applicable_shapes  # noqa: F401

from . import deepseek_67b, minicpm_2b, qwen1_5_4b, qwen2_5_3b  # noqa: E402

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen2_5_3b, qwen1_5_4b, minicpm_2b, deepseek_67b)
}

# the reference's registry names these too; their families are not ported yet
NOT_PORTED = (
    "deepseek-v3-671b", "llama4-scout-17b-a16e", "recurrentgemma-9b", "mamba2-370m",
    "seamless-m4t-medium", "qwen2-vl-72b",
)


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (see ROADMAP.md); "
                       f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
