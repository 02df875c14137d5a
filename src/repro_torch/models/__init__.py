"""Model substrate in PyTorch (counterpart of ``repro.models``): the dense,
vlm, ssm, moe, hybrid and encdec families."""

from . import attention, encdec, layers, model, moe, rglru, ssm, transformer  # noqa: F401
from .model import Model, build_model, load_params  # noqa: F401
