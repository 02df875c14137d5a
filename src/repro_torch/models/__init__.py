"""Model substrate in PyTorch (counterpart of ``repro.models``): the dense,
vlm and ssm families; moe, hybrid and encdec are still to be ported."""

from . import attention, layers, model, ssm, transformer  # noqa: F401
from .model import Model, build_model, load_params  # noqa: F401
