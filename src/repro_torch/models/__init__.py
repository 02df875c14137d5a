"""Model substrate: the dense decoder in PyTorch (counterpart of
``repro.models``; the other families are still to be ported)."""

from . import attention, layers, model, transformer  # noqa: F401
from .model import Model, build_model, load_params  # noqa: F401
