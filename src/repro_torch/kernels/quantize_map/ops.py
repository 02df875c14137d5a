"""Adapter-dispatched entry points for the quantize_map kernels (counterpart
of ``repro.kernels.quantize_map.ops``): ``torch`` runs the plain versions,
``cuda`` the CUDA kernels.  Inputs are flattened; keys are int32."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("quantize_map", adapters.TORCH)(ref.quantize)
adapters.register("quantize_map", adapters.CUDA)(kernel.quantize)
adapters.register("dequantize_map", adapters.TORCH)(ref.dequantize)
adapters.register("dequantize_map", adapters.CUDA)(kernel.dequantize)


def quantize(x: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor,
             adapter: str | None = None) -> torch.Tensor:
    return adapters.dispatch("quantize_map", adapter)(
        x.reshape(-1), levels.reshape(-1), bins)


def dequantize(u: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor,
               adapter: str | None = None) -> torch.Tensor:
    return adapters.dispatch("dequantize_map", adapter)(
        u.reshape(-1), levels.reshape(-1), bins)
