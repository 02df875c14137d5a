"""Adapter-dispatched entry point for the histogram kernel (counterpart of
``repro.kernels.histogram.ops``): ``torch`` runs the plain version, ``cuda``
the CUDA kernel."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("histogram", adapters.TORCH)(ref.histogram)
adapters.register("histogram", adapters.CUDA)(kernel.histogram)


def histogram(keys: torch.Tensor, num_bins: int, adapter: str | None = None) -> torch.Tensor:
    return adapters.dispatch("histogram", adapter)(keys, num_bins)
