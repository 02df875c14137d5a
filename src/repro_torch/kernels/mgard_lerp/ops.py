"""Adapter-dispatched entry point for the mgard_lerp kernel (counterpart of
``repro.kernels.mgard_lerp.ops``): ``torch`` runs the plain version, ``cuda``
the CUDA kernel.  No codec calls it: it is the reference's own entry point
for the stencil."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("mgard_lerp", adapters.TORCH)(ref.lerp_coefficients)
adapters.register("mgard_lerp", adapters.CUDA)(kernel.lerp_coefficients)


def lerp_coefficients(rows: torch.Tensor, adapter: str | None = None) -> torch.Tensor:
    return adapters.dispatch("mgard_lerp", adapter)(rows)
