"""Adapter-dispatched entry point for the tridiag kernel (counterpart of
``repro.kernels.tridiag.ops``): ``torch`` runs the plain sweep, ``cuda`` the
CUDA kernel."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("tridiag_solve", adapters.TORCH)(ref.solve_mass)
adapters.register("tridiag_solve", adapters.CUDA)(kernel.solve_mass)


def solve_mass(rhs: torch.Tensor, h: float, adapter: str | None = None) -> torch.Tensor:
    return adapters.dispatch("tridiag_solve", adapter)(rhs, h)
