"""Plain PyTorch version of the mgard_lerp kernel (the CUDA kernel's oracle
and the ``torch`` backend's implementation; counterpart of
``repro.kernels.mgard_lerp.ref``)."""

from __future__ import annotations

import torch


def lerp_coefficients(rows: torch.Tensor) -> torch.Tensor:
    """``(B, 2m+1)`` float32 → ``(B, m)``: ``u[2i+1] - ½(u[2i] + u[2i+2])``."""
    u = rows
    return u[:, 1::2] - 0.5 * (u[:, 0:-2:2] + u[:, 2::2])
