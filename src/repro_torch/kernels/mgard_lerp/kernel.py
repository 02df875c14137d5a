"""MGARD lerp kernel on Hopper — launch wrapper for ``csrc/mgard_lerp.cu``.

Counterpart of ``repro.kernels.mgard_lerp.kernel.lerp_coefficients`` (the
Pallas TPU kernel).  The CUDA source says what bounds it and how its design
answers that; this module checks what it is given, allocates the output,
launches on PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from .._launch import I64, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"lerp_coefficients": 0}

_SIGNATURES = {"mgard_lerp": [PTR, PTR, I64, I64, PTR]}


def reset_launches() -> None:
    launches["lerp_coefficients"] = 0


def lerp_coefficients(rows: torch.Tensor) -> torch.Tensor:
    """``(B, n)`` float32 rows, ``n = 2m + 1 >= 3`` → ``(B, m)`` float32."""
    if rows.ndim != 2 or rows.shape[1] < 3 or rows.shape[1] % 2 != 1:
        raise ValueError(f"rows must be (B, 2m+1) with m >= 1, got shape {tuple(rows.shape)}")
    if route(rows, "mgard_lerp"):
        return ref.lerp_coefficients(rows)
    batch, n = rows.shape
    m = (n - 1) // 2
    dev = rows.device
    require(rows, "rows", torch.float32, (batch, n), dev)
    out = torch.empty((batch, m), dtype=torch.float32, device=dev)
    if batch:
        rc = library("mgard_lerp", _SIGNATURES).mgard_lerp(
            rows.data_ptr(), out.data_ptr(), batch, m, stream(dev))
        raise_on(rc, "mgard_lerp")
        count_launch(launches, "lerp_coefficients")
    return out
