"""Plain PyTorch version of the quantize_map kernels (the CUDA kernels'
oracle and the ``torch`` backend's implementation; counterpart of
``repro.kernels.quantize_map.ref``, which reuses ``core.quantize``).

Keys are the uint32 bits carried in int32.  Levels outside ``[0, len(bins))``
are clamped into it, as the kernel clamps them.
"""

from __future__ import annotations

import torch

from ...core.quantize import (
    dequantize_by_subset,
    quantize_by_subset,
    signed_to_unsigned,
    unsigned_to_signed,
)


def _levels(levels: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    return levels.reshape(-1).clamp(0, bins.numel() - 1)


def quantize(x: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``(N,)`` float32 values, int32 levels, ``(L+1,)`` float32 bins → ``(N,)``
    int32 zig-zagged keys."""
    q = quantize_by_subset(x.reshape(-1), _levels(levels, bins), bins)
    return signed_to_unsigned(q)


def dequantize(u: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``(N,)`` int32 zig-zagged keys, int32 levels, float32 bins → ``(N,)``
    float32 values."""
    q = unsigned_to_signed(u.reshape(-1))
    return dequantize_by_subset(q, _levels(levels, bins), bins)
