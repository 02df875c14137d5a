"""Linear quantization — the Map&Process stage of MGARD (counterpart of
``repro.core.quantize``).

Each element is mapped to its level (subset) and quantized with that level's
bin: ``q = int32(round_half_even(x / bin))``, zig-zagged to a 32-bit key so
that Huffman sees small magnitudes as small keys.

The reference runs on XLA, which treats a subnormal float as zero and
saturates float → int32 (±inf and values past the range to INT_MAX/INT_MIN,
NaN to 0).  PyTorch does neither, so these plain versions flush and saturate
explicitly; the CUDA kernel (``kernels/quantize_map``) does the same.

32-bit keys are carried as int32 tensors holding the uint32 bits, with
logical shifts written as arithmetic shifts plus masks (torch's uint32 has
no shifts or comparisons).
"""

from __future__ import annotations

import torch

from .abstractions import map_and_process_param

_FLT_MIN = torch.finfo(torch.float32).tiny
_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with every subnormal value replaced by a zero of its
    sign (XLA's denormals-are-zero)."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued float32 ``x`` → int32 as XLA converts: values past the
    range saturate and NaN becomes 0."""
    clipped = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big = clipped >= 2.0 ** 31
    small = clipped < -(2.0 ** 31)
    q = torch.where(big | small, torch.zeros_like(clipped), clipped).to(torch.int32)
    q = torch.where(big, torch.full_like(q, _INT32_MAX), q)
    return torch.where(small, torch.full_like(q, _INT32_MIN), q)


def quantize_by_subset(x: torch.Tensor, subset_ids: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Per-subset (per-level) quantization via Map&Process → int32."""
    quotient = map_and_process_param(
        flush_subnormal(x.to(torch.float32)), subset_ids,
        lambda v, b: v / b, flush_subnormal(bins.to(torch.float32)),
    )
    return saturating_int32(torch.round(quotient))


def dequantize_by_subset(q: torch.Tensor, subset_ids: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``float32(q) * bins[level]`` (a subnormal bin counts as zero)."""
    out = map_and_process_param(
        q.to(torch.float32), subset_ids, lambda v, b: v * b,
        flush_subnormal(bins.to(torch.float32)),
    )
    return flush_subnormal(out)


def signed_to_unsigned(q: torch.Tensor) -> torch.Tensor:
    """Zig-zag int32 → the uint32 key's bits, as int32: ``(q << 1) ^ (q >> 31)``."""
    q = q.to(torch.int32)
    return (q << 1) ^ (q >> 31)


def unsigned_to_signed(u: torch.Tensor) -> torch.Tensor:
    """Inverse zig-zag of uint32 bits carried as int32:
    ``((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)`` (a logical shift)."""
    u = u.to(torch.int32)
    return ((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)
