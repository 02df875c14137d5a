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
# the reference runs JAX without 64-bit types: a 64-bit dtype computes as its 32-bit one
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32, torch.uint64: torch.uint32}


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


def quantize(x: torch.Tensor, bin_size) -> torch.Tensor:
    """Uniform scalar quantizer: ``q = int32(round_half_even(x / bin))``.

    ``x`` is taken in its float dtype (an integer or float64 ``x`` as
    float32, as JAX without 64-bit types takes it), ``bin_size`` a scalar or
    a tensor that broadcasts against it; subnormals count as zero and the
    conversion saturates, as on XLA.
    """
    dtype = x.dtype if x.dtype in (torch.float16, torch.bfloat16) else torch.float32
    x = x.to(dtype)
    b = torch.as_tensor(bin_size, dtype=dtype, device=x.device)
    if dtype == torch.float32:
        x, b = flush_subnormal(x), flush_subnormal(b)
    return saturating_int32(torch.round(x / b).to(torch.float32))


def dequantize(q: torch.Tensor, bin_size, dtype=torch.float32) -> torch.Tensor:
    """``q * bin`` as ``dtype``.

    The reference asks for float64, which JAX without 64-bit types computes
    in float32: so does the port, with XLA's subnormal flush, then converts
    to ``dtype`` as XLA converts (``stages.library.float32_to``).
    """
    from .stages.library import float32_to  # lazy: layer order

    b = flush_subnormal(torch.as_tensor(bin_size, dtype=torch.float32, device=q.device))
    return float32_to(flush_subnormal(q.to(torch.float32) * b), dtype)


def quantize_by_subset(x: torch.Tensor, subset_ids: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Per-subset (per-level) quantization via Map&Process → int32."""
    quotient = map_and_process_param(
        flush_subnormal(x.to(torch.float32)), subset_ids,
        lambda v, b: v / b, flush_subnormal(bins.to(torch.float32)),
    )
    return saturating_int32(torch.round(quotient))


def dequantize_by_subset(
    q: torch.Tensor, subset_ids: torch.Tensor, bins: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """``dtype(q) * dtype(bins)[level]``, computed in ``dtype``.

    float32 and bfloat16 count a subnormal bin or product as zero (XLA
    computes both with float32's denormals-are-zero; float16's subnormals
    are normal there); a 64-bit ``dtype`` computes in its 32-bit type, as
    JAX without 64-bit types does.
    """
    dtype = _NARROW.get(dtype, dtype)
    flush = flush_subnormal if dtype in (torch.float32, torch.bfloat16) else (lambda x: x)
    out = map_and_process_param(
        q.to(dtype), subset_ids, lambda v, b: v * b, flush(bins.to(dtype)),
    )
    return flush(out)


def signed_to_unsigned(q: torch.Tensor) -> torch.Tensor:
    """Zig-zag int32 → the uint32 key's bits, as int32: ``(q << 1) ^ (q >> 31)``."""
    q = q.to(torch.int32)
    return (q << 1) ^ (q >> 31)


def unsigned_to_signed(u: torch.Tensor) -> torch.Tensor:
    """Inverse zig-zag of uint32 bits carried as int32:
    ``((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)`` (a logical shift)."""
    u = u.to(torch.int32)
    return ((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)
