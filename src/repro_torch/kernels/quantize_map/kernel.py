"""quantize_map kernels on Hopper — launch wrappers for ``csrc/quantize_map.cu``.

Counterparts of ``repro.kernels.quantize_map.kernel.quantize`` and
``dequantize`` (the Pallas TPU kernels).  The CUDA source says what bounds
them and how their design answers that; this module checks what it is
given, allocates the output, launches on PyTorch's current stream and raises
if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"quantize": 0, "dequantize": 0}

_SIGNATURES = {
    "quantize_map_quantize": [PTR, PTR, PTR, INT, I64, PTR, PTR],
    "quantize_map_dequantize": [PTR, PTR, PTR, INT, I64, PTR, PTR],
}
MAX_BINS = 1024  # the kernels stage the bin table in shared memory


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _launch(name: str, entry: str, src, levels, bins, src_dtype, out_dtype) -> torch.Tensor:
    dev = src.device
    n = src.numel()
    require(src, "input", src_dtype, (n,), dev)
    require(levels, "levels", torch.int32, (n,), dev)
    nb = bins.numel()
    if not 1 <= nb <= MAX_BINS:
        raise ValueError(f"bins must have 1 to {MAX_BINS} entries, got {nb}")
    require(bins, "bins", torch.float32, (nb,), dev)
    out = torch.empty(n, dtype=out_dtype, device=dev)
    if n:
        rc = getattr(library("quantize_map", _SIGNATURES), entry)(
            src.data_ptr(), levels.data_ptr(), bins.data_ptr(), nb, n, out.data_ptr(),
            stream(dev),
        )
        raise_on(rc, entry)
        count_launch(launches, name)
    return out


def quantize(x: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``(N,)`` float32 values + ``(N,)`` int32 levels + ``(L+1,)`` float32 bins
    → ``(N,)`` int32 zig-zagged keys (the uint32 bits)."""
    if route(x, "quantize_map"):
        return ref.quantize(x, levels, bins)
    return _launch("quantize", "quantize_map_quantize", x, levels, bins,
                   torch.float32, torch.int32)


def dequantize(u: torch.Tensor, levels: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """``(N,)`` int32 zig-zagged keys + levels + bins → ``(N,)`` float32."""
    if route(u, "quantize_map"):
        return ref.dequantize(u, levels, bins)
    return _launch("dequantize", "quantize_map_dequantize", u, levels, bins,
                   torch.int32, torch.float32)
