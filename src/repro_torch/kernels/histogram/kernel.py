"""Histogram kernel on Hopper — launch wrapper for ``csrc/histogram.cu``.

Counterpart of ``repro.kernels.histogram.kernel.histogram`` (the Pallas TPU
kernel).  The CUDA source says what bounds it and how its design answers
that; this module checks what it is given, allocates the output, launches on
PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"histogram": 0}

_SIGNATURES = {
    "histogram_count": [PTR, I64, PTR, INT, PTR],
    "histogram_launch_info": [INT, PTR, PTR],
}


def reset_launches() -> None:
    launches["histogram"] = 0


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``(N,)`` int32 keys → ``(num_bins,)`` int32 counts of the keys in
    ``[0, num_bins)``."""
    if route(keys, "histogram"):
        return ref.histogram(keys, num_bins)
    num_bins = int(num_bins)
    if not 1 <= num_bins < (1 << 31):
        raise ValueError(f"num_bins must be in [1, 2^31), got {num_bins}")
    dev = keys.device
    require(keys, "keys", torch.int32, (keys.numel(),), dev)
    n = keys.numel()
    if n == 0:
        return torch.zeros(num_bins, dtype=torch.int32, device=dev)
    out = torch.empty(num_bins, dtype=torch.int32, device=dev)
    rc = library("histogram", _SIGNATURES).histogram_count(
        keys.data_ptr(), n, out.data_ptr(), num_bins, stream(dev),
    )
    raise_on(rc, "histogram")
    count_launch(launches, "histogram")
    return out


def launch_info(num_bins: int) -> dict[str, int]:
    """The dynamic shared memory (bytes) and the CTAs an SM holds of the
    launch for ``num_bins`` on the current card (both 0 where the alphabet
    counts in global memory).  Builds the library."""
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    rc = library("histogram", _SIGNATURES).histogram_launch_info(
        int(num_bins), ctypes.byref(smem), ctypes.byref(ctas),
    )
    raise_on(rc, "histogram_launch_info")
    return {"smem_bytes": smem.value, "ctas_per_sm": ctas.value}
