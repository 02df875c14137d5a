"""Huffman encode kernel on Hopper — launch wrapper for
``csrc/huffman_encode.cu``.

Counterpart of ``repro.kernels.huffman_encode.kernel.encode_lookup`` (the
Pallas TPU kernel).  The CUDA source says what bounds it and how its design
answers that; this module checks what it is given, allocates the outputs,
launches on PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"encode_lookup": 0}

_SIGNATURES = {"huffman_encode_lookup": [PTR, I64, PTR, PTR, INT, PTR, PTR, PTR]}


def reset_launches() -> None:
    launches["encode_lookup"] = 0


def encode_lookup(
    keys: torch.Tensor, codes_table: torch.Tensor, lens_table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N,)`` int32 keys + ``(K,)`` int32 codes (uint32 bits) and lengths
    → ``((N,) int32 codes, (N,) int32 lengths)``; keys clamped into ``[0, K)``."""
    if route(keys, "huffman_encode"):
        return ref.encode_lookup(keys, codes_table, lens_table)
    dev = keys.device
    n, k = keys.numel(), codes_table.numel()
    if not 1 <= k < (1 << 31):
        raise ValueError(f"the codebook must have 1 to 2^31 - 1 entries, got {k}")
    require(keys, "keys", torch.int32, (n,), dev)
    require(codes_table, "codes_table", torch.int32, (k,), dev)
    require(lens_table, "lens_table", torch.int32, (k,), dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        rc = library("huffman_encode", _SIGNATURES).huffman_encode_lookup(
            keys.data_ptr(), n, codes_table.data_ptr(), lens_table.data_ptr(), k,
            codes.data_ptr(), lens.data_ptr(), stream(dev),
        )
        raise_on(rc, "huffman_encode_lookup")
        count_launch(launches, "encode_lookup")
    return codes, lens
