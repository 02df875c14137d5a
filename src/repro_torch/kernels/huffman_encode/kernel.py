"""Huffman encode kernels on Hopper — launch wrappers for
``csrc/huffman_encode.cu``.

``encode_lookup`` is the counterpart of
``repro.kernels.huffman_encode.kernel.encode_lookup`` (the Pallas TPU
kernel); ``pack_stream`` replaces no TPU kernel (the reference leaves the
scan and word packing to XLA).  The CUDA source says what bounds them and how
their design answers that; this module checks what they are given, allocates
the outputs and scratch, launches on PyTorch's current stream and raises if
a launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"encode_lookup": 0, "pack_stream": 0}

# Symbols a CTA of pack_stream packs (the source's kPackTile, which checks it).
PACK_TILE = 4096

_SIGNATURES = {
    "huffman_encode_lookup": [PTR, I64, PTR, PTR, INT, PTR, PTR, PTR],
    "huffman_pack_stream": [PTR, PTR, I64, I64, I64, INT, PTR, PTR, PTR, PTR],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def pack_stream(
    codes: torch.Tensor, lens: torch.Tensor, num_words: int, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N,)`` int32 codes (uint32 bits, right-aligned) and lengths in
    ``[0, 32]`` → ``(words[num_words] int32, chunk_offsets int32)``, the
    bytes of :func:`ref.pack_stream`: the codes MSB-first, words past the last
    code zero, and the bit offset of every ``chunk_size``-th symbol.

    ``num_words`` must hold the stream (the callers size it from the total
    bits the host holds); nothing is written past it.  No host sync."""
    num_words, chunk_size = int(num_words), int(chunk_size)
    if num_words < 0:
        raise ValueError(f"num_words must be >= 0, got {num_words}")
    if not 1 <= chunk_size < (1 << 63):
        raise ValueError(f"chunk_size must be a positive int64, got {chunk_size}")
    dev, n = lens.device, lens.numel()
    require(lens, "lens", torch.int32, (n,), dev)
    require(codes, "codes", torch.int32, (n,), dev)
    if route(lens, "huffman_pack_stream"):
        return ref.pack_stream(codes, lens, num_words, chunk_size)
    words = torch.empty(num_words, dtype=torch.int32, device=dev)
    chunk_offsets = torch.empty(-(-n // chunk_size), dtype=torch.int32, device=dev)
    if n == 0:
        return words.zero_(), chunk_offsets
    scratch = torch.empty(2 * -(-n // PACK_TILE) + 1, dtype=torch.int64, device=dev)
    rc = library("huffman_encode", _SIGNATURES).huffman_pack_stream(
        codes.data_ptr(), lens.data_ptr(), n, num_words, chunk_size, PACK_TILE,
        words.data_ptr(), chunk_offsets.data_ptr(), scratch.data_ptr(), stream(dev),
    )
    raise_on(rc, "huffman_pack_stream")
    count_launch(launches, "pack_stream")
    return words, chunk_offsets
