"""Huffman decode kernel on Hopper — launch wrapper for
``csrc/huffman_decode.cu``.

Counterpart of ``repro.kernels.huffman_decode.kernel.decode_chunks`` (the
Pallas TPU kernel).  The CUDA source says what bounds it and how its design
answers that (a shared-memory lookup table built per CTA, a 128-bit window of
the stream in registers refilled from shared memory, stores staged per
warp); this module checks what it is given, allocates the output, launches
on PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from . import ref

launches = {"decode_chunks": 0}

_SIGNATURES = {
    "huffman_decode_chunks": [PTR, I64, PTR, INT, PTR, PTR, PTR, PTR, INT, INT, INT, PTR, PTR],
}
MAX_LEN = 32


def reset_launches() -> None:
    launches["decode_chunks"] = 0


def decode_chunks(
    words: torch.Tensor,
    chunk_offsets: torch.Tensor,
    first_code: torch.Tensor,
    count: torch.Tensor,
    sym_offset: torch.Tensor,
    sym_sorted: torch.Tensor,
    chunk_size: int,
    max_len: int,
) -> torch.Tensor:
    """Chunk-parallel canonical-Huffman decode: int32 ``[n_chunks, chunk_size]``.

    ``words`` int32 (uint32 bits), ``chunk_offsets`` int32, the three
    canonical tables int32 ``(max_len + 1,)`` (``first_code`` as uint32
    bits), ``sym_sorted`` int32 with at least one entry.
    """
    if route(words, "huffman_decode"):
        return ref.decode_chunks(words, chunk_offsets, first_code, count, sym_offset,
                                 sym_sorted, chunk_size, max_len)
    dev = words.device
    chunk_size, max_len = int(chunk_size), int(max_len)
    if not 1 <= max_len <= MAX_LEN:
        raise ValueError(f"max_len must be in [1, {MAX_LEN}], got {max_len}")
    if not 1 <= chunk_size < (1 << 31):
        raise ValueError(f"chunk_size must be in [1, 2^31), got {chunk_size}")
    n_chunks, n_sym = chunk_offsets.numel(), sym_sorted.numel()
    if n_sym < 1:
        raise ValueError("sym_sorted must hold at least one symbol")
    require(words, "words", torch.int32, (words.numel(),), dev)
    require(chunk_offsets, "chunk_offsets", torch.int32, (n_chunks,), dev)
    for name, t in (("first_code", first_code), ("count", count), ("sym_offset", sym_offset)):
        require(t, name, torch.int32, (max_len + 1,), dev)
    require(sym_sorted, "sym_sorted", torch.int32, (n_sym,), dev)
    if words.data_ptr() % 16:  # the kernel fetches the words 16 bytes at a time
        words = words.clone()
    out = torch.empty((n_chunks, chunk_size), dtype=torch.int32, device=dev)
    if n_chunks:
        rc = library("huffman_decode", _SIGNATURES).huffman_decode_chunks(
            words.data_ptr(), words.numel(), chunk_offsets.data_ptr(), n_chunks,
            first_code.data_ptr(), count.data_ptr(), sym_offset.data_ptr(),
            sym_sorted.data_ptr(), n_sym, max_len, chunk_size, out.data_ptr(), stream(dev),
        )
        raise_on(rc, "huffman_decode_chunks")
        count_launch(launches, "decode_chunks")
    return out
