"""Adapter-dispatched entry point for the huffman_decode kernel (counterpart
of ``repro.kernels.huffman_decode.ops``): ``torch`` runs the plain version,
``cuda`` the CUDA kernel."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("huffman_decode_chunks", adapters.TORCH)(ref.decode_chunks)
adapters.register("huffman_decode_chunks", adapters.CUDA)(kernel.decode_chunks)


def decode_chunks(
    words: torch.Tensor,
    chunk_offsets: torch.Tensor,
    first_code: torch.Tensor,
    count: torch.Tensor,
    sym_offset: torch.Tensor,
    sym_sorted: torch.Tensor,
    chunk_size: int,
    max_len: int,
    adapter: str | None = None,
) -> torch.Tensor:
    """Chunk-parallel canonical-Huffman decode: int32 ``[n_chunks, chunk_size]``."""
    return adapters.dispatch("huffman_decode_chunks", adapter)(
        words, chunk_offsets, first_code, count, sym_offset, sym_sorted, chunk_size, max_len,
    )
