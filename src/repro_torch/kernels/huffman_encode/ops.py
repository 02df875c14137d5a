"""Adapter-dispatched entry point for the huffman_encode kernel (counterpart
of ``repro.kernels.huffman_encode.ops``): ``torch`` runs the plain version,
``cuda`` the CUDA kernels.  ``pack_stream`` has a kernel only in the port
(the reference leaves it to XLA)."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("huffman_encode_lookup", adapters.TORCH)(ref.encode_lookup)
adapters.register("huffman_encode_lookup", adapters.CUDA)(kernel.encode_lookup)
adapters.register("huffman_pack_stream", adapters.TORCH)(ref.pack_stream)
adapters.register("huffman_pack_stream", adapters.CUDA)(kernel.pack_stream)


def encode_lookup(
    keys: torch.Tensor, codes_table: torch.Tensor, lens_table: torch.Tensor,
    adapter: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    return adapters.dispatch("huffman_encode_lookup", adapter)(keys, codes_table, lens_table)


def pack_stream(
    codes: torch.Tensor, lens: torch.Tensor, num_words: int, chunk_size: int,
    adapter: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device bit-packing of (code, length) pairs into the word stream, as
    the reference returns it: ``(words[num_words], chunk_offsets, total_bits)``
    (int32 tensors; the words hold the uint32 bits)."""
    words, chunk_offsets = adapters.dispatch("huffman_pack_stream", adapter)(
        codes, lens, num_words, chunk_size)
    return words, chunk_offsets, lens.to(torch.int64).sum().to(torch.int32)
