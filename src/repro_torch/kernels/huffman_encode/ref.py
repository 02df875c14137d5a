"""Plain PyTorch versions of the huffman_encode ops (counterpart of
``repro.kernels.huffman_encode.ref``).

:func:`encode_lookup` and :func:`pack_stream`, the serialization that
follows it, are the CUDA kernels' oracles and the ``torch`` backend's
implementations (the reference has a Pallas kernel for the lookup only and
leaves the packing to XLA).
"""

from __future__ import annotations

import torch

from ...core import bitstream as bs


def encode_lookup(
    keys: torch.Tensor, codes_table: torch.Tensor, lens_table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key ``(code, length)`` from the canonical codebook: int32 tensors
    (codes hold the uint32 bits).  Keys outside ``[0, K)`` are clamped into
    it, as XLA's gather clamps."""
    k = keys.reshape(-1).to(torch.int64).clamp(0, codes_table.shape[0] - 1)
    return codes_table.to(torch.int32)[k], lens_table.to(torch.int32)[k]


def pack_stream(
    codes: torch.Tensor, lens: torch.Tensor, num_words: int, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-sum offsets + disjoint-bit word packing (DEM global stage).

    Returns ``(words[num_words] int32, chunk_offsets int32)``: the packed
    stream (words past the last code are zero) and the bit offset of every
    ``chunk_size``-th symbol.  Bit offsets are computed in int64; the
    caller keeps the total under 2^31 (the format's int32 offsets).
    """
    offsets = bs.exclusive_cumsum(lens)
    words = bs.pack_bits(codes, lens, num_words, offsets=offsets)
    return words, offsets[::chunk_size].to(torch.int32)
