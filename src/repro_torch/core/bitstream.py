"""Fixed-width bit packing on 32-bit words (counterpart of ``repro.core.bitstream``).

Streams are MSB-first within 32-bit words.  PyTorch's ``uint32`` has no
shifts, add, sum or comparisons, so words travel as ``int32`` tensors holding
the same bits; sums that build a word run in ``int64`` and are narrowed back
with two's-complement wrap.  ``uint32`` appears only at the numpy/container
boundary.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def _desc_shifts(device: torch.device) -> torch.Tensor:
    """``[31, 30, ..., 0]``: the shift of each bit of a word, MSB first."""
    return torch.arange(WORD_BITS - 1, -1, -1, dtype=torch.int64, device=device)


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack a ``(..., 32)`` tensor of 0/1 into ``(...,)`` int32 words, MSB first."""
    if bits.shape[-1] != WORD_BITS:
        raise ValueError(f"last dim must be {WORD_BITS}, got {bits.shape[-1]}")
    words = (bits.to(torch.int64) << _desc_shifts(bits.device)).sum(dim=-1)
    return words.to(torch.int32)


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bits_to_words`: int32 ``(...,)`` → 0/1 ``(..., 32)`` int32."""
    shifted = words.to(torch.int64)[..., None] >> _desc_shifts(words.device)
    return (shifted & 1).to(torch.int32)


def words_needed(total_bits: int) -> int:
    return (int(total_bits) + WORD_BITS - 1) // WORD_BITS
