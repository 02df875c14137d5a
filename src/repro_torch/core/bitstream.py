"""Bit packing on 32-bit words (counterpart of ``repro.core.bitstream``).

Streams are MSB-first within 32-bit words.  PyTorch's ``uint32`` has no
shifts, add, sum or comparisons, so words travel as ``int32`` tensors holding
the same bits; arithmetic on them runs in ``int64`` with explicit masks
(every shift of a masked value is logical) and is narrowed back with
two's-complement wrap.  ``uint32`` appears only at the numpy/container
boundary.

Two packings:

  * fixed width (ZFP): :func:`bits_to_words` / :func:`words_to_bits`;
  * variable length (Huffman): offsets are an exclusive scan of the code
    lengths, and every code lands in two consecutive words with **disjoint
    bit ownership**, so summing the contributions of each word is exactly a
    bitwise OR (no carries) — :func:`pack_bits` is two ``index_add_`` calls.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF


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


def u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of 32-bit words (any integer dtype) as int64."""
    return x.to(torch.int64) & _MASK32


def to_word(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value → the int32 with its bits."""
    return (x & _MASK32).to(torch.int32)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in int64."""
    inc = torch.cumsum(x.to(torch.int64), dim=-1)
    return inc - x.to(torch.int64)


def _safe_shl(x: torch.Tensor, n: torch.Tensor | int) -> torch.Tensor:
    """``(x << n) mod 2^32`` on unsigned int64 values; 0 where ``n >= 32``."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    out = (x << n.clamp(max=WORD_BITS - 1)) & _MASK32
    return torch.where(n >= WORD_BITS, torch.zeros_like(out), out)


def _safe_shr(x: torch.Tensor, n: torch.Tensor | int) -> torch.Tensor:
    """Logical ``x >> n`` on unsigned int64 values; 0 where ``n >= 32``."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    out = x >> n.clamp(max=WORD_BITS - 1)
    return torch.where(n >= WORD_BITS, torch.zeros_like(out), out)


def pack_bits(
    codes: torch.Tensor, lengths: torch.Tensor, num_words: int,
    offsets: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pack N variable-length codes (≤ 32 bits each) into ``num_words`` int32 words.

    ``codes[i]`` holds the code right-aligned (its low ``lengths[i]`` bits,
    any integer dtype; int32 carries uint32 bits); bit position is MSB-first.
    ``num_words`` must be ≥ ``ceil(total_bits / 32)``.  ``offsets`` (the
    exclusive scan of ``lengths``) is computed when not given.
    """
    codes = u32(codes)
    lengths = lengths.to(torch.int64)
    if offsets is None:
        offsets = exclusive_cumsum(lengths)
    w = offsets // WORD_BITS
    b = offsets % WORD_BITS

    # mask codes to their length so stray high bits can't corrupt neighbours
    mask = torch.where(
        lengths >= WORD_BITS, torch.full_like(lengths, _MASK32),
        _safe_shl(torch.ones_like(lengths), lengths) - 1,
    )
    codes = codes & mask

    shift_hi = WORD_BITS - b - lengths  # >= 0: the code fits in word w
    fits = shift_hi >= 0
    hi = torch.where(fits, _safe_shl(codes, shift_hi.clamp(min=0)),
                     _safe_shr(codes, (-shift_hi).clamp(min=0)))
    lo = torch.where(fits, torch.zeros_like(codes),
                     _safe_shl(codes, (WORD_BITS + shift_hi).clamp(min=0)))
    valid = lengths > 0
    hi = torch.where(valid, hi, torch.zeros_like(hi))
    lo = torch.where(valid, lo, torch.zeros_like(lo))

    words = torch.zeros(num_words, dtype=torch.int64, device=codes.device)
    words.index_add_(0, w, hi)
    # the reference's clamp, kept exactly: a code that spills always has
    # word w + 1 inside the stream, so the clamp never moves a set bit
    words.index_add_(0, (w + 1).clamp(max=num_words - 1), lo)
    return to_word(words)


def read_window(words: torch.Tensor, bit_offset: torch.Tensor) -> torch.Tensor:
    """The 32-bit MSB-aligned windows starting at ``bit_offset`` (int64,
    unsigned values); reads past either end of ``words`` give zero bits."""
    n = words.shape[0]
    bit_offset = bit_offset.to(torch.int64)
    w = bit_offset // WORD_BITS
    b = bit_offset % WORD_BITS
    zero = torch.zeros_like(bit_offset)
    if n == 0:
        return zero
    w0 = torch.where((w >= 0) & (w < n), u32(words[w.clamp(0, n - 1)]), zero)
    w1 = torch.where((w >= -1) & (w + 1 < n), u32(words[(w + 1).clamp(0, n - 1)]), zero)
    tail = torch.where(b == 0, zero, _safe_shr(w1, WORD_BITS - b))
    return _safe_shl(w0, b) | tail


def unpack_bits(
    words: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Extract N codes given their bit offsets and lengths (inverse of
    :func:`pack_bits`); returns int32 words holding the codes."""
    lengths = lengths.to(torch.int64)
    vals = _safe_shr(read_window(words, offsets), WORD_BITS - lengths)
    return to_word(torch.where(lengths > 0, vals, torch.zeros_like(vals)))
