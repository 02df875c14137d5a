"""Plain PyTorch version of the huffman_decode kernel (the CUDA kernel's
oracle and the ``torch`` backend's implementation; counterpart of
``repro.kernels.huffman_decode.ref``).

All chunks advance together, one symbol per step, so the loop runs
``chunk_size`` times over ``(n_chunks,)`` tensors.  A stream of at most
``JUMP_BITS`` bits takes the same scan at every bit position at once and
follows each chunk's cursors by pointer doubling (``log2(chunk_size)``
steps): the same symbols, without the loop's ~25 ops a symbol, which a
small leaf's one chunk would otherwise pay 4096 times.  :func:`decode_lut`
is the plain mirror of the lookup table the CUDA kernel builds in shared
memory; the plain decode itself stays the canonical scan.
"""

from __future__ import annotations

import torch

from ...core import bitstream as bs

_I32_SPAN = 1 << 32
LUT_BITS = 13  # the kernel's table covers the next min(max_len, 13) bits
SYM_BITS = 25  # symbols its entries pack beside a length
JUMP_BITS = 1 << 21  # streams of at most this many bits decode by pointer doubling


def _gather(sym_sorted: torch.Tensor, so: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """``sym_sorted[so + rel]`` with the reference's gather: the index wraps
    as int32, counts from the end when negative, then clamps."""
    n_sym = sym_sorted.shape[0]
    idx = (so + rel + (1 << 31)) % _I32_SPAN - (1 << 31)
    idx = torch.where(idx < 0, idx + n_sym, idx).clamp_(0, n_sym - 1)
    return sym_sorted[idx]


def decode_lut(
    first_code: torch.Tensor, count: torch.Tensor, sym_offset: torch.Tensor,
    sym_sorted: torch.Tensor, max_len: int,
) -> torch.Tensor:
    """The decode kernel's lookup table: int32 ``[2^K]``, ``K = min(max_len,
    13)``, as the kernel packs it.

    Entry ``p`` serves a window whose top ``K`` bits are ``p`` (for
    ``l <= K``, ``window >> (32 - l)`` is ``p >> (K - l)`` whatever the lower
    bits).  Where the canonical scan accepts a length ``l <= K`` with symbol
    ``s``, the entry is ``(s << 6) | l``, or ``l << 6`` (length field 0) when
    ``s`` is negative or has more than 25 bits; where it accepts none, the
    entry is ``(K + 1) << 6``.  A length field of 0 is an escape: the scan
    runs on the whole window from the length in the upper bits.
    """
    k = min(int(max_len), LUT_BITS)
    device = sym_sorted.device
    prefix = torch.arange(1 << k, dtype=torch.int64, device=device)
    lens = torch.arange(1, k + 1, dtype=torch.int64, device=device)
    rel = (prefix[:, None] >> (k - lens)) - bs.u32(first_code[1 : k + 1])
    valid = (rel >= 0) & (rel < count[1 : k + 1].to(torch.int64))
    li = valid.to(torch.uint8).argmax(dim=1)
    rows = torch.arange(1 << k, device=device)
    sym = _gather(sym_sorted, sym_offset[1 : k + 1].to(torch.int64)[li], rel[rows, li])
    sym = sym.to(torch.int64)
    hit = valid.any(dim=1)
    packed = torch.where((sym >= 0) & (sym < (1 << SYM_BITS)), (sym << 6) | (li + 1), (li + 1) << 6)
    return torch.where(hit, packed, (k + 1) << 6).to(torch.int32)


def decode_chunks(
    words: torch.Tensor,          # int32[W] packed stream (uint32 bits)
    chunk_offsets: torch.Tensor,  # int32[n_chunks] bit offset of each chunk
    first_code: torch.Tensor,     # int32[max_len+1] (uint32 bits)
    count: torch.Tensor,          # int32[max_len+1]
    sym_offset: torch.Tensor,     # int32[max_len+1] index into sym_sorted
    sym_sorted: torch.Tensor,     # int32[num_used], num_used >= 1
    chunk_size: int,
    max_len: int,
) -> torch.Tensor:
    """Decode every chunk; returns int32 ``[n_chunks, chunk_size]``.

    Per symbol: the 32-bit window at the cursor (zero bits past the end),
    the shortest length ``l`` whose prefix is a valid code
    (``first_code[l] <= window >> (32-l) < first_code[l] + count[l]``), the
    symbol ``sym_sorted[sym_offset[l] + rel]``, the cursor advanced by
    ``l``.  Where no length is valid (padding past the stream's end) ``l``
    is 1 and the symbol index wraps as int32, counts from the end when
    negative and clamps — the reference's gather — so padding symbols match
    too.
    """
    device = words.device
    n_chunks = chunk_offsets.shape[0]
    out = torch.empty((n_chunks, chunk_size), dtype=torch.int32, device=device)
    if n_chunks == 0:
        return out
    n = words.shape[0]
    # the words as unsigned int64 values, one zero word appended: reads
    # outside the stream index it (read_window's zero bits)
    ww = torch.cat([bs.u32(words), torch.zeros(1, dtype=torch.int64, device=device)])
    if 0 < 32 * n <= JUMP_BITS and max_len >= 1 and bool((chunk_offsets >= 0).all()):
        return _decode_by_jumps(ww, n, chunk_offsets, first_code, count, sym_offset,
                                sym_sorted, chunk_size, max_len)
    lens = torch.arange(1, max_len + 1, dtype=torch.int64, device=device)
    shifts = 32 - lens
    fc = bs.u32(first_code[1 : max_len + 1])
    ct = count[1 : max_len + 1].to(torch.int64)
    so = sym_offset[1 : max_len + 1].to(torch.int64)
    rows = torch.arange(n_chunks, device=device)
    cursor = chunk_offsets.to(torch.int64)
    for i in range(chunk_size):
        w = cursor >> 5
        b = cursor & 31
        w0 = ww[torch.where((w >= 0) & (w < n), w, n)]
        w1 = ww[torch.where((w >= -1) & (w < n - 1), w + 1, n)]
        window = ((w0 << b) | (w1 >> (32 - b))) & 0xFFFFFFFF  # b = 0: w1 >> 32 is 0
        rel = (window[:, None] >> shifts) - fc
        li = ((rel >= 0) & (rel < ct)).to(torch.uint8).argmax(dim=1)  # first valid; none → 0
        out[:, i] = _gather(sym_sorted, so[li], rel[rows, li])
        cursor += li + 1
    return out


def _scan_at(ww: torch.Tensor, n: int, p: torch.Tensor, first_code: torch.Tensor,
             count: torch.Tensor, sym_offset: torch.Tensor, sym_sorted: torch.Tensor,
             max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(symbol, length) one step of :func:`decode_chunks`' loop gives at the
    bit cursors ``p`` (int64, >= 0)."""
    w = p >> 5
    b = p & 31
    w0 = ww[torch.where(w < n, w, n)]
    w1 = ww[torch.where(w < n - 1, w + 1, n)]
    window = ((w0 << b) | (w1 >> (32 - b))) & 0xFFFFFFFF  # b = 0: w1 >> 32 is 0
    fc = bs.u32(first_code[1 : max_len + 1])
    ct = count[1 : max_len + 1].to(torch.int64)
    li = torch.full_like(p, -1)
    for j in range(max_len):  # the first valid length, as the loop's argmax
        rel = (window >> (31 - j)) - fc[j]
        li = torch.where((li < 0) & (rel >= 0) & (rel < ct[j]), j, li)
    li.clamp_(min=0)  # none valid: length 1, as the loop's argmax of zeros
    rel = (window >> (31 - li)) - fc[li]
    so = sym_offset[1 : max_len + 1].to(torch.int64)
    return _gather(sym_sorted, so[li], rel), li + 1


def _decode_by_jumps(ww, n, chunk_offsets, first_code, count, sym_offset, sym_sorted,
                     chunk_size: int, max_len: int) -> torch.Tensor:
    """:func:`decode_chunks` for offsets >= 0: the scan at every bit position
    of the stream, then symbol ``i`` of a chunk read at ``f^i(offset)``,
    ``f(p) = p + length(p)``, with ``f^(2^j)`` built by doubling.  Past the
    stream's ``T = 32 n`` bits the window is zero, so a step there is the
    same constant length."""
    device = ww.device
    tables = (first_code, count, sym_offset, sym_sorted, max_len)
    t = 32 * n
    sym, length = _scan_at(ww, n, torch.arange(t, dtype=torch.int64, device=device), *tables)
    sym_past, len_past = _scan_at(ww, n, torch.full((1,), t, dtype=torch.int64,
                                                    device=device), *tables)
    jump = torch.arange(t, dtype=torch.int64, device=device) + length  # f on [0, t)

    def apply(table, q, steps):
        return torch.where(q < t, table[q.clamp(max=t - 1)], q + steps * len_past)

    k = torch.arange(chunk_size, dtype=torch.int64, device=device)
    pos = chunk_offsets.to(torch.int64)[:, None].expand(-1, chunk_size)
    levels = max(chunk_size - 1, 0).bit_length()
    for j in range(levels):
        pos = torch.where(((k >> j) & 1).bool(), apply(jump, pos, 1 << j), pos)
        if j + 1 < levels:
            jump = apply(jump, jump, 1 << j)
    return torch.where(pos < t, sym[pos.clamp(max=t - 1)], sym_past).to(torch.int32)
