"""Plain canonical Huffman coding, the yardstick of the entropy tail.

A frozen, self-contained statement of the stream that MGARD containers hold:
a histogram of the keys, code lengths from a heap merge (equal weights pop
leaves by index, merged nodes by creation), lengths clamped to 32 bits with
the Kraft sum repaired, canonical codes by (length, symbol), and the codes
packed MSB-first into 32-bit words at the exclusive prefix sum of their
lengths, with the bit offset of every ``chunk_size``-th symbol kept so each
chunk decodes on its own.  Plain ``torch`` and numpy; it imports nothing of
the program.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

MAX_CODE_LEN = 32
MASK32 = 0xFFFFFFFF


def histogram(keys: torch.Tensor, num_bins: int) -> np.ndarray:
    """``(num_bins,)`` int32 counts of int keys in ``[0, num_bins)`` (int32, the
    format's counter width: ties in the length repair sort as int32 values)."""
    counts = torch.bincount(keys.reshape(-1).to(torch.int64), minlength=num_bins)[:num_bins]
    return counts.to(torch.int32).cpu().numpy()


def code_lengths(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.int64)
    n = freq.shape[0]
    lengths = np.zeros(n, dtype=np.int32)
    nz = np.nonzero(freq)[0]
    if nz.size == 0:
        return lengths
    if nz.size == 1:
        lengths[nz[0]] = 1
        return lengths
    heap = [(int(freq[i]), int(i), int(i)) for i in nz]
    heapq.heapify(heap)
    parent = [-1] * (n + nz.size)
    next_id = n
    while len(heap) > 1:
        w1, _, a = heapq.heappop(heap)
        w2, _, b = heapq.heappop(heap)
        parent[a] = parent[b] = next_id
        heapq.heappush(heap, (w1 + w2, next_id, next_id))
        next_id += 1
    depth = [0] * next_id
    for node in range(next_id - 2, -1, -1):
        if parent[node] >= 0:
            depth[node] = depth[parent[node]] + 1
    lengths[nz] = np.asarray(depth, dtype=np.int32)[nz]
    return lengths


def limit_lengths(lengths: np.ndarray, freq: np.ndarray, max_len: int) -> np.ndarray:
    lengths = lengths.copy()
    used = lengths > 0
    lengths[used & (lengths > max_len)] = max_len

    def kraft() -> float:
        return float(np.sum(np.exp2(-lengths[used].astype(np.float64))))

    if kraft() > 1.0:
        order = np.argsort(freq)
        while kraft() > 1.0:
            changed = False
            for s in order:
                if used[s] and lengths[s] < max_len:
                    lengths[s] += 1
                    changed = True
                    if kraft() <= 1.0:
                        break
            if not changed:
                raise ValueError("cannot satisfy Kraft inequality")
    order = np.argsort(-freq)
    improved = True
    while improved:
        improved = False
        for s in order:
            if used[s] and lengths[s] > 1 and 1.0 - kraft() >= np.exp2(-float(lengths[s])):
                lengths[s] -= 1
                improved = True
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """uint32 canonical code of each symbol (0 where unused)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    used = np.nonzero(lengths)[0]
    max_len = int(lengths.max()) if used.size else 0
    count = np.bincount(lengths[used], minlength=max_len + 1)
    first = np.zeros(max_len + 1, dtype=np.int64)
    code = 0
    for length in range(1, max_len + 1):
        code = (code + int(count[length - 1])) << 1
        first[length] = code
    order = used[np.lexsort((used, lengths[used]))]
    offset = np.zeros(max_len + 1, dtype=np.int64)
    offset[1:] = np.cumsum(count[:-1])
    sorted_lens = lengths[order]
    rank = np.arange(order.size, dtype=np.int64) - offset[sorted_lens]
    codes = np.zeros(lengths.shape[0], dtype=np.uint32)
    codes[order] = ((first[sorted_lens] + rank) & MASK32).astype(np.uint32)
    return codes


def codebook(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(lengths int32, codes uint32)`` of the canonical code for ``freq``."""
    lengths = code_lengths(freq)
    if lengths.max(initial=0) > MAX_CODE_LEN:
        lengths = limit_lengths(lengths, freq, MAX_CODE_LEN)
    return lengths, canonical_codes(lengths)


def pack(keys: torch.Tensor, lengths: np.ndarray, codes: np.ndarray, chunk_size: int):
    """``(words uint32, chunk_offsets int32, total_bits)``: the packed stream."""
    device = keys.device
    k = keys.reshape(-1).to(torch.int64)
    lens = torch.from_numpy(lengths.astype(np.int64)).to(device)[k]
    code = torch.from_numpy(codes.astype(np.int64)).to(device)[k]
    offsets = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    n_words = max(1, -(-total // 32))
    word = offsets >> 5
    bit = offsets & 31
    room = 32 - bit - lens  # >= 0: the code ends inside its first word
    fits = room >= 0
    hi = torch.where(fits, (code << room.clamp(min=0)) & MASK32, code >> (-room).clamp(min=0))
    lo = torch.where(fits, torch.zeros_like(code), (code << (32 + room).clamp(min=0)) & MASK32)
    hi = torch.where(lens > 0, hi, torch.zeros_like(hi))
    lo = torch.where(lens > 0, lo, torch.zeros_like(lo))
    words = torch.zeros(n_words, dtype=torch.int64, device=device)
    words.index_add_(0, word, hi)  # the codes own disjoint bits: a sum is an OR
    words.index_add_(0, (word + 1).clamp(max=n_words - 1), lo)
    out = words.cpu().numpy().astype(np.uint32)
    return out, offsets[::chunk_size].to(torch.int32).cpu().numpy(), total
