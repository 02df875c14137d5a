"""Huffman-X — HPDR §IV-B (Algorithm 2), in PyTorch (counterpart of
``repro.core.huffman``).

Pipeline: histogram → two-phase codebook → encode → compact serialization.

  * ``histogram``  the ``histogram`` kernel (shared-memory atomics on the
                   card; a plain ``index_add_`` on the CPU).
  * codebook       two-phase treeless generation on the host, in numpy: code
                   *lengths* from a heap merge, then canonical codes.  It is
                   metadata scale (≤ 2^16 entries) and a copy of the
                   reference's, heap tie-breaks included, so both packages
                   build the same codebook from the same histogram.
  * encode         the ``huffman_encode`` kernel: per-key (code, length)
                   gather from the canonical codebook.
  * serialize      exclusive scan of the lengths + disjoint-bit word packing
                   (the ``huffman_encode`` pack kernel on the card; its plain
                   version :func:`repro_torch.kernels.huffman_encode.ref.pack_stream`
                   on the CPU).

Decoding is self-synchronising per fixed-size symbol chunk (the bit offset
of every chunk is stored), so the ``huffman_decode`` kernel decodes all
chunks in parallel, sequentially inside each.  Canonical codes mean the
codebook serialises as the lengths array only.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass

import numpy as np
import torch

from . import adapters
from . import bitstream as bs

MAX_CODE_LEN = 32
DEFAULT_CHUNK = 4096
# The packed stream's bit offsets are int32 in the format (``chunk_offsets``
# and the reference's scan), so a longer stream cannot be written.
MAX_TOTAL_BITS = (1 << 31) - 1


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Frequency histogram over the whole domain (the DEM global stage):
    ``(num_bins,)`` int32, where ``keys`` lie (the ``histogram`` kernel on a
    CUDA tensor, its plain version on a CPU tensor).

    As the reference's ``jnp.bincount(..., length=num_bins)``: a negative
    key counts in bin 0, a key past the last bin is dropped.
    """
    from ..kernels.histogram import ops as histogram_ops  # lazy: layer order

    keys = keys.reshape(-1).to(torch.int32).clamp_min(0)
    return histogram_ops.histogram(keys, num_bins, adapter=adapters.for_tensor(None, keys))


def histogram_op(keys: torch.Tensor, num_bins: int, adapter: str | None = None) -> torch.Tensor:
    """Adapter-dispatched histogram of int32 keys: ``(num_bins,)`` int32.

    ``adapter`` binds the backend (``torch``: the plain version; ``cuda``:
    the kernel); ``None`` is the inline path, :func:`histogram`.
    """
    if adapter is None:
        return histogram(keys, num_bins)
    from ..kernels.histogram import ops as histogram_ops  # lazy: layer order

    return histogram_ops.histogram(keys.reshape(-1), num_bins, adapter=adapter)


# ---------------------------------------------------------------------------
# two-phase codebook generation (host / metadata scale)
# ---------------------------------------------------------------------------


def _huffman_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Phase 1: code lengths from frequencies, by the reference's heap merge
    and its tie-breaks (equal weights pop leaves by index, then internal
    nodes by creation), run as two queues: the leaves sorted by (weight,
    index), and the internal nodes in creation order, whose weights never
    decrease.  A tie between the fronts pops the leaf, as the heap does (a
    leaf's tie-break is its index, below every internal node's id)."""
    freq = np.asarray(freq, dtype=np.int64)
    n = freq.shape[0]
    lengths = np.zeros(n, dtype=np.int32)
    nz = np.nonzero(freq)[0]
    if nz.size == 0:
        return lengths
    if nz.size == 1:
        lengths[nz[0]] = 1
        return lengths
    leaves = nz[np.argsort(freq[nz], kind="stable")]
    leaf_w = freq[leaves].tolist()
    m = len(leaf_w)
    leaf_parent = [0] * m
    node_w: list[int] = []       # internal nodes, in creation order
    node_parent = [0] * (m - 1)
    a = b = 0                    # the two queues' fronts
    for k in range(m - 1):
        w = 0
        for _ in range(2):
            if a < m and (b == k or leaf_w[a] <= node_w[b]):
                w += leaf_w[a]
                leaf_parent[a] = k
                a += 1
            else:
                w += node_w[b]
                node_parent[b] = k
                b += 1
        node_w.append(w)
    # a parent is made after its children: walk down from the root (m − 2)
    depth = [0] * (m - 1)
    for k in range(m - 3, -1, -1):
        depth[k] = depth[node_parent[k]] + 1
    lengths[leaves] = np.asarray(depth, dtype=np.int32)[leaf_parent] + 1
    return lengths


def _limit_lengths(lengths: np.ndarray, freq: np.ndarray, max_len: int) -> np.ndarray:
    """Clamp code lengths to ``max_len`` and repair the Kraft sum (the
    reference's post-pass: clamp, lengthen the least frequent symbols while
    Kraft > 1, then shorten the most frequent while the slack allows)."""
    lengths = lengths.copy()
    used = lengths > 0
    if not used.any():
        return lengths
    lengths[used & (lengths > max_len)] = max_len

    def kraft() -> float:
        return float(np.sum(np.exp2(-lengths[used].astype(np.float64))))

    if kraft() > 1.0:
        order = np.argsort(freq)  # least frequent first
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
            if used[s] and lengths[s] > 1:
                slack = 1.0 - kraft()
                if slack >= np.exp2(-float(lengths[s])):
                    lengths[s] -= 1
                    improved = True
    return lengths


@dataclass(frozen=True)
class Codebook:
    """Canonical Huffman codebook (decode tables derivable from lengths)."""

    lengths: np.ndarray          # int32[K], 0 = unused key
    codes: np.ndarray            # uint32[K]
    first_code: np.ndarray       # uint32[max_len+1]
    count: np.ndarray            # int32[max_len+1]
    sym_offset: np.ndarray       # int32[max_len+1] index into sym_sorted
    sym_sorted: np.ndarray       # int32[num_used]
    max_len: int

    @property
    def num_keys(self) -> int:
        return int(self.lengths.shape[0])


def canonical_codebook_from_lengths(lengths: np.ndarray) -> Codebook:
    """Phase 2: canonical codes from lengths, plus the decode tables."""
    lengths = np.asarray(lengths, dtype=np.int32)
    K = lengths.shape[0]
    used = np.nonzero(lengths)[0]
    max_len = int(lengths.max()) if used.size else 0
    count = np.bincount(lengths[used], minlength=max_len + 1).astype(np.int32)
    first_code = np.zeros(max_len + 1, dtype=np.uint32)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + int(count[l - 1])) << 1
        first_code[l] = code
    # symbols sorted by (length, symbol): canonical order
    sym_sorted = used[np.lexsort((used, lengths[used]))].astype(np.int32)
    sym_offset = np.zeros(max_len + 1, dtype=np.int32)
    sym_offset[1:] = np.cumsum(count[:-1])  # count[0] is 0: no code has length 0
    # the i-th symbol of length l (canonical order) gets first_code[l] + i
    sorted_lens = lengths[sym_sorted]
    rank = np.arange(sym_sorted.size, dtype=np.int64) - sym_offset[sorted_lens]
    codes = np.zeros(K, dtype=np.uint32)
    codes[sym_sorted] = (first_code[sorted_lens].astype(np.int64) + rank).astype(np.uint32)
    return Codebook(
        lengths=lengths,
        codes=codes,
        first_code=first_code,
        count=count,
        sym_offset=sym_offset,
        sym_sorted=sym_sorted,
        max_len=max_len,
    )


def build_codebook(freq: np.ndarray, max_len: int = MAX_CODE_LEN) -> Codebook:
    """Two-phase codebook generation (paper Alg. 2 line 5)."""
    freq = np.asarray(freq)
    lengths = _huffman_code_lengths(freq)
    if lengths.max(initial=0) > max_len:
        lengths = _limit_lengths(lengths, freq, max_len)
    return canonical_codebook_from_lengths(lengths)


def _too_long(total_bits: int) -> str:
    return (f"the Huffman stream would hold {total_bits} bits; the format's int32 "
            f"bit offsets allow at most {MAX_TOTAL_BITS} (split the input)")


def total_bits_of(freq: np.ndarray, lengths: np.ndarray) -> int:
    """Exact packed size ``freq · lengths``; raises past the format's limit."""
    total = int(np.sum(np.asarray(freq, np.int64) * np.asarray(lengths, np.int64)))
    if total > MAX_TOTAL_BITS:
        raise ValueError(_too_long(total))
    return total


# ---------------------------------------------------------------------------
# encode (gather) + serialize (scan + OR)
# ---------------------------------------------------------------------------


@dataclass
class Encoded:
    """A Huffman-X bitstream with self-synchronising chunk offsets."""

    words: torch.Tensor          # int32[W], the uint32 words' bits
    total_bits: int
    n_symbols: int
    chunk_size: int
    chunk_offsets: torch.Tensor  # int32[n_chunks] bit offsets
    length_table: np.ndarray     # int32[K] — serialised codebook
    num_keys: int

    def nbytes(self) -> int:
        return int(self.words.nbytes + self.chunk_offsets.nbytes + self.length_table.nbytes)


def codebook_tables(book: Codebook, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The encode tables on ``device``: codes (int32 bits of uint32), lengths."""
    codes_t = torch.from_numpy(book.codes.view(np.int32).copy()).to(device)
    lens_t = torch.from_numpy(np.asarray(book.lengths, np.int32).copy()).to(device)
    return codes_t, lens_t


def symbol_lengths_total(keys: torch.Tensor, lengths_t: torch.Tensor) -> int:
    """Total bit count of ``keys`` under the code lengths ``lengths_t`` (one
    scalar crosses to the host: it sizes the exact output buffer).

    Indices as the reference's gather takes them: a negative key counts
    from the end, then every key is clamped into the table.  The sum is
    exact (the reference's int32 sum wraps past 2^31 - 1, a stream the
    format cannot hold).
    """
    k = keys.reshape(-1).to(torch.int64)
    n = lengths_t.shape[0]
    k = torch.where(k < 0, k + n, k).clamp_(0, n - 1)
    return int(lengths_t.to(torch.int64)[k].sum())


def encode(
    keys: torch.Tensor, book: Codebook, chunk_size: int = DEFAULT_CHUNK,
    adapter: str | None = None,
) -> Encoded:
    """Encode ``keys`` (int in [0, K)) into a compact bitstream; ``adapter``
    binds the lookup (``None``: where the keys lie)."""
    from ..kernels.huffman_encode import ops as encode_ops  # lazy: layer order

    keys = keys.reshape(-1).to(torch.int32)
    adapter = adapters.for_tensor(adapter, keys)
    codes_t, lens_t = codebook_tables(book, keys.device)
    code, length = encode_ops.encode_lookup(keys, codes_t, lens_t, adapter=adapter)
    total_bits = int(length.to(torch.int64).sum())  # one scalar crosses to the host
    if total_bits > MAX_TOTAL_BITS:
        raise ValueError(_too_long(total_bits))
    num_words = max(1, bs.words_needed(total_bits))
    words, chunk_offsets = adapters.dispatch("huffman_pack_stream", adapter)(
        code, length, num_words, chunk_size)
    return Encoded(
        words=words,
        total_bits=total_bits,
        n_symbols=int(keys.shape[0]),
        chunk_size=chunk_size,
        chunk_offsets=chunk_offsets,
        length_table=np.asarray(book.lengths, np.int32),
        num_keys=book.num_keys,
    )


# ---------------------------------------------------------------------------
# decode (parallel over chunks, sequential within)
# ---------------------------------------------------------------------------


@dataclass
class DecodeTables:
    """Canonical decode tables of one length table, staged on a device.

    Rebuildable from ``length_table`` alone, but derivation and staging are
    per-stream work worth caching: decode plans keep these in their
    workspace, keyed by the length table's digest.
    """

    first_code: torch.Tensor   # int32[max_len+1], the uint32 values' bits
    count: torch.Tensor        # int32[max_len+1]
    sym_offset: torch.Tensor   # int32[max_len+1]
    sym_sorted: torch.Tensor   # int32[num_used]
    max_len: int

    @property
    def nbytes(self) -> int:
        return int(
            self.first_code.nbytes + self.count.nbytes
            + self.sym_offset.nbytes + self.sym_sorted.nbytes
        )


def decode_tables(length_table: np.ndarray, device="cpu") -> DecodeTables:
    """Build (and stage on ``device``) the decode tables for one length table."""
    book = canonical_codebook_from_lengths(np.asarray(length_table, np.int32))

    def stage(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(device)

    return DecodeTables(
        first_code=stage(book.first_code),
        count=stage(book.count),
        sym_offset=stage(book.sym_offset),
        sym_sorted=stage(book.sym_sorted),
        max_len=int(book.max_len),
    )


def padded_tables(tables: DecodeTables) -> tuple[torch.Tensor, ...]:
    """The tables as the decode kernel takes them: at least two entries per
    length table (an empty alphabet has ``max_len`` 0) and at least one
    symbol, as the reference pads them."""
    fc, ct, so, ss = tables.first_code, tables.count, tables.sym_offset, tables.sym_sorted
    if tables.max_len == 0:
        fc, ct, so = (torch.cat([a, a.new_zeros(1)]) for a in (fc, ct, so))
    if ss.numel() == 0:
        ss = ss.new_zeros(1)
    return fc, ct, so, ss


def decode(
    enc: Encoded, tables: DecodeTables | None = None, adapter: str | None = None
) -> torch.Tensor:
    """Decode a Huffman-X bitstream back to int32 keys, on the words' device.

    ``tables`` skips the per-call codebook derivation (pass the plan-cached
    :class:`DecodeTables`); ``adapter`` routes the chunk scan (``torch`` or
    ``cuda``; ``None``: where the words lie).
    """
    from ..kernels.huffman_decode import ops as decode_ops  # lazy: layer order

    if tables is None:
        tables = decode_tables(enc.length_table, enc.words.device)
    fc, ct, so, ss = padded_tables(tables)
    syms = decode_ops.decode_chunks(
        enc.words, enc.chunk_offsets, fc, ct, so, ss,
        enc.chunk_size, int(fc.shape[0]) - 1, adapter=adapters.for_tensor(adapter, enc.words),
    )
    return syms.reshape(-1)[: enc.n_symbols]


_MAX_DECODE_TABLES = 8  # per-plan cap on cached decode-table variants


def plan_decode_tables(plan, length_table: np.ndarray) -> DecodeTables:
    """Decode tables for ``length_table``, cached in the plan workspace.

    Keyed by the table's digest, so streams written with the same codebook
    reuse one derived and device-staged table set; a FIFO of
    :data:`_MAX_DECODE_TABLES` per plan.
    """
    lt = np.ascontiguousarray(np.asarray(length_table, np.int32))
    key = "decode_tables:" + hashlib.sha1(lt.tobytes()).hexdigest()
    with plan.lock:
        tables = plan.workspace.get(key)
    if tables is not None:
        return tables
    tables = decode_tables(lt, plan.device)
    if plan.device.type == "cuda":  # other threads' streams read the cached tables
        torch.cuda.current_stream(plan.device).synchronize()
    with plan.lock:
        tables = plan.workspace.setdefault(key, tables)
        cached = [k for k in plan.workspace
                  if isinstance(k, str) and k.startswith("decode_tables:")]
        for stale in cached[:-_MAX_DECODE_TABLES]:
            del plan.workspace[stale]
    return tables


# ---------------------------------------------------------------------------
# end-to-end compress/decompress of integer keys (paper Alg. 2)
# ---------------------------------------------------------------------------


def compress(
    keys: torch.Tensor, num_keys: int, chunk_size: int = DEFAULT_CHUNK,
    adapter: str | None = None,
) -> Encoded:
    freq = histogram_op(keys, num_keys, adapter=adapter).cpu().numpy()
    book = build_codebook(freq)
    return encode(keys, book, chunk_size=chunk_size, adapter=adapter)


def decompress(enc: Encoded, adapter: str | None = None) -> torch.Tensor:
    return decode(enc, adapter=adapter)
