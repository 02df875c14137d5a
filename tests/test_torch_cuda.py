"""The port's CUDA kernels against their plain PyTorch versions, on the card
(and the training side's steps, the ssm, vlm, hybrid and encdec families'
steps and decode among them and the RG-LRU scan, against the CPU and
against themselves, and the placed train step over a world-size-1 NCCL
group against the unplaced one).

Kernels: ``zfp_block`` (encode, decode), ``histogram``, ``huffman_encode``
(``encode_lookup``, ``pack_stream``), ``huffman_decode`` (``decode_chunks``), ``quantize_map``
(``quantize``, ``dequantize``), ``tridiag`` (``solve_mass``) and
``mgard_lerp`` (``lerp_coefficients``).

This file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()`` is
False (the kernels have no CPU mode).  The decode tests reach each branch of
the kernel (codes all inside its lookup table, escapes to the scan, codes of
32 bits, symbols too wide for a table entry, a large alphabet, ragged chunk
sizes); the
solve tests every ``(P, n, Q)`` view (rows, blocks of p's, runs of systems)
and systems too long for a 32-system tile.  Tolerance: none — payload words, emax
and decoded floats (as bit patterns) must be identical.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core import huffman
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ref as hist_ref
from repro_torch.kernels.huffman_decode import kernel as dec_kernel
from repro_torch.kernels.huffman_decode import ref as dec_ref
from repro_torch.kernels.huffman_encode import kernel as enc_kernel
from repro_torch.kernels.huffman_encode import ref as enc_ref
from repro_torch.kernels.mgard_lerp import kernel as lerp_kernel
from repro_torch.kernels.mgard_lerp import ref as lerp_ref
from repro_torch.kernels.quantize_map import kernel as quant_kernel
from repro_torch.kernels.quantize_map import ref as quant_ref
from repro_torch.kernels.tridiag import kernel as tri_kernel
from repro_torch.kernels.tridiag import ref as tri_ref
from repro_torch.kernels.zfp_block import kernel, ref

torch.set_num_threads(2)

RATES = (1, 7, 16, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _blocks(dims: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    bs = 4 ** dims
    tiny = np.finfo(np.float32).tiny
    x = (rng.normal(size=(n, bs)) * np.exp2(rng.integers(-30, 30, size=(n, 1))))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1] = rng.uniform(-1, 1, bs).astype(np.float32) * tiny * 0.5
    x[2] = rng.normal(size=bs).astype(np.float32) * np.float32(2.0 ** -100)
    x[3] = rng.uniform(-1, 1, bs).astype(np.float32) * np.float32(3.4e38)
    x[4, 0] = math.inf
    x[5, 1] = math.nan
    x[6, ::2] = tiny * 0.25
    x[7] = -math.inf
    return torch.from_numpy(x)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_cuda_kernel_matches_plain_version(cuda_device, dims, rate):
    x = _blocks(dims, 2000 // dims + 3, seed=dims + rate)
    before = dict(kernel.launches)
    p, e = kernel.compress_blocks(x.to(cuda_device), rate, dims)
    d = kernel.decompress_blocks(p, e, rate, dims)
    torch.cuda.synchronize()
    assert kernel.launches["compress_blocks"] == before["compress_blocks"] + 1
    assert kernel.launches["decompress_blocks"] == before["decompress_blocks"] + 1
    rp, re_ = ref.compress_blocks(x, rate, dims)
    rd = ref.decompress_blocks(rp, re_, rate, dims)
    assert torch.equal(p.cpu(), rp) and torch.equal(e.cpu(), re_)
    assert torch.equal(d.cpu().view(torch.int32), rd.view(torch.int32))


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros((5, 64), device=cuda_device)
    with pytest.raises(TypeError):
        kernel.compress_blocks(x.double(), 16, 3)
    with pytest.raises(ValueError, match="shape"):
        kernel.compress_blocks(x, 16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.compress_blocks(torch.zeros((64, 5), device=cuda_device).t(), 16, 3)
    with pytest.raises(ValueError, match="rate"):
        kernel.compress_blocks(x, 33, 3)


# padded fields: the odd shapes, one block along the last axis, a last-axis
# block count that is no multiple of a 128-block tile, a single block
FIELD_SHAPES = [(1004,), (36, 48), (36, 48, 68), (8, 8, 8, 12), (12, 8, 4), (8, 4 * 261),
                (8, 8, 4 * 133), (4, 4, 4), (4, 4, 4, 4 * 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", FIELD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_field_kernel_matches_plain_version(cuda_device, shape, rate):
    dims = len(shape)
    rng = np.random.default_rng(len(shape) * rate)
    x = (rng.normal(size=shape) * np.exp2(rng.integers(-30, 30, size=shape))).astype(np.float32)
    flat = x.reshape(-1)
    flat[: 4 ** dims] = _blocks(dims, 8, seed=rate).reshape(-1)[: 4 ** dims]  # a special value run
    x = torch.from_numpy(x)
    before = dict(kernel.launches)
    p, e = kernel.compress_field(x.to(cuda_device), rate, dims)
    d = kernel.decompress_field(p, e, rate, dims, shape)
    torch.cuda.synchronize()
    assert kernel.launches["compress_blocks"] == before["compress_blocks"] + 1
    assert kernel.launches["decompress_blocks"] == before["decompress_blocks"] + 1
    rp, re_ = ref.compress_field(x, rate, dims)
    rd = ref.decompress_field(rp, re_, rate, dims, shape)
    assert torch.equal(p.cpu(), rp) and torch.equal(e.cpu(), re_)
    assert torch.equal(d.cpu().view(torch.int32), rd.view(torch.int32))


@pytest.mark.gpu
def test_cuda_field_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros((8, 8, 12), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernel.compress_field(torch.zeros((8, 8, 10), device=cuda_device), 16, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.compress_field(x.transpose(0, 1), 16, 3)
    misaligned = torch.zeros(8 * 8 * 12 + 1, device=cuda_device)[1:].view(8, 8, 12)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.compress_field(misaligned, 16, 3)
    p, e = kernel.compress_field(x, 16, 3)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.decompress_field(p, torch.zeros(e.numel() + 1, dtype=torch.int32,
                                               device=cuda_device)[1:], 16, 3, (8, 8, 12))
    with pytest.raises(ValueError, match="perm"):
        kernel.compress_field(x, 16, 3, perm=torch.arange(64, dtype=torch.int32,
                                                          device=cuda_device))


@pytest.mark.gpu
def test_cuda_api_matches_torch_backend(cuda_device):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(33, 47, 65)).astype(np.float32)
    c = api.compress(torch.from_numpy(x).to(cuda_device), "zfp", rate=16)
    assert c.to_bytes() == api.compress(x, "zfp", rate=16, backend="torch").to_bytes()
    out = api.decompress(c)
    assert out.device.type == "cuda"
    want = api.decompress(c, backend="torch")
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# Huffman tail: histogram, encode_lookup, decode_chunks
# ---------------------------------------------------------------------------

ALPHABETS = (1, 2, 256, 4096, 20000, 65536)


def _skewed_keys(num_bins: int, n: int, seed: int) -> np.ndarray:
    """Zipf-skewed keys in [0, num_bins), every key present when n allows."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) - 1) % num_bins
    keys[: min(n, num_bins)] = np.arange(min(n, num_bins))
    return rng.permutation(keys).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", ALPHABETS)
@pytest.mark.parametrize("n", [1, 1001, 100_003])
def test_histogram_kernel_matches_plain_version(cuda_device, num_bins, n):
    keys = torch.from_numpy(_skewed_keys(num_bins, n, seed=n + num_bins))
    keys[::97] = -3          # out of range on both sides: counted nowhere
    keys[1::101] = num_bins
    before = hist_kernel.launches["histogram"]
    for k in (keys, keys[1:]):  # aligned and misaligned (a peeled head)
        got = hist_kernel.histogram(k.to(cuda_device), num_bins)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hist_ref.histogram(k, num_bins))
    assert hist_kernel.launches["histogram"] == before + (2 if n > 1 else 1)


def _float_bytes(n: int, seed: int) -> np.ndarray:
    """The byte view of N(0, 0.02^2) float32 values as int32 keys (256 bins):
    the exponent byte takes a handful of values."""
    w = (np.random.default_rng(seed).normal(size=n // 4) * 0.02).astype(np.float32)
    return w.view(np.uint8).astype(np.int32)


def _past_window(n: int, seed: int) -> np.ndarray:
    """Keys of a 2^16-key alphabet that all lie past the kernel's shared
    window of 58,112 bins (counted in global memory), a quarter of them
    one value."""
    keys = np.random.default_rng(seed).integers(58112, 1 << 16, n).astype(np.int32)
    keys[::4] = (1 << 16) - 1
    return keys


HIST_CONTENTION = {  # name: (keys, num_bins); 2^25 of one value: > 2^16 a CTA
    "one value": (lambda: np.full(1 << 25, 7, np.int32), 256),
    "one value, 4096 bins": (lambda: np.zeros(3_000_001, np.int32), 4096),
    "two alternating": (lambda: np.tile(np.array([3, 200], np.int32), 1 << 20), 256),
    "sorted runs": (lambda: np.sort(_skewed_keys(4096, 1 << 21, seed=3)), 4096),
    "float bytes": (lambda: _float_bytes(1 << 22, seed=2), 256),
    "float bytes, odd length": (lambda: _float_bytes(1 << 20, seed=4)[:1_000_003], 256),
    "past the shared window": (lambda: _past_window(1 << 22, seed=5), 1 << 16),
}

# Alphabets at the limit of the kernel's shared-memory window, with the
# dynamic shared bytes ``launch_info`` must report: one copy of the
# histogram a CTA up to 227 KB (58,112 bins); the bins past it count in
# global memory.
HIST_LIMITS = {256: 1024, 4096: 16384, 58112: 232448, 58113: 232448, 65536: 232448}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HIST_CONTENTION))
def test_histogram_kernel_under_contention(cuda_device, case):
    make, num_bins = HIST_CONTENTION[case]
    keys = torch.from_numpy(make())
    for start in range(4):  # every alignment of the first key
        k = keys[start:]
        got = hist_kernel.histogram(k.to(cuda_device), num_bins)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hist_ref.histogram(k, num_bins)), start


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", sorted(HIST_LIMITS))
def test_histogram_kernel_at_its_layout_limits(cuda_device, num_bins):
    info = hist_kernel.launch_info(num_bins)
    assert info["smem_bytes"] == HIST_LIMITS[num_bins] and info["ctas_per_sm"] >= 1
    keys = torch.from_numpy(_skewed_keys(num_bins, 1_000_003, seed=num_bins))
    keys[-3:] = num_bins - 1
    for k in (keys, keys[3:]):
        got = hist_kernel.histogram(k.to(cuda_device), num_bins)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hist_ref.histogram(k, num_bins))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 33])
def test_histogram_kernel_short_streams_at_every_alignment(cuda_device, n):
    keys = torch.arange(n + 3, dtype=torch.int32) % 5
    for start in range(4):
        k = keys[start:start + n]
        got = hist_kernel.histogram(k.to(cuda_device), 5)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), hist_ref.histogram(k, 5)), start


@pytest.mark.gpu
def test_histogram_kernel_empty_and_bad_inputs(cuda_device):
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert torch.equal(hist_kernel.histogram(empty, 5).cpu(), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(TypeError):
        hist_kernel.histogram(empty.long(), 5)
    with pytest.raises(ValueError, match="num_bins"):
        hist_kernel.histogram(empty, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("num_keys", ALPHABETS)
def test_encode_lookup_kernel_matches_plain_version(cuda_device, num_keys):
    rng = np.random.default_rng(num_keys)
    codes_t = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, num_keys).astype(np.int32))
    lens_t = torch.from_numpy(rng.integers(0, 33, num_keys).astype(np.int32))
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, 100_003).astype(np.int32))
    ct, lt = codes_t.to(cuda_device), lens_t.to(cuda_device)
    before = enc_kernel.launches["encode_lookup"]
    for k in (keys, keys[3:]):
        got_c, got_l = enc_kernel.encode_lookup(k.to(cuda_device), ct, lt)
        torch.cuda.synchronize()
        want_c, want_l = enc_ref.encode_lookup(k, codes_t, lens_t)
        assert torch.equal(got_c.cpu(), want_c) and torch.equal(got_l.cpu(), want_l)
    assert enc_kernel.launches["encode_lookup"] == before + 2


PACK_SIZES = (1, enc_kernel.PACK_TILE - 1, enc_kernel.PACK_TILE + 1, 100_003)  # one symbol;
# a tile less one; one past a tile edge; many tiles


def _pack_lengths(kind: str, n: int, rng) -> np.ndarray:
    """Code lengths in [0, 32]: uniform; only 0 and 32; short codes (many to
    a word); mostly empty with a few long codes (tiles of a few bits); and
    1-bit codes with long ones across every tile edge (codes that straddle
    a tile's first and last word)."""
    if kind == "uniform":
        lens = rng.integers(0, 33, n)
    elif kind == "0-and-32":
        lens = rng.choice([0, 32], n)
    elif kind == "short":
        lens = rng.integers(1, 4, n)
    elif kind == "sparse":
        lens = np.where(rng.random(n) < 0.002, rng.integers(1, 33, n), 0)
    else:
        lens = np.ones(n, np.int64)
        lens[enc_kernel.PACK_TILE - 1::enc_kernel.PACK_TILE] = 32
        lens[enc_kernel.PACK_TILE::enc_kernel.PACK_TILE] = 31
        lens[:3] = np.array([31, 30, 29])[: min(n, 3)]
    lens[-1] = max(int(lens[-1]), 1)  # the plain version indexes past a word-aligned end
    return lens.astype(np.int32)


def _pack_on_card(cuda_device, codes, lens, num_words: int, chunk_size: int) -> None:
    """pack_stream kernel == plain version: words and chunk offsets, tolerance
    0, in one launch; the caching allocator hands the call memory just filled
    with ones, so a word the kernel leaves unwritten shows."""
    codes, lens = torch.as_tensor(codes), torch.as_tensor(lens)
    torch.full((num_words + 4096,), -1, dtype=torch.int32, device=cuda_device)
    before = enc_kernel.launches["pack_stream"]
    got_w, got_o = enc_kernel.pack_stream(codes.to(cuda_device), lens.to(cuda_device), num_words,
                                          chunk_size)
    torch.cuda.synchronize()
    assert enc_kernel.launches["pack_stream"] == before + 1
    want_w, want_o = enc_ref.pack_stream(codes, lens, num_words, chunk_size)
    assert got_w.dtype == got_o.dtype == torch.int32
    assert torch.equal(got_w.cpu(), want_w)
    assert torch.equal(got_o.cpu(), want_o)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_size", [7, 256, 4096])
@pytest.mark.parametrize("kind", ["uniform", "0-and-32", "short", "sparse", "tile-edges"])
@pytest.mark.parametrize("n", PACK_SIZES)
def test_pack_stream_kernel_matches_plain_version(cuda_device, n, kind, chunk_size):
    rng = np.random.default_rng(n + len(kind) + chunk_size)
    lens = _pack_lengths(kind, n, rng)
    codes = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)  # stray high bits
    num_words = max(1, -(-int(lens.astype(np.int64).sum()) // 32))
    _pack_on_card(cuda_device, codes, lens, num_words, chunk_size)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [1, 5, 70_000])
def test_pack_stream_kernel_zeroes_words_past_the_stream(cuda_device, extra):
    """``num_words`` above the need (the words past the last code are zero),
    with empty codes after the last one."""
    rng = np.random.default_rng(extra)
    lens = rng.integers(0, 33, 20_011).astype(np.int32)
    lens[-100:] = 0
    codes = rng.integers(-(1 << 31), 1 << 31, lens.size).astype(np.int32)
    need = -(-int(lens.astype(np.int64).sum()) // 32)
    _pack_on_card(cuda_device, codes, lens, need + extra, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_size", [7, 256, 4096])
def test_pack_stream_kernel_fibonacci_codes_of_32_bits(cuda_device, chunk_size):
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    book = huffman.build_codebook(np.array(fib, np.int64))
    assert book.max_len == 32
    keys = np.random.default_rng(chunk_size).integers(0, 40, 30_001).astype(np.int32)
    codes, lens = enc_ref.encode_lookup(torch.from_numpy(keys),
                                        *huffman.codebook_tables(book, "cpu"))
    _pack_on_card(cuda_device, codes, lens, max(1, -(-int(lens.sum()) // 32)), chunk_size)


@pytest.mark.gpu
def test_pack_stream_kernel_at_2_27_laplace_keys(cuda_device):
    """2^27 discrete-Laplace keys (MGARD's scale), packed on the card by the
    kernel and by the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(27)
    u = torch.rand(1 << 27, generator=g, device=cuda_device) - 0.5
    keys = (32768 - 3.0 * torch.sign(u) * torch.log1p(-2 * u.abs())).round().clamp(0, 65535)
    keys = keys.to(torch.int32)
    del u
    book = huffman.build_codebook(torch.bincount(keys, minlength=65536).cpu().numpy())
    codes, lens = enc_ref.encode_lookup(keys, *huffman.codebook_tables(book, cuda_device))
    del keys
    num_words = max(1, -(-int(lens.to(torch.int64).sum()) // 32))
    before = enc_kernel.launches["pack_stream"]
    got_w, got_o = enc_kernel.pack_stream(codes, lens, num_words, 4096)
    torch.cuda.synchronize()
    assert enc_kernel.launches["pack_stream"] == before + 1
    want_w, want_o = enc_ref.pack_stream(codes, lens, num_words, 4096)
    assert torch.equal(got_w, want_w) and torch.equal(got_o, want_o)


@pytest.mark.gpu
def test_pack_stream_kernel_runs_on_the_main_paths(cuda_device):
    """``huffman.encode``, ``BitPack`` under ``compress_leaf`` and MGARD's
    ``compress`` of card tensors pack through the kernel, once a call, with
    the ``torch`` backend's bytes; CPU tensors launch nothing."""
    keys = _skewed_keys(3000, 50_000, seed=41)
    book = huffman.build_codebook(np.bincount(keys, minlength=3000))
    before = enc_kernel.launches["pack_stream"]
    enc = huffman.encode(torch.from_numpy(keys).to(cuda_device), book)
    want = huffman.encode(torch.from_numpy(keys), book)
    assert enc_kernel.launches["pack_stream"] == before + 1
    assert torch.equal(enc.words.cpu(), want.words)
    assert torch.equal(enc.chunk_offsets.cpu(), want.chunk_offsets)
    x = torch.from_numpy(keys.reshape(50, 1000))
    c = api.compress_leaf(x.to(cuda_device), "huffman")
    assert enc_kernel.launches["pack_stream"] == before + 2
    assert c.to_bytes() == api.compress_leaf(x, "huffman", backend="torch").to_bytes()
    g = np.meshgrid(*[np.linspace(0, 3, 33)] * 3, indexing="ij")
    f = torch.from_numpy(np.sin(sum(g)).astype(np.float32))
    c = api.compress(f.to(cuda_device), "mgard")
    assert enc_kernel.launches["pack_stream"] == before + 3
    assert c.to_bytes() == api.compress(f, "mgard", backend="torch").to_bytes()
    assert enc_kernel.launches["pack_stream"] == before + 3


def _stream(keys: np.ndarray, chunk_size: int, freq: np.ndarray | None = None):
    """A packed stream of ``keys`` (plain versions) and its decode tables."""
    if freq is None:
        freq = np.bincount(keys, minlength=int(keys.max()) + 1)
    book = huffman.build_codebook(freq)
    codes_t, lens_t = huffman.codebook_tables(book, "cpu")
    codes, lens = enc_ref.encode_lookup(torch.from_numpy(keys), codes_t, lens_t)
    total = int(lens.sum())
    words, offsets = enc_ref.pack_stream(codes, lens, max(1, -(-total // 32)), chunk_size)
    tables = huffman.padded_tables(huffman.decode_tables(book.lengths))
    return words, offsets, tables, book


@pytest.mark.gpu
@pytest.mark.parametrize("num_keys,chunk_size", [
    (1, 256), (2, 4096), (256, 256), (256, 4096), (4096, 4096), (65536, 256), (256, 7),
])
def test_decode_chunks_kernel_matches_plain_version(cuda_device, num_keys, chunk_size):
    keys = _skewed_keys(num_keys, 20_011, seed=num_keys + chunk_size)
    words, offsets, tables, book = _stream(keys, chunk_size)
    max_len = int(tables[0].shape[0]) - 1
    args = [t.to(cuda_device) for t in (words, offsets) + tables]
    before = dec_kernel.launches["decode_chunks"]
    got = dec_kernel.decode_chunks(*args, chunk_size, max_len)
    torch.cuda.synchronize()
    assert dec_kernel.launches["decode_chunks"] == before + 1
    want = dec_ref.decode_chunks(words, offsets, *tables, chunk_size, max_len)
    assert torch.equal(got.cpu(), want)  # padding symbols past the end too
    assert np.array_equal(got.reshape(-1)[: keys.size].cpu().numpy(), keys)


@pytest.mark.gpu
def test_decode_chunks_kernel_at_max_len_32(cuda_device):
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    freq = np.array(fib, np.int64)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, freq.size, 30_000).astype(np.int32)
    words, offsets, tables, book = _stream(keys, 256, freq=freq)
    assert book.max_len == 32
    args = [t.to(cuda_device) for t in (words, offsets) + tables]
    got = dec_kernel.decode_chunks(*args, 256, 32)
    want = dec_ref.decode_chunks(words, offsets, *tables, 256, 32)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.reshape(-1)[: keys.size].cpu().numpy(), keys)


@pytest.mark.gpu
def test_decode_chunks_kernel_empty_stream(cuda_device):
    words, offsets, tables, _ = _stream(np.zeros(0, np.int32), 4096, freq=np.zeros(4, np.int64))
    args = [t.to(cuda_device) for t in (words, offsets) + tables]
    before = dec_kernel.launches["decode_chunks"]
    out = dec_kernel.decode_chunks(*args, 4096, int(tables[0].shape[0]) - 1)
    assert tuple(out.shape) == (0, 4096)
    assert dec_kernel.launches["decode_chunks"] == before


def _decode_on_card(cuda_device, keys, chunk_size, freq=None):
    """Decode ``keys``' stream on the card and hold it against the plain
    decode (the whole output, padding included)."""
    words, offsets, tables, book = _stream(keys, chunk_size, freq)
    max_len = int(tables[0].shape[0]) - 1
    args = [t.to(cuda_device) for t in (words, offsets) + tables]
    before = dec_kernel.launches["decode_chunks"]
    got = dec_kernel.decode_chunks(*args, chunk_size, max_len)
    torch.cuda.synchronize()
    assert dec_kernel.launches["decode_chunks"] == before + 1
    assert torch.equal(got.cpu(), dec_ref.decode_chunks(words, offsets, *tables, chunk_size,
                                                        max_len))
    assert np.array_equal(got.reshape(-1)[: keys.size].cpu().numpy(), keys)
    return book


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_size", [1, 33, 256, 4099])
def test_decode_chunks_kernel_lookup_table_only(cuda_device, chunk_size):
    rng = np.random.default_rng(chunk_size)
    keys = rng.integers(0, 300, 40_000).astype(np.int32)  # near-uniform: codes of 8-9 bits
    book = _decode_on_card(cuda_device, keys, chunk_size)
    assert book.max_len <= dec_ref.LUT_BITS  # no code escapes the table


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_size", [7, 256, 4096])
def test_decode_chunks_kernel_escapes_to_the_scan(cuda_device, chunk_size):
    keys = _skewed_keys(4096, 60_001, seed=chunk_size)
    book = _decode_on_card(cuda_device, keys, chunk_size)
    assert book.max_len > dec_ref.LUT_BITS  # the long codes leave the table


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_size", [37, 4096])
def test_decode_chunks_kernel_codes_of_32_bits(cuda_device, chunk_size):
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    freq = np.array(fib, np.int64)
    keys = np.random.default_rng(chunk_size).integers(0, freq.size, 20_000).astype(np.int32)
    keys[:40] = np.arange(40)  # the two 32-bit codes too
    assert _decode_on_card(cuda_device, keys, chunk_size, freq=freq).max_len == 32


@pytest.mark.gpu
def test_decode_chunks_kernel_large_alphabet(cuda_device):
    keys = _skewed_keys(100_000, 150_001, seed=4)  # sym_sorted of ~10^5 symbols
    _decode_on_card(cuda_device, keys, 256)


@pytest.mark.gpu
def test_decode_chunks_kernel_symbols_too_wide_for_the_table(cuda_device):
    # canonical code: 5 -> "0", 3 -> "10", 2^25 + 7 -> "11"; the last symbol
    # does not fit beside a length in a table entry, so the kernel scans
    wide = (1 << dec_ref.SYM_BITS) + 7
    codes = {5: "0", 3: "10", wide: "11"}
    keys = np.random.default_rng(8).choice([5, 3, wide], 3001).astype(np.int32)
    chunk = 256
    bits, offsets = "", []
    for i, k in enumerate(keys):
        if i % chunk == 0:
            offsets.append(len(bits))
        bits += codes[int(k)]
    bits += "0" * (-len(bits) % 32)
    words = np.array([int(bits[i:i + 32], 2) for i in range(0, len(bits), 32)], np.uint32)
    tables = tuple(torch.tensor(a, dtype=torch.int32) for a in
                   ([0, 0, 2], [0, 1, 2], [0, 0, 1], [5, 3, wide]))
    args = [torch.from_numpy(words.view(np.int32)), torch.tensor(offsets, dtype=torch.int32)]
    got = dec_kernel.decode_chunks(*[t.to(cuda_device) for t in args + list(tables)], chunk, 2)
    want = dec_ref.decode_chunks(*args, *tables, chunk, 2)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.reshape(-1)[: keys.size].cpu().numpy(), keys)


@pytest.mark.gpu
@pytest.mark.parametrize("method,dtype", [
    ("huffman", "int32"), ("huffman", "uint16"), ("huffman-bytes", "float32"),
    ("huffman-bytes", "bfloat16"), ("huffman-bytes", "int64"),
])
def test_cuda_huffman_api_matches_torch_backend(cuda_device, method, dtype):
    rng = np.random.default_rng(7)
    if method == "huffman":
        x = torch.from_numpy(_skewed_keys(3000, 33 * 47, seed=5).reshape(33, 47)).to(
            getattr(torch, dtype))
    else:
        x = torch.from_numpy(rng.normal(size=(33, 47)).astype(np.float32)).to(
            getattr(torch, dtype))
    c = api.compress_leaf(x.to(cuda_device), method)
    assert c.to_bytes() == api.compress_leaf(x, method, backend="torch").to_bytes()
    out = api.decompress_leaf(c)
    assert out.device.type == "cuda" and out.dtype == x.dtype
    assert torch.equal(out.cpu(), x)


# ---------------------------------------------------------------------------
# MGARD: quantize, dequantize, solve_mass, lerp_coefficients
# ---------------------------------------------------------------------------


def _quant_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    tiny = np.finfo(np.float32).tiny
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    special = np.array([0.0, -0.0, math.inf, -math.inf, math.nan, 2.0 ** 31, -(2.0 ** 31),
                        2.0 ** 31 - 128, 0.5, 1.5, 2.5, -2.5, tiny * 0.25, -tiny * 0.25],
                       np.float32)
    x[: min(n, special.size)] = special[: min(n, special.size)]
    levels = rng.integers(0, 7, n).astype(np.int32)
    bins = (10.0 ** -rng.uniform(1, 4, 7)).astype(np.float32)
    bins[6] = np.float32(tiny * 0.5)  # a subnormal bin counts as zero
    return torch.from_numpy(x), torch.from_numpy(levels), torch.from_numpy(bins)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 14, 1001, 100_003])
def test_quantize_kernels_match_plain_versions(cuda_device, n):
    x, levels, bins = _quant_inputs(n, seed=n)
    before = dict(quant_kernel.launches)
    for lo in (0, 1):  # aligned and misaligned (scalar loads)
        xs, ls = x[lo:], levels[lo:]
        if not xs.numel():
            continue
        u = quant_kernel.quantize(xs.to(cuda_device), ls.to(cuda_device), bins.to(cuda_device))
        back = quant_kernel.dequantize(u, ls.to(cuda_device), bins.to(cuda_device))
        torch.cuda.synchronize()
        want_u = quant_ref.quantize(xs, ls, bins)
        assert torch.equal(u.cpu(), want_u)
        want = quant_ref.dequantize(want_u, ls, bins)
        assert torch.equal(back.cpu().view(torch.int32), want.view(torch.int32))
    runs = 1 if n == 1 else 2
    assert quant_kernel.launches["quantize"] == before["quantize"] + runs
    assert quant_kernel.launches["dequantize"] == before["dequantize"] + runs


@pytest.mark.gpu
@pytest.mark.parametrize("n,h", [(2, 2.0), (3, 4.0), (17, 2.0), (257, 2.0), (4097, 512.0),
                                 (12289, 4.0)])
def test_solve_mass_kernel_matches_plain_sweep(cuda_device, n, h):
    rng = np.random.default_rng(n)
    rhs = torch.from_numpy(rng.normal(size=(3 if n > 4097 else 131, n)).astype(np.float32))
    before = tri_kernel.launches["solve_mass"]
    got = tri_kernel.solve_mass(rhs.to(cuda_device), h)
    torch.cuda.synchronize()
    assert tri_kernel.launches["solve_mass"] == before + 1
    want = tri_ref.solve_mass(rhs, h)
    assert torch.equal(got.cpu().view(torch.int32), want.contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,q", [
    (1, 257, 1), (31, 17, 1), (33, 129, 1), (1001, 5, 1),       # Q = 1: rows of n floats
    (3, 33, 7), (143, 9, 7), (5, 2049, 7),                      # Q = 7: blocks of p's
    (1, 65, 33), (31, 3, 32), (2, 257, 1001), (1, 4097, 64),    # Q >= 32: runs of systems
    (1, 129, 40_000), (3, 1025, 1),                             # many tiles; 32 long rows
    (2, 1800, 40), (1, 60_001, 1), (2, 60_001, 33),             # n past a 32-system tile
])
def test_solve_columns_kernel_matches_plain_sweep_on_every_view(cuda_device, p, n, q):
    v = torch.from_numpy(np.random.default_rng(n + q).normal(size=(p, n, q)).astype(np.float32))
    before = tri_kernel.launches["solve_mass"]
    got = tri_kernel.solve_columns(v.to(cuda_device), 2.0)
    torch.cuda.synchronize()
    assert tri_kernel.launches["solve_mass"] == before + 1
    assert got.is_contiguous() and tuple(got.shape) == (p, n, q)
    want = tri_ref.sweep_columns(v, 2.0)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tridiag_solve_1d_on_the_card_matches_the_cpu(cuda_device, axis):
    from repro_torch.core import mgard

    x = torch.from_numpy(np.random.default_rng(axis).normal(size=(33, 65, 17)).astype(np.float32))
    got = mgard.tridiag_solve_1d(x.to(cuda_device), axis, 4.0)
    want = mgard.tridiag_solve_1d(x, axis, 4.0)
    assert got.is_contiguous()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 3), (7, 5), (129, 513), (3, 4097)])
def test_lerp_kernel_matches_plain_version(cuda_device, b, n):
    rows = torch.from_numpy(np.random.default_rng(n).normal(size=(b, n)).astype(np.float32))
    before = lerp_kernel.launches["lerp_coefficients"]
    got = lerp_kernel.lerp_coefficients(rows.to(cuda_device))
    torch.cuda.synchronize()
    assert lerp_kernel.launches["lerp_coefficients"] == before + 1
    want = lerp_ref.lerp_coefficients(rows)
    assert torch.equal(got.cpu().view(torch.int32), want.contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17,), (33, 20), (17, 9, 13), (5, 5, 5, 5)])
def test_cuda_mgard_api_matches_torch_backend(cuda_device, shape):
    x = torch.from_numpy(np.random.default_rng(11).normal(size=shape).astype(np.float32))
    c = api.compress(x.to(cuda_device), "mgard")
    assert c.to_bytes() == api.compress(x, "mgard", backend="torch").to_bytes()
    out = api.decompress(c)
    assert out.device.type == "cuda"
    want = api.decompress(c, backend="torch")
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
    assert float((out.cpu() - x).abs().max()) <= c.meta["error_bound"]


# ---------------------------------------------------------------------------
# dtypes other than float32 through the codecs: the cuda backend's
# containers equal the torch backend's
# ---------------------------------------------------------------------------


def _dtype_field(shape: tuple, dtype: str, seed: int) -> torch.Tensor:
    """Values of ``dtype``: floats over a wide exponent range with a block
    of subnormals, integers over the type's range with its minimum planted
    (alone in a block and beside other values)."""
    rng = np.random.default_rng(seed)
    tdtype = getattr(torch, dtype)
    if dtype == "bool":
        return torch.from_numpy(rng.random(shape) < 0.3)
    if tdtype.is_floating_point:
        x = torch.from_numpy(rng.normal(size=shape) * 10.0 ** rng.uniform(-6, 4, size=shape))
        x = x.to(tdtype)
        tiny = torch.finfo(tdtype).smallest_normal * 2.0 ** -3
        x.view(-1)[:64] = torch.from_numpy(rng.integers(-7, 8, size=64) * tiny).to(tdtype)
        return x
    info = torch.iinfo(tdtype)
    x = torch.from_numpy(rng.integers(max(info.min, -(2 ** 31)), min(info.max, 2 ** 31 - 1),
                                      size=shape, endpoint=True)).to(tdtype)
    x.view(-1)[:64] = info.min
    x.view(-1)[64::13] = info.min
    return x


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaNs compare)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int16 if a.element_size() == 2 else torch.int32), \
            b.view(torch.int16 if b.element_size() == 2 else torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int32", "int16", "int8", "uint8",
                                   "uint16", "uint32", "bool"])
def test_cuda_zfp_dtypes_match_torch_backend(cuda_device, dtype):
    x = _dtype_field((13, 17, 9), dtype, seed=21)
    c = api.compress(x.to(cuda_device), "zfp", rate=16)
    assert c.to_bytes() == api.compress(x, "zfp", rate=16, backend="torch").to_bytes()
    out = api.decompress(c)
    assert out.device.type == "cuda" and out.dtype == x.dtype
    assert _same(out, api.decompress(c, backend="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int16", "uint8"])
def test_cuda_zfp_integer_leaf_matches_torch_backend(cuda_device, dtype):
    x = _dtype_field((37, 50), dtype, seed=22)
    c = api.compress_leaf(x.to(cuda_device), "zfp", rate=12)
    assert c.to_bytes() == api.compress_leaf(x, "zfp", rate=12, backend="torch").to_bytes()
    assert _same(api.decompress_leaf(c), api.decompress_leaf(c, backend="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint16", "uint32", "bfloat16", "float16", "int16"])
def test_cuda_mgard_dtypes_match_torch_backend(cuda_device, dtype):
    rng = np.random.default_rng(23)
    f = rng.normal(size=(17, 9, 13)).cumsum(axis=0)
    if dtype.startswith("uint"):
        f = (f - f.min()) * 1000.0
    x = torch.from_numpy(f).to(getattr(torch, dtype))
    c = api.compress(x.to(cuda_device), "mgard")
    assert c.to_bytes() == api.compress(x, "mgard", backend="torch").to_bytes()
    out = api.decompress(c)
    assert out.device.type == "cuda" and out.dtype == x.dtype
    assert _same(out, api.decompress(c, backend="torch"))


# ---------------------------------------------------------------------------
# the progressive tier and the pytree engine on the card: the cuda
# backend's containers equal the torch backend's
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 9, 13), (33, 20)])
def test_cuda_progressive_matches_torch_backend(cuda_device, shape, tmp_path):
    from repro_torch.core import progressive

    x = torch.from_numpy(np.random.default_rng(24).normal(size=shape).cumsum(axis=0)
                         .astype(np.float32))
    c = api.compress(x.to(cuda_device), "mgard-progressive")
    assert c.to_bytes() == api.compress(x, "mgard-progressive", backend="torch").to_bytes()
    stream = progressive.ProgressiveStream.from_container(c)
    stream.write(tmp_path / "p.hpdr")
    with progressive.ProgressiveReader(tmp_path / "p.hpdr") as r:
        coarse = r.retrieve(tiers=1)
        assert coarse.device.type == "cuda"
        assert float((coarse.cpu() - x).abs().max()) <= r.tier_bounds[0]
        refined = r.refine()
        assert r.bytes_fetched == stream.nbytes()
    direct = progressive.retrieve(stream)
    assert _same(refined, direct)
    assert _same(direct, progressive.retrieve(stream, backend="torch"))
    assert float((direct.cpu() - x).abs().max()) <= stream.tier_bounds[-1]


@pytest.mark.gpu
def test_cuda_pytree_matches_torch_backend(cuda_device):
    from repro_torch.core import engine

    rng = np.random.default_rng(25)
    tree = {"layers": [{"wq": rng.normal(0, 0.02, (64, 128)).astype(np.float32),
                        "wo": rng.normal(0, 0.02, (128, 64)).astype(np.float32),
                        "norm": np.ones(256, np.float32)} for _ in range(3)],
            "embed": rng.normal(0, 0.02, (96, 64)).astype(np.float32),
            "ids": rng.integers(0, 300, 5000).astype(np.int32)}

    def select(key, arr):
        if key == "ids":
            return "huffman", {}
        if key.endswith("norm"):
            return "huffman-bytes", {}
        if key == "layers/0/wo":
            return "mgard-progressive", {}
        return api.default_select(key, arr)

    with engine.ExecutionEngine() as eng, \
            engine.ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as cpu:
        flat, stats = eng.compress_pytree(tree, select)
        want, _ = cpu.compress_pytree(tree, select)
        assert list(flat) == list(want) and stats["sharded_leaves"] == 5 + 3
        for key, c in flat.items():
            assert c.to_bytes() == want[key].to_bytes(), key
        out = dict(api.flatten_with_keys(eng.decompress_pytree(flat, tree)))
        back = dict(api.flatten_with_keys(cpu.decompress_pytree(want, tree)))
        for key, got in out.items():
            assert got.device.type == "cuda" and _same(got, back[key]), key
        assert eng.stats()["devices"] == torch.cuda.device_count()


@pytest.mark.gpu
def test_kernels_launch_from_threads_at_other_shared_sizes(cuda_device):
    """The engine launches from several host threads at once.  A kernel's
    dynamic shared-memory limit is one per process: a thread launching with
    less shared memory (codes of 9 against 32 bits, alphabets of 256 against
    16,384 keys, ZFP at rate 4 against rate 32) must not lower the limit
    under another thread's launch.  Every launch succeeds and gives its
    plain version's result."""
    import threading

    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(31)
    decodes = []
    for keys, freq, chunk in ((rng.integers(0, 300, 40_000).astype(np.int32), None, 4096),
                              (rng.integers(0, 40, 40_000).astype(np.int32),
                               np.array(fib, np.int64), 256)):
        words, offsets, tables, book = _stream(keys, chunk, freq=freq)
        args = [t.to(cuda_device) for t in (words, offsets) + tables]
        want = dec_ref.decode_chunks(words, offsets, *tables, chunk, book.max_len)
        decodes.append((args, chunk, book.max_len, want))
    lookups = []
    for num_keys in (256, 1 << 14):
        ct = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, num_keys).astype(np.int32))
        lt = torch.from_numpy(rng.integers(0, 33, num_keys).astype(np.int32))
        keys = torch.from_numpy(rng.integers(0, num_keys, 200_003).astype(np.int32))
        lookups.append(([t.to(cuda_device) for t in (keys, ct, lt)],
                        enc_ref.encode_lookup(keys, ct, lt)))
    blocks = _blocks(3, 4096, seed=32).to(cuda_device)
    fields = [(rate, ref.compress_blocks(blocks.cpu(), rate, 3)) for rate in (4, 32)]

    def work(i, barrier, errors):
        stream = torch.cuda.Stream(cuda_device)
        barrier.wait()
        try:
            with torch.cuda.stream(stream):
                for _ in range(40):
                    args, chunk, max_len, want = decodes[i % 2]
                    got = dec_kernel.decode_chunks(*args, chunk, max_len)
                    args, want_cl = lookups[i % 2]
                    codes, lens = enc_kernel.encode_lookup(*args)
                    rate, want_z = fields[i % 2]
                    payload, emax = kernel.compress_blocks(blocks, rate, 3)
                stream.synchronize()
            assert torch.equal(got.cpu(), want)
            assert torch.equal(codes.cpu(), want_cl[0]) and torch.equal(lens.cpu(), want_cl[1])
            assert torch.equal(payload.cpu(), want_z[0]) and torch.equal(emax.cpu(), want_z[1])
        except BaseException as e:  # reported below: a thread's failure fails the test
            errors.append(e)

    errors = []
    barrier = threading.Barrier(6)
    threads = [threading.Thread(target=work, args=(i, barrier, errors)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


@pytest.mark.gpu
@pytest.mark.parametrize("method,params", [("zfp", {"rate": 16}), ("huffman-bytes", {})])
def test_cuda_stream_bytes_match_torch_backend(cuda_device, method, params):
    """48 small chunks from pageable host memory at window 3: every chunk's
    compute must wait on its staging copy's event (a chunk read half-copied
    changes the bytes), so the bytes equal window 1's and the ``torch``
    backend's."""
    rng = np.random.default_rng(40)
    host = torch.from_numpy(rng.normal(0.0, 0.02, (48 * 4, 64, 64)).astype(np.float32))
    chunk = 4 * 64 * 64
    blobs = {}
    for backend, window in (("cuda", 3), ("cuda", 1), ("torch", 2)):
        stream = api.CompressorStream(method, mode="fixed", c_fixed_elems=chunk, window=window,
                                      backend=backend, **params)
        res = stream.compress(host)
        assert len(res.chunks) == 48 and res.max_in_flight <= window
        blobs[backend, window] = api.CompressorStream.to_bytes(res)
    assert blobs["cuda", 3] == blobs["cuda", 1] == blobs["torch", 2]
    out = api.CompressorStream.decompress(api.CompressorStream.from_bytes(blobs["cuda", 3]))
    assert out.device.type == "cuda" and out.shape == host.shape
    if method == "huffman-bytes":
        assert torch.equal(out.cpu(), host)


# ---------------------------------------------------------------------------
# serving: KV parking, the service and the decode path on the card
# ---------------------------------------------------------------------------


def _park_async_then_write(device, stream) -> None:
    """Park a cache with ``park_async`` from ``stream`` and queue in-place
    writes of it on that stream at once (and more of them while the io
    lane's task waits); the parked containers must be those of the cache as
    it was when ``park_async`` returned."""
    from repro_torch.core import engine
    from repro_torch.serving import KVPageStore, compress_kv_cache

    g = torch.Generator(device=device).manual_seed(50)
    cache = {"k": torch.randn((4, 2, 256, 2, 64), generator=g, device=device),
             "v": torch.randn((4, 2, 256, 2, 64), generator=g, device=device),
             "pos": torch.arange(8, device=device)}
    before = {k: v.clone() for k, v in cache.items()}
    with engine.ExecutionEngine() as eng:
        store = KVPageStore(capacity_bytes=64 << 20, engine=eng)
        stream.wait_stream(torch.cuda.current_stream(device))  # the cache is written
        with torch.cuda.stream(stream):
            sub = store.park_async("s", cache)
            for _ in range(20):  # a queue of in-place writes behind the copy
                cache["k"].mul_(1.5).add_(1.0)
            cache["v"].zero_()
            cache["pos"].fill_(-1)
        sub.result(timeout=120)
        want, _ = compress_kv_cache(before, rate=12, engine=eng)
        got = store.fetch("s")
        for key in ("k", "v"):
            assert got[key].to_bytes() == want[key].to_bytes(), key
        assert torch.equal(got["pos"], before["pos"])


@pytest.mark.gpu
def test_cuda_park_async_snapshot_survives_in_place_writes(cuda_device):
    """``park_async`` copies the cache on the caller's stream before it
    returns; the writes the decode loop queues next must not reach the
    park."""
    _park_async_then_write(cuda_device, torch.cuda.default_stream(cuda_device))


@pytest.mark.gpu
def test_cuda_park_async_snapshot_from_a_side_stream(cuda_device):
    """The same from a decode loop running under ``torch.cuda.stream(s)``:
    the copy and the writes are queued on ``s``, not the default stream."""
    _park_async_then_write(cuda_device, torch.cuda.Stream(cuda_device))


@pytest.mark.gpu
def test_cuda_service_bytes_match_torch_backend(cuda_device):
    """The service on the card (a ZFP bucket coalesced from two requests, a
    ``huffman-bytes`` leaf, raw leaves) writes the ``torch`` backend's bytes,
    and decodes to tensors on the card."""
    from repro_torch.core import engine
    from repro_torch.serving import ReductionService

    rng = np.random.default_rng(51)
    trees = [{"w": torch.from_numpy(rng.normal(0, 0.02, (96, 80)).astype(np.float32)).to(
                  cuda_device),
              "norm": torch.from_numpy(rng.normal(0, 0.02, (96,)).astype(np.float32)),
              "ids": np.arange(12, dtype=np.int32)} for _ in range(2)]

    def select(key, arr):
        if key == "norm":
            return "huffman-bytes", {}
        return api.default_select(key, arr)

    with engine.ExecutionEngine() as eng, \
            engine.ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as cpu:
        with ReductionService(eng, batch_window=0.05) as svc:
            subs = [svc.submit_compress(t, select) for t in trees]
            outs = [s.result(timeout=120) for s in subs]
            restored = svc.decompress(outs[0][0], trees[0])
            assert svc.stats().coalesced_requests == 2
        for tree, (flat, _stats) in zip(trees, outs):
            want, _ = cpu.compress_pytree({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                                           for k, v in tree.items()}, select)
            for key, val in want.items():
                if isinstance(val, api.Compressed):
                    assert flat[key].to_bytes() == val.to_bytes(), key
    assert restored["w"].device.type == "cuda"
    assert torch.equal(restored["norm"].cpu(), trees[0]["norm"])


@pytest.mark.gpu
def test_cuda_decode_step_matches_cpu(cuda_device):
    """One decode step of qwen2.5-3b's smoke cut in float32 on the card
    against the CPU path on the same weights: within 1e-4 (cuBLAS sums in
    another order; TF32 is off by default for float32 matmuls)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("qwen2.5-3b").smoke())
    params = model.init(torch.Generator().manual_seed(52), "cpu")
    on_card = _to(params, cuda_device)
    tok = torch.tensor([1, 17, 255], dtype=torch.int32)
    out = {}
    for name, dev, p in (("cpu", torch.device("cpu"), params), ("card", cuda_device, on_card)):
        cache = model.init_cache(3, 16, torch.float32, device=dev)
        for step in range(3):
            logits, cache = model.decode_step(p, tok.to(dev), cache, step)
        out[name] = (logits.cpu(), cache["k"].cpu())
    assert (out["card"][0] - out["cpu"][0]).abs().max() <= 1e-4
    assert (out["card"][1] - out["cpu"][1]).abs().max() <= 1e-4


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step of qwen2.5-3b's smoke cut in float32 on the card
    against the CPU on the same weights and batch: the loss within 1e-5 of
    its value, every gradient leaf within 1e-4 of its largest magnitude
    (cuBLAS sums in another order; no TF32; the key bias, whose exact
    gradient is 0, against the query bias's), and after two steps every
    parameter within 1e-6 but where Adam's normalised step takes the other
    sign on rounding noise (the key bias; at most 0.1% of another leaf):
    there within twice the learning rates' sum."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedule

    model = build_model(get_config("qwen2.5-3b").smoke())
    params = model.init(torch.Generator().manual_seed(53), "cpu")
    on_card = _to(params, cuda_device)
    rng = np.random.default_rng(54)
    window = torch.from_numpy(rng.integers(0, model.cfg.vocab, (4, 33)).astype(np.int32))
    batch = {"tokens": window[:, :-1], "labels": window[:, 1:]}
    (loss, _), grads = model.value_and_grad(params, batch)
    (closs, _), cgrads = model.value_and_grad(on_card, _to(batch, cuda_device))
    assert abs(float(closs) - float(loss)) <= 1e-5 * abs(float(loss))
    flat, cflat = dict(api.flatten_with_keys(grads)), dict(api.flatten_with_keys(cgrads))
    for k, g in flat.items():
        scale = flat[k.replace("wk/b", "wq/b")] if k.endswith("attn/wk/b") else g
        assert (cflat[k].cpu() - g).abs().max() <= 1e-4 * scale.abs().max(), k
    states = [adamw.init_state(p, adamw.AdamWConfig()) for p in (params, on_card)]
    step = make_train_step(model, adamw.AdamWConfig(), schedule.cosine, 3e-4, 10)
    for p, st, b in ((params, states[0], batch), (on_card, states[1], _to(batch, cuda_device))):
        step(p, st, b)
        step(p, st, b)
    lr_sum = sum(float(schedule.cosine(i, peak_lr=3e-4, warmup=1, total=10)) for i in range(2))
    flat, cflat = dict(api.flatten_with_keys(params)), dict(api.flatten_with_keys(on_card))
    for k, v in flat.items():
        diff = (cflat[k].cpu() - v).abs()
        assert diff.max() <= 2 * lr_sum, k
        if not k.endswith("attn/wk/b"):  # its exact gradient is 0: Adam steps on noise
            assert (diff > 1e-6).float().mean() <= 1e-3, k


@pytest.mark.gpu
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_cuda_adamw_in_place_matches_functional(cuda_device, moment_dtype):
    """The in-place AdamW on the card against the functional form on the
    card, three steps with the clip active and a NaN gradient at the
    second: bit for bit (the same elementwise ops in the same order)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault

    rng = np.random.default_rng(55)

    def tree(scale):
        return {"a": {"w": torch.from_numpy((rng.normal(size=(300, 70)) * scale).astype(
                    np.float32)).to(cuda_device)},
                "b": torch.from_numpy((rng.normal(size=(1001,)) * scale).astype(
                    np.float32)).to(cuda_device)}

    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    fp = tree(1.0)
    ip = {"a": {"w": fp["a"]["w"].clone()}, "b": fp["b"].clone()}
    fs, is_ = adamw.init_state(fp, cfg), adamw.init_state(ip, cfg)
    for step in range(3):
        g = tree(3.0)
        if step == 1:
            g["b"][17] = float("nan")
        lr = torch.tensor(1e-2 * (step + 1), device=cuda_device)
        new, fs, _ = adamw.apply_updates(fp, g, fs, lr, cfg)
        fp, finite = fault.skip_nonfinite_update(new, fp, g)
        out = adamw.apply_updates_(ip, {"a": {"w": g["a"]["w"].clone()}, "b": g["b"].clone()},
                                   is_, lr, cfg)
        assert bool(out["finite"]) == bool(finite) == (step != 1)
        for a, b in ((fp["a"]["w"], ip["a"]["w"]), (fp["b"], ip["b"]),
                     (fs["m"]["b"], is_["m"]["b"]), (fs["v"]["a"]["w"], is_["v"]["a"]["w"])):
            words = torch.int32 if a.dtype == torch.float32 else torch.int16
            assert a.dtype == b.dtype and torch.equal(a.view(words), b.view(words))
    assert int(is_["step"]) == int(fs["step"]) == 3


@pytest.mark.gpu
def test_cuda_exact_checkpoint_resume_is_bit_for_bit(cuda_device, tmp_path, monkeypatch):
    """``train_loop`` on the card (smoke cut) under deterministic algorithms:
    a run restarted from its exact step-3 checkpoint gives the
    uninterrupted run's losses and final state bit for bit."""
    from repro_torch.launch.train import train_loop

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(steps=6, batch=4, seq=32, log_every=100, device=cuda_device)
        a = train_loop("qwen2.5-3b", **kw)
        with pytest.raises(RuntimeError, match="injected failure at step 4"):
            train_loop("qwen2.5-3b", ckpt_dir=str(tmp_path / "ck"), ckpt_every=3,
                       sync_ckpt=True, inject_failure_at=4, **kw)
        c = train_loop("qwen2.5-3b", ckpt_dir=str(tmp_path / "ck"), ckpt_every=3, **kw)
    finally:
        torch.use_deterministic_algorithms(was)
    assert c["steps_run"] == 3 and c["losses"] == a["losses"][3:]
    fa, fc = dict(api.flatten_with_keys(a["state"])), dict(api.flatten_with_keys(c["state"]))
    for k, x in fa.items():
        assert fc[k].is_cuda and fc[k].dtype == x.dtype and torch.equal(fc[k], x), k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2-vl-72b"])
def test_cuda_ssm_and_vlm_step_and_decode_match_cpu(cuda_device, arch):
    """The ssm and vlm families' smoke cuts in float32 on the card against
    the CPU on the same weights: the loss within 1e-5 of its value, every
    gradient leaf within 1e-4 of its largest magnitude (the key bias, whose
    exact gradient is 0, against the query bias's), and four decode steps'
    logits and cache within 1e-4 (cuBLAS sums in another order; no TF32).
    The vlm batch is ``embeds`` with M-RoPE positions that mix text tokens
    and an image grid."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config(arch).smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(56), "cpu")
    on_card = _to(params, cuda_device)
    rng = np.random.default_rng(57)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    if cfg.family == "vlm":
        pos = np.repeat(np.arange(40, dtype=np.int32)[:, None], 3, axis=1)
        pos[8:20, 0] = 8
        pos[8:20, 1] = 8 + np.arange(12) // 4
        pos[8:20, 2] = 8 + np.arange(12) % 4
        batch = {"embeds": torch.from_numpy(rng.normal(size=(2, 40, cfg.d_model)).astype(
                     np.float32)),
                 "positions_3d": torch.from_numpy(np.broadcast_to(pos, (2, 40, 3)).copy()),
                 "labels": labels}
    else:
        batch = {"tokens": torch.roll(labels, 1, 1), "labels": labels}
    (loss, _), grads = model.value_and_grad(params, batch)
    (closs, _), cgrads = model.value_and_grad(on_card, _to(batch, cuda_device))
    assert abs(float(closs) - float(loss)) <= 1e-5 * abs(float(loss))
    flat, cflat = dict(api.flatten_with_keys(grads)), dict(api.flatten_with_keys(cgrads))
    for k, g in flat.items():
        scale = flat[k.replace("wk/b", "wq/b")] if k.endswith("attn/wk/b") else g
        assert (cflat[k].cpu() - g).abs().max() <= 1e-4 * scale.abs().max(), k
    tok = torch.tensor([1, 17, 255], dtype=torch.int32)
    out = {}
    for name, dev, p in (("cpu", torch.device("cpu"), params), ("card", cuda_device, on_card)):
        cache = model.init_cache(3, 16, torch.float32, device=dev)
        for step in range(4):
            logits, cache = model.decode_step(p, tok.to(dev), cache, step)
        out[name] = (logits.cpu(), {k: v.cpu() for k, v in cache.items()})
    assert (out["card"][0] - out["cpu"][0]).abs().max() <= 1e-4
    for k, v in out["cpu"][1].items():
        assert (out["card"][1][k] - v).abs().max() <= 1e-4 * max(1.0, float(v.abs().max())), k


@pytest.mark.gpu
def test_cuda_rglru_scan_is_the_cpu_s_bit_for_bit(cuda_device):
    """The RG-LRU's associative scan on the same (a, b): the card's bits are
    the CPU's (each level a separate multiply and add, rounded as written)."""
    from repro_torch.models import rglru

    rng = np.random.default_rng(58)
    for length in (1, 17, 64, 2049):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, length, 64)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, length, 64)).astype(np.float32))
        ca, cb = rglru._associative_scan(a.to(cuda_device), b.to(cuda_device))
        pa, pb = rglru._associative_scan(a, b)
        assert torch.equal(ca.cpu(), pa) and torch.equal(cb.cpu(), pb), length


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "seamless-m4t-medium"])
def test_cuda_hybrid_and_encdec_step_and_decode_match_cpu(cuda_device, arch):
    """The hybrid and encdec smoke cuts in float32 on the card against the
    CPU on the same weights: the loss within 1e-5 of its value, every
    gradient leaf within 1e-4 of its largest magnitude, and 40 decode steps'
    logits (the hybrid's 32-slot attention ring wraps; the encdec's after
    ``encode`` and ``precompute_cross``) within 1e-4 (no TF32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec, load_params

    model = build_model(get_config(arch).smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(59), "cpu")
    on_card = load_params(params, cuda_device)  # the hybrid's tail is a list
    rng = np.random.default_rng(60)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    batch = {"tokens": torch.roll(labels, 1, 1), "labels": labels}
    frames = torch.from_numpy(rng.normal(size=(3, 12, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["enc_embeds"] = frames[:2]
    (loss, _), grads = model.value_and_grad(params, batch)
    (closs, _), cgrads = model.value_and_grad(on_card, _to(batch, cuda_device))
    assert abs(float(closs) - float(loss)) <= 1e-5 * abs(float(loss))
    flat, cflat = dict(api.flatten_with_keys(grads)), dict(api.flatten_with_keys(cgrads))
    for k, g in flat.items():
        assert (cflat[k].cpu() - g).abs().max() <= 1e-4 * g.abs().max(), k
    tok = torch.tensor([1, 17, 255], dtype=torch.int32)
    out = {}
    for name, dev, p in (("cpu", torch.device("cpu"), params), ("card", cuda_device, on_card)):
        cache = model.init_cache(3, 48, torch.float32, device=dev)
        if cfg.family == "encdec":
            with torch.no_grad():
                memory = encdec.encode(p, frames.to(dev), cfg)
                cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(p, memory, cfg)
        logits = []
        for step in range(40):
            step_logits, cache = model.decode_step(p, tok.to(dev), cache, step)
            logits.append(step_logits.cpu())
        out[name] = torch.stack(logits)
    assert (out["card"] - out["cpu"]).abs().max() <= 1e-4 * max(1.0, float(out["cpu"].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["tp", "dp_zero1"])
def test_cuda_placed_train_step_matches_unplaced(cuda_device, policy):
    """A world-size-1 NCCL group and a 1 x 1 ``("data","model")`` mesh over
    the card: ``launch.specs.make_train_step`` on placed parameters, moments
    and batches (qwen2.5-3b's smoke cut, two steps) gives the unplaced
    step's losses, parameters and moments bit for bit: on a mesh of one
    rank every placement is ``Replicate``, so the placed step runs the same
    kernels on the same tensors; the group is ended after."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shr

    cfg = dataclasses.replace(get_config("qwen2.5-3b").smoke(), sharding_policy=policy)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    step = S.make_train_step(model, opt_cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    state = adamw.init_state(params, opt_cfg)
    toks = torch.randint(0, cfg.vocab, (2, 4, 33), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(cuda_device)
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]

    def placed(tree, places):
        where = dict(api.flatten_with_keys(places))
        return api.unflatten_like(tree, lambda k: where[k].distribute(
            dict(api.flatten_with_keys(tree))[k].clone()))

    started = not dist.is_initialized()
    mesh = make_test_mesh(1, 1, cuda_device)
    try:
        with use_mesh(mesh):
            sh = shr.param_shardings(params, cfg, mesh)
            pp = placed(params, sh)
            ps = {"m": placed(state["m"], sh), "v": placed(state["v"], sh),
                  "step": shr.replicated(mesh).distribute(state["step"].clone())}
            got = [float(step(pp, ps, {k: shr.placed(shr.batch_spec(v, cfg, mesh), mesh)
                                       .distribute(v) for k, v in b.items()})[2]["loss"])
                   for b in batches]
        want = [float(step(params, state, b)[2]["loss"]) for b in batches]
        assert got == want
        for tree, ref in ((pp, params), (ps["m"], state["m"]), (ps["v"], state["v"])):
            flat = dict(api.flatten_with_keys(tree))
            for k, x in api.flatten_with_keys(ref):
                local = flat[k].to_local()
                assert local.is_cuda
                assert torch.equal(local.view(torch.int32), x.view(torch.int32)), k
    finally:
        if started:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the standalone ZFP and MGARD API and the parallel abstractions on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [1, 16, 32])
@pytest.mark.parametrize("shape", [(1001,), (33, 47), (33, 47, 65), (5, 6, 7, 9)])
def test_cuda_zfp_compress_jit_kernel_matches_plain(cuda_device, shape, rate):
    """``zfp.compress_jit(adapter="cuda")`` (the kernel) against
    ``adapter="torch"`` (the plain block path on the same card), and the
    decode both ways; both against the CPU's plain path.  With no adapter
    a card tensor goes through the kernel (``zfp.compress``/``decompress``
    too)."""
    from repro_torch.core import zfp

    x = torch.from_numpy(np.random.default_rng(rate).normal(size=shape).astype(np.float32))
    xd = x.to(cuda_device)
    dims = len(shape)
    before = kernel.launches["compress_blocks"]
    p1, e1 = zfp.compress_jit(xd, rate, dims, shape, adapter="cuda")
    assert kernel.launches["compress_blocks"] == before + 1
    p0, e0 = zfp.compress_jit(xd, rate, dims, shape, adapter="torch")
    assert kernel.launches["compress_blocks"] == before + 1
    pc, ec = zfp.compress_jit(x, rate, dims, shape)
    assert torch.equal(p1.cpu(), p0.cpu()) and torch.equal(e1.cpu(), e0.cpu())
    assert torch.equal(p1.cpu(), pc) and torch.equal(e1.cpu(), ec)
    before = kernel.launches["decompress_blocks"]
    d1 = zfp.decompress_jit(p1, e1, rate, dims, shape, adapter="cuda")
    assert kernel.launches["decompress_blocks"] == before + 1
    d0 = zfp.decompress_jit(p1, e1, rate, dims, shape, adapter="torch")
    dc = zfp.decompress_jit(pc, ec, rate, dims, shape)
    assert torch.equal(d1.cpu().view(torch.int32), d0.cpu().view(torch.int32))
    assert torch.equal(d1.cpu().view(torch.int32), dc.view(torch.int32))
    before = (kernel.launches["compress_blocks"], kernel.launches["decompress_blocks"])
    z = zfp.compress(xd, rate)
    out = zfp.decompress(z)
    assert (kernel.launches["compress_blocks"], kernel.launches["decompress_blocks"]) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(z.payload.cpu(), pc) and torch.equal(z.emax.cpu(), ec)
    assert torch.equal(out.cpu().view(torch.int32), dc.view(torch.int32))


@pytest.mark.gpu
def test_cuda_mgard_compress_runs_the_kernels(cuda_device):
    """``mgard.compress``/``decompress`` of a card tensor quantize and
    dequantize through the ``quantize_map`` kernels (one launch each), and
    the round trip stays within its absolute bound (1e-3)."""
    from repro_torch.core import mgard

    g = np.meshgrid(*[np.linspace(0, 3, 33)] * 3, indexing="ij")
    x = torch.from_numpy(np.sin(sum(g)).astype(np.float32)).to(cuda_device)
    before = (quant_kernel.launches["quantize"], quant_kernel.launches["dequantize"])
    m = mgard.compress(x, 1e-3)
    out = mgard.decompress(m)
    assert (quant_kernel.launches["quantize"], quant_kernel.launches["dequantize"]) \
        == (before[0] + 1, before[1] + 1)
    assert out.device.type == "cuda" and float((out - x).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [0, 1, 2])
def test_cuda_locality_matches_cpu(cuda_device, halo):
    """``locality`` on the card against the same call on a CPU copy, bit for
    bit (an elementwise ``fn``; with a halo, a stencil of shifted slices)."""
    from repro_torch.core import abstractions as ab

    x = torch.from_numpy(np.random.default_rng(halo).normal(size=(33, 18, 21))
                         .astype(np.float32))

    def fn(p):
        if halo == 0:
            return p * 2.0 + torch.abs(p)
        inner = p[halo:-halo, halo:-halo, halo:-halo]
        return inner * 3.0 - p[:-2 * halo, halo:-halo, halo:-halo] + p[halo:-halo, 2 * halo:,
                                                                        halo:-halo]

    out = ab.locality(x.to(cuda_device), fn, (4, 4, 4), halo=halo)
    want = ab.locality(x, fn, (4, 4, 4), halo=halo)
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_iterative_matches_cpu(cuda_device, reverse):
    """``iterative`` as a prefix sum along axis 0 with a tuple carry, on the
    card against the CPU, bit for bit."""
    from repro_torch.core import abstractions as ab

    x = torch.from_numpy(np.random.default_rng(7).normal(size=(40, 17, 9)).astype(np.float32))

    def step(carry, s):
        total, peak = carry
        total = total + s
        return (total, torch.maximum(peak, total)), total

    def run(t):
        return ab.iterative(t, step, (torch.zeros_like(t[0]), torch.full_like(t[0], -1e30)), 0,
                            reverse=reverse)

    (ct, cp), cy = run(x.to(cuda_device))
    (wt, wp), wy = run(x)
    for got, want in ((ct, wt), (cp, wp), (cy, wy)):
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
