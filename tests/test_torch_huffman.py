"""The port's Huffman slice against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages: the
reference's ``repro.core.huffman`` codebook and ``bitstream``, its
``histogram`` / ``huffman_encode`` / ``huffman_decode`` kernels (Pallas in
interpret mode, at a few hundred symbols) and their plain ``ref``s, and
``repro.core.api`` with the ``xla`` backend; the port's plain PyTorch
versions and ``backend="torch"``.  Tolerance: none.  Codebooks, words,
chunk offsets, container bytes and decoded values must be identical, and
each package decodes the other's streams.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import api as japi
from repro.core import bitstream as jbits
from repro.core import huffman as jhuff
from repro.core.container import Compressed as JCompressed
from repro.kernels.histogram import kernel as jhist_kernel
from repro.kernels.histogram import ref as jhist_ref
from repro.kernels.huffman_decode import kernel as jdec_kernel
from repro.kernels.huffman_decode import ref as jdec_ref
from repro.kernels.huffman_encode import kernel as jenc_kernel
from repro.kernels.huffman_encode import ref as jenc_ref
from repro_torch.core import api as tapi
from repro_torch.core import bitstream as tbits
from repro_torch.core import huffman as thuff
from repro_torch.core.codecs import huffman_codec as tcodec
from repro_torch.core.container import Compressed as TCompressed
from repro_torch.core.container import ContainerError
from repro_torch.core.stages.base import CallEnv
from repro_torch.core.stages.library import CodebookBuild
from repro_torch.kernels.histogram import ref as thist_ref
from repro_torch.kernels.huffman_decode import ref as tdec_ref
from repro_torch.kernels.huffman_encode import kernel as tenc_kernel
from repro_torch.kernels.huffman_encode import ref as tenc_ref

torch.set_num_threads(2)


def _fibonacci(n: int) -> np.ndarray:
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return np.array(fib[:n], np.int64)


FREQS = {
    "skewed": lambda rng: rng.zipf(1.5, 300) % 1000,
    "random-257": lambda rng: rng.integers(0, 1000, 257),
    "tied": lambda rng: np.full(37, 5),
    "tied-pairs": lambda rng: np.repeat(rng.integers(1, 9, 20), 2),
    "single-symbol": lambda rng: np.eye(1, 9, 4, dtype=np.int64)[0] * 7,
    "empty": lambda rng: np.zeros(6, np.int64),
    "fibonacci-32": lambda rng: _fibonacci(40),                 # limited to 32 bits
    "fibonacci-test-huffman": lambda rng: np.array([int(1.6 ** i) + 1 for i in range(64)]),
}


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# codebook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [32, 12])
@pytest.mark.parametrize("case", sorted(FREQS))
def test_codebook_matches_reference(case, max_len):
    freq = np.asarray(FREQS[case](np.random.default_rng(len(case))), np.int64)
    want = jhuff.build_codebook(freq, max_len=max_len)
    got = thuff.build_codebook(freq, max_len=max_len)
    assert got.max_len == want.max_len <= max_len
    for field in ("lengths", "codes", "first_code", "count", "sym_offset", "sym_sorted"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    if case == "fibonacci-32" and max_len == 32:
        assert got.max_len == 32  # the limiter ran


@pytest.mark.parametrize("case", ["skewed", "fibonacci-32", "single-symbol", "empty"])
def test_decode_tables_match_reference(case):
    freq = np.asarray(FREQS[case](np.random.default_rng(1)), np.int64)
    lengths = jhuff.build_codebook(freq).lengths
    want = jhuff.decode_tables(lengths)
    got = thuff.decode_tables(lengths)
    assert got.max_len == want.max_len
    assert np.array_equal(_u32(got.first_code), np.asarray(want.first_code))
    for field in ("count", "sym_offset", "sym_sorted"):
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


def _scan(window: int, fc: np.ndarray, ct: np.ndarray, max_len: int) -> int:
    """The canonical scan's accepted length for one 32-bit window, 0 if none."""
    for l in range(1, max_len + 1):
        cand = window >> (32 - l)
        if int(fc[l]) <= cand < int(fc[l]) + int(ct[l]):
            return l
    return 0


@pytest.mark.parametrize("case", sorted(FREQS))
def test_decode_lut_matches_the_canonical_scan_for_every_prefix(case):
    freq = np.asarray(FREQS[case](np.random.default_rng(len(case))), np.int64)
    book = thuff.build_codebook(freq)
    tables = thuff.padded_tables(thuff.decode_tables(book.lengths))
    max_len = int(tables[0].shape[0]) - 1
    lut = tdec_ref.decode_lut(*tables, max_len).numpy().astype(np.int64)
    k = min(max_len, tdec_ref.LUT_BITS)
    assert lut.shape == (1 << k,)
    fc, ct = _u32(tables[0]).astype(np.int64), tables[1].numpy()
    so, ss = tables[2].numpy(), tables[3].numpy()
    rng = np.random.default_rng(3)
    for prefix in range(1 << k):
        length, upper = int(lut[prefix] & 63), int(lut[prefix] >> 6)
        for low in (0, (1 << (32 - k)) - 1, int(rng.integers(0, 1 << (32 - k)))):
            l = _scan((prefix << (32 - k)) | low, fc, ct, max_len)
            if 0 < l <= k:  # the table resolves it, whatever the lower bits
                rel = ((prefix << (32 - k)) >> (32 - l)) - fc[l]
                assert (length, upper) == (l, ss[so[l] + rel])
            else:           # an escape: the scan goes on past K bits
                assert (length, upper) == (0, k + 1)


def test_decode_lut_escapes_symbols_too_wide_to_pack():
    tables = thuff.padded_tables(thuff.decode_tables(np.array([1, 2, 2], np.int32)))
    wide = tables[3].clone()
    wide[1] = 1 << tdec_ref.SYM_BITS  # the symbol of code "10"
    lut = tdec_ref.decode_lut(*tables[:3], wide, 2).numpy()
    assert list(lut & 63) == [1, 1, 0, 2] and lut[2] >> 6 == 2  # "10": scan from length 2
    assert list(lut[[0, 1, 3]] >> 6) == [0, 0, 2]


@pytest.mark.parametrize("case", ["skewed", "fibonacci-32", "single-symbol", "empty"])
def test_decode_lut_of_reference_tables_matches_reference_decode(case):
    freq = np.asarray(FREQS[case](np.random.default_rng(1)), np.int64)
    lengths = jhuff.build_codebook(freq).lengths
    jt = jhuff.decode_tables(lengths)
    jtables = thuff.padded_tables(thuff.DecodeTables(
        first_code=_tensor(np.asarray(jt.first_code).view(np.int32)),
        count=_tensor(np.asarray(jt.count)), sym_offset=_tensor(np.asarray(jt.sym_offset)),
        sym_sorted=_tensor(np.asarray(jt.sym_sorted)), max_len=int(jt.max_len)))
    max_len = int(jtables[0].shape[0]) - 1
    got = tdec_ref.decode_lut(*jtables, max_len)
    assert torch.equal(got, tdec_ref.decode_lut(*thuff.padded_tables(thuff.decode_tables(lengths)),
                                                max_len))
    # each table entry's symbol is the reference decode's first symbol of a
    # one-word stream starting with that prefix
    k = min(max_len, tdec_ref.LUT_BITS)
    windows = (np.arange(1 << k, dtype=np.uint64) << np.uint64(32 - k)).astype(np.uint32)
    jargs = [jnp.asarray(_u32(jtables[0]))] + [jnp.asarray(t.numpy()) for t in jtables[1:]]
    first = np.asarray(jdec_ref.decode_chunks(
        jnp.asarray(windows), jnp.asarray(np.arange(1 << k, dtype=np.int32) * 32),
        *jargs, 1, max_len))[:, 0]
    hit = (got.numpy() & 63) > 0
    assert np.array_equal(got.numpy()[hit] >> 6, first[hit])


def test_total_bits_past_the_format_limit_raise():
    """Caveat: the format's bit offsets are int32, so the port refuses a
    stream of more than 2^31 - 1 bits instead of wrapping it."""
    freq = np.array([1 << 30, 1 << 30, 1 << 30], np.int64)
    with pytest.raises(ValueError, match="2147483647"):
        thuff.total_bits_of(freq, thuff.build_codebook(freq).lengths)
    plan = tapi.get_plan(tapi.make_spec(torch.zeros(4, dtype=torch.uint8), "huffman-bytes",
                                        backend="torch"))
    with pytest.raises(ValueError, match="int32"):
        CodebookBuild().host_apply(CallEnv(plan), {"freq": freq})
    limit = (1 << 31) - 1
    assert thuff.total_bits_of(np.array([limit, 0]), np.array([1, 0])) == limit


# ---------------------------------------------------------------------------
# bitstream
# ---------------------------------------------------------------------------


def _codes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 33, n).astype(np.int32)
    lengths[:3] = (32, 0, 1)[:n]
    codes = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)  # stray high bits
    return codes, lengths


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (3, 2049)])
def test_pack_bits_matches_reference(seed, n):
    codes, lengths = _codes(seed, n)
    total = int(lengths.astype(np.int64).sum())
    num_words = max(1, tbits.words_needed(total))
    want = np.asarray(jbits.pack_bits(jnp.asarray(codes), jnp.asarray(lengths), total, num_words))
    got = tbits.pack_bits(_tensor(codes.view(np.int32)), _tensor(lengths), num_words)
    assert np.array_equal(_u32(got), want)
    # unpack and read_window, past the end included
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1])]).astype(np.int32)
    want_u = np.asarray(jbits.unpack_bits(jnp.asarray(want), jnp.asarray(offsets),
                                          jnp.asarray(lengths)))
    got_u = tbits.unpack_bits(got, _tensor(offsets), _tensor(lengths))
    assert np.array_equal(_u32(got_u), want_u)
    probe = np.random.default_rng(seed).integers(0, 32 * num_words + 70, 64).astype(np.int32)
    want_w = np.asarray(jax.vmap(lambda o: jbits.read_window(jnp.asarray(want), o))(
        jnp.asarray(probe)))
    got_w = tbits.read_window(got, _tensor(probe))
    assert np.array_equal(got_w.numpy().astype(np.uint32), want_w)
    cum = np.asarray(jbits.exclusive_cumsum(jnp.asarray(lengths)))
    assert np.array_equal(tbits.exclusive_cumsum(_tensor(lengths)).numpy(), cum)


# ---------------------------------------------------------------------------
# kernel twins against the reference kernels (Pallas interpret) and refs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_bins,n", [(1, 7), (256, 300), (700, 513)])
def test_histogram_twin_matches_reference_kernel(num_bins, n):
    keys = np.random.default_rng(n).integers(0, num_bins, n).astype(np.int32)
    got = thist_ref.histogram(_tensor(keys), num_bins).numpy()
    assert np.array_equal(got, np.asarray(jhist_kernel.histogram(jnp.asarray(keys), num_bins,
                                                                  interpret=True)))
    assert np.array_equal(got, np.asarray(jhist_ref.histogram(jnp.asarray(keys), num_bins)))


def test_histogram_twin_counts_out_of_range_keys_nowhere():
    keys = np.array([-1, -2, 0, 1, 5, 2, 2], np.int32)
    got = thist_ref.histogram(_tensor(keys), 3).numpy()
    want = np.asarray(jhist_kernel.histogram(jnp.asarray(keys), 3, interpret=True))
    assert np.array_equal(got, want) and got.tolist() == [1, 1, 2]


@pytest.mark.parametrize("num_keys", [1, 300])
def test_encode_lookup_twin_matches_reference_kernel(num_keys):
    rng = np.random.default_rng(num_keys)
    codes_t = rng.integers(0, 1 << 32, num_keys, dtype=np.uint64).astype(np.uint32)
    lens_t = rng.integers(0, 33, num_keys).astype(np.int32)
    keys = rng.integers(0, num_keys, 411).astype(np.int32)
    got_c, got_l = tenc_ref.encode_lookup(_tensor(keys), _tensor(codes_t.view(np.int32)),
                                          _tensor(lens_t))
    for want_c, want_l in (
        jenc_kernel.encode_lookup(jnp.asarray(keys), jnp.asarray(codes_t), jnp.asarray(lens_t),
                                  interpret=True),
        jenc_ref.encode_lookup(jnp.asarray(keys), jnp.asarray(codes_t), jnp.asarray(lens_t)),
    ):
        assert np.array_equal(_u32(got_c), np.asarray(want_c))
        assert np.array_equal(got_l.numpy(), np.asarray(want_l))


def _reference_stream(keys: np.ndarray, chunk_size: int, freq=None):
    freq = np.bincount(keys, minlength=int(keys.max()) + 1) if freq is None else freq
    book = jhuff.build_codebook(freq)
    codes, lens = jenc_ref.encode_lookup(jnp.asarray(keys), jnp.asarray(book.codes),
                                         jnp.asarray(book.lengths))
    total = int(np.asarray(lens).astype(np.int64).sum())
    words, offsets, _ = jenc_ref.pack_stream(codes, lens, max(1, -(-total // 32)), chunk_size)
    return book, codes, lens, words, offsets


@pytest.mark.parametrize("case", ["skewed", "fibonacci-32"])
def test_pack_stream_twin_matches_reference(case):
    rng = np.random.default_rng(5)
    freq = None if case == "skewed" else _fibonacci(40)
    keys = (rng.zipf(1.4, 3001) % 50 if freq is None else rng.integers(0, 40, 3001))
    keys = keys.astype(np.int32)
    _, codes, lens, words, offsets = _reference_stream(keys, 256, freq)
    num_words = int(words.shape[0])
    got_w, got_o = tenc_ref.pack_stream(_tensor(np.asarray(codes).view(np.int32)),
                                        _tensor(np.asarray(lens)), num_words, 256)
    assert np.array_equal(_u32(got_w), np.asarray(words))
    assert np.array_equal(got_o.numpy(), np.asarray(offsets))


def test_pack_stream_kernel_wrapper_takes_the_plain_version_on_cpu():
    """A CPU tensor goes to the plain version, bit for bit, and launches
    nothing; the ``torch`` backend's op gives the same."""
    from repro_torch.core import adapters

    rng = np.random.default_rng(11)
    _, codes, lens, words, offsets = _reference_stream(
        (rng.zipf(1.4, 3001) % 50).astype(np.int32), 7)
    codes, lens = _tensor(np.asarray(codes).view(np.int32)), _tensor(np.asarray(lens))
    before = dict(tenc_kernel.launches)
    for pack in (tenc_kernel.pack_stream, adapters.dispatch("huffman_pack_stream", "torch")):
        got_w, got_o = pack(codes, lens, int(words.shape[0]), 7)
        assert np.array_equal(_u32(got_w), np.asarray(words))
        assert np.array_equal(got_o.numpy(), np.asarray(offsets))
    assert tenc_kernel.launches == before


def test_pack_stream_kernel_wrapper_empty_stream():
    empty = torch.zeros(0, dtype=torch.int32)
    before = dict(tenc_kernel.launches)
    words, offsets = tenc_kernel.pack_stream(empty, empty, 3, 4096)
    assert words.dtype == offsets.dtype == torch.int32
    assert words.tolist() == [0, 0, 0] and offsets.shape == (0,)
    assert tenc_kernel.launches == before


@pytest.mark.parametrize("codes,lens,num_words,chunk_size,error,match", [
    (torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.int32), 1, 4, TypeError,
     "codes has dtype"),
    (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int16), 1, 4, TypeError,
     "lens has dtype"),
    (torch.zeros(5, dtype=torch.int32), torch.ones(4, dtype=torch.int32), 1, 4, ValueError,
     "codes has shape"),
    (torch.zeros((2, 2), dtype=torch.int32), torch.ones((2, 2), dtype=torch.int32), 1, 4,
     ValueError, "lens has shape"),
    (torch.zeros(8, dtype=torch.int32)[::2], torch.ones(4, dtype=torch.int32), 1, 4,
     ValueError, "contiguous"),
    (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32), -1, 4, ValueError,
     "num_words"),
    (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32), 1, 0, ValueError,
     "chunk_size"),
])
def test_pack_stream_kernel_wrapper_checks_its_inputs(codes, lens, num_words, chunk_size, error,
                                                      match):
    with pytest.raises(error, match=match):
        tenc_kernel.pack_stream(codes, lens, num_words, chunk_size)


@pytest.mark.parametrize("case", ["skewed", "single-symbol", "fibonacci-32"])
def test_decode_chunks_twin_matches_reference_kernel(case):
    rng = np.random.default_rng(9)
    freq = {"skewed": None, "single-symbol": None, "fibonacci-32": _fibonacci(40)}[case]
    if case == "skewed":
        keys = (rng.zipf(1.4, 300) % 60).astype(np.int32)
    elif case == "single-symbol":
        keys = np.full(300, 4, np.int32)
    else:
        keys = rng.integers(0, 40, 300).astype(np.int32)
    book, _, _, words, offsets = _reference_stream(keys, 64, freq)
    tables = thuff.padded_tables(thuff.decode_tables(book.lengths))
    max_len = int(tables[0].shape[0]) - 1
    got = tdec_ref.decode_chunks(_tensor(np.asarray(words).view(np.int32)),
                                 _tensor(np.asarray(offsets)), *tables, 64, max_len).numpy()
    jt = jhuff.decode_tables(book.lengths)
    jargs = (words, offsets, jt.first_code, jt.count, jt.sym_offset, jt.sym_sorted, 64, max_len)
    # the whole (n_chunks, 64) output, padding symbols past the end included
    assert np.array_equal(got, np.asarray(jdec_kernel.decode_chunks(*jargs, interpret=True)))
    assert np.array_equal(got, np.asarray(jdec_ref.decode_chunks(*jargs)))
    assert np.array_equal(got.reshape(-1)[: keys.size], keys)


@pytest.mark.parametrize("seed", range(4))
def test_decode_chunks_by_jumps_equals_the_loop(seed, monkeypatch):
    """The pointer-doubling path of the plain decode (streams of at most
    JUMP_BITS bits) gives the loop's whole output, bit for bit: on random
    words (codes that match no length, cursors past the stream's end) and on
    a reference stream, whose symbols it also decodes."""
    rng = np.random.default_rng(40 + seed)
    freq = _fibonacci(40) if seed % 2 else rng.integers(1, 1000, int(rng.integers(2, 300)))
    lengths = thuff.build_codebook(np.asarray(freq, np.int64)).lengths
    tables = thuff.padded_tables(thuff.decode_tables(lengths))
    max_len = int(tables[0].shape[0]) - 1
    n_words = int(rng.integers(1, 2000))
    words = _tensor(rng.integers(-2**31, 2**31, n_words, dtype=np.int64).astype(np.int32))
    offsets = _tensor(np.sort(rng.integers(0, 32 * n_words + 300, 9)).astype(np.int32))
    keys = rng.integers(0, len(freq), 700).astype(np.int32)
    book, _, _, ref_words, ref_offsets = _reference_stream(keys, 100, np.asarray(freq, np.int64))
    ref_tables = thuff.padded_tables(thuff.decode_tables(book.lengths))
    ref_max_len = int(ref_tables[0].shape[0]) - 1
    cases = [(words, offsets, tables, 4096 >> seed, max_len),
             (_tensor(np.asarray(ref_words).view(np.int32)), _tensor(np.asarray(ref_offsets)),
              ref_tables, 100, ref_max_len)]
    assert all(32 * w.shape[0] <= tdec_ref.JUMP_BITS for w, *_ in cases)
    by_jumps = [tdec_ref.decode_chunks(w, o, *t, cs, ml) for w, o, t, cs, ml in cases]
    monkeypatch.setattr(tdec_ref, "JUMP_BITS", 0)
    for got, (w, o, t, cs, ml) in zip(by_jumps, cases):
        assert torch.equal(got, tdec_ref.decode_chunks(w, o, *t, cs, ml))
    assert np.array_equal(by_jumps[1].numpy().reshape(-1)[: keys.size], keys)


def test_huffman_module_round_trip_matches_reference():
    keys = (np.random.default_rng(2).zipf(1.3, 5000) % 300).astype(np.int32)
    want = jhuff.compress(jnp.asarray(keys), 300, chunk_size=512)
    got = thuff.compress(_tensor(keys), 300, chunk_size=512, adapter="torch")
    assert (got.total_bits, got.n_symbols, got.num_keys) == (
        want.total_bits, want.n_symbols, want.num_keys)
    assert np.array_equal(_u32(got.words), np.asarray(want.words))
    assert np.array_equal(got.chunk_offsets.numpy(), np.asarray(want.chunk_offsets))
    assert np.array_equal(got.length_table, want.length_table)
    assert np.array_equal(thuff.decompress(got, adapter="torch").numpy(), keys)


# ---------------------------------------------------------------------------
# containers: byte identity and cross-decoding
# ---------------------------------------------------------------------------

# every huffman / huffman-bytes case of tests/test_conformance.py
CONFORMANCE = [
    ("huffman", "int32", (1,)),
    ("huffman", "int32", (2049,)),
    ("huffman", "uint16", (31, 9)),
    ("huffman-bytes", "uint8", ()),
    ("huffman-bytes", "int16", (257,)),
    ("huffman-bytes", "float32", (5, 11)),
    ("huffman-bytes", "float64", (129,)),
]


def _data(method: str, dtype: str, shape: tuple) -> np.ndarray:
    rng = np.random.default_rng(abs(hash((method, dtype, shape))) % (1 << 32))
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.normal(size=shape) * 3).astype(dt)
    if method == "huffman":
        return np.minimum(np.abs(rng.normal(0, 9, shape)).astype(np.int64), 120).astype(dt)
    return rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, shape).astype(dt)


def _check_pair(tc: TCompressed, jc: JCompressed, arr: np.ndarray) -> None:
    """Same bytes; the port decodes the reference's stream and the reverse."""
    assert tc.to_bytes() == jc.to_bytes()
    port_of_ref = tapi.decompress_leaf(TCompressed.from_bytes(jc.to_bytes()), backend="torch")
    ref_of_port = japi.decompress_leaf(JCompressed.from_bytes(tc.to_bytes()))
    assert port_of_ref.shape == arr.shape
    got = port_of_ref.view(torch.uint16).numpy() if arr.dtype.name == "bfloat16" else (
        port_of_ref.numpy())
    want = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert ref_of_port.dtype == arr.dtype and np.array_equal(
        np.asarray(ref_of_port).reshape(-1).view(np.uint8), arr.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("method,dtype,shape", CONFORMANCE,
                         ids=[f"{m}-{d}-{'x'.join(map(str, s)) or '0d'}" for m, d, s in CONFORMANCE])
def test_conformance_cases_byte_identical_and_cross_decode(method, dtype, shape):
    arr = _data(method, dtype, shape)
    tc = tapi.compress_leaf(arr, method, backend="torch")
    jc = japi.compress_leaf(arr, method)
    assert tc.method == jc.method
    _check_pair(tc, jc, arr)


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64", "int64"])
def test_unsigned_keys_through_compress_byte_identical(dtype):
    """Satellite: uint16/uint32 (and uint64, recorded as uint32) keys."""
    keys = (np.random.default_rng(4).zipf(1.5, (40, 7)) % 900).astype(dtype)
    tc = tapi.compress(keys, "huffman", backend="torch")
    jc = japi.compress(keys, "huffman", backend="xla")
    assert tc.to_bytes() == jc.to_bytes()
    out = tapi.decompress(TCompressed.from_bytes(jc.to_bytes()), backend="torch")
    assert tapi.dtype_name(out) == jc.meta["dtype"]
    assert np.array_equal(out.to(torch.int64).numpy(), keys.astype(np.int64))
    assert np.array_equal(np.asarray(japi.decompress(JCompressed.from_bytes(tc.to_bytes()))),
                          np.asarray(japi.decompress(jc)))


def test_as_tensor_names_unsigned_dtypes():
    for dt in ("uint16", "uint32"):
        t = tapi.as_tensor(np.arange(6, dtype=dt))
        assert tapi.dtype_name(t) == dt and t.to(torch.int64).tolist() == list(range(6))
    t = tapi.as_tensor(np.array([1, (1 << 40) + 5], np.uint64))
    assert tapi.dtype_name(t) == "uint32" and t.to(torch.int64).tolist() == [1, 5]


@pytest.mark.parametrize("chunk_size", [64, 4096])
def test_chunk_size_parameter_byte_identical(chunk_size):
    keys = (np.random.default_rng(8).zipf(1.6, 3000) % 200).astype(np.int32)
    tspec = tapi.make_spec(keys, "huffman", backend="torch", chunk_size=chunk_size)
    jspec = japi.make_spec(jnp.asarray(keys), "huffman", backend="xla", chunk_size=chunk_size)
    assert tspec.params == jspec.params  # the default is canonicalised out
    tc, jc = tapi.encode(tspec, keys), japi.encode(jspec, jnp.asarray(keys))
    assert tc.to_bytes() == jc.to_bytes() and tc.meta["chunk_size"] == chunk_size
    assert np.array_equal(tapi.decode(jc, backend="torch").numpy(), keys)


def test_bfloat16_leaf_and_stream_byte_identical():
    rng = np.random.default_rng(11)
    arr = rng.normal(size=(17, 13)).astype(ml_dtypes.bfloat16)
    _check_pair(tapi.compress_leaf(arr, "huffman-bytes", backend="torch"),
                japi.compress_leaf(arr, "huffman-bytes"), arr)
    # compressed as bfloat16 directly: the reference decodes it on its host
    # fallback, the port on the device path; the bits agree
    tc = tapi.compress(torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16),
                       "huffman-bytes", backend="torch")
    jc = japi.compress(jnp.asarray(arr), "huffman-bytes", backend="xla")
    assert tc.to_bytes() == jc.to_bytes() and tc.meta["dtype"] == "bfloat16"
    out = tapi.decompress(TCompressed.from_bytes(jc.to_bytes()), backend="torch")
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.view(torch.uint16).numpy(), arr.view(np.uint16))


def test_empty_byte_stream_byte_identical():
    arr = np.zeros((0,), np.float32)
    tc = tapi.compress(arr, "huffman-bytes", backend="torch")
    jc = japi.compress(arr, "huffman-bytes", backend="xla")
    assert tc.to_bytes() == jc.to_bytes()
    assert tapi.decompress(jc, backend="torch").shape == (0,)


def test_stage_meta_matches_reference():
    keys = np.arange(50, dtype=np.int32) % 7
    for method in ("huffman", "huffman-bytes"):
        tc = tapi.compress(keys, method, backend="torch")
        jc = japi.compress(keys, method, backend="xla")
        assert json.dumps(tc.meta) == json.dumps(JCompressed.from_bytes(jc.to_bytes()).meta)
    bins = [s.get("num_bins", "-") for s in tc.meta["stages"] if s["stage"] == "huffman_histogram"]
    assert bins == [256]


# ---------------------------------------------------------------------------
# policy, registry, caveats, corruption, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values,dtype,want", [
    ([0, 5, 65535], "int32", "huffman"),
    ([0, 5, 65536], "int32", "huffman-bytes"),
    ([-1, 5, 9], "int16", "huffman-bytes"),
    ([1.5, 2.0, 3.0], "float32", "huffman-bytes"),
    ([3, 4, 5], "uint32", "huffman"),
])
def test_leaf_policy_routes_like_reference(values, dtype, want):
    arr = np.array(values, dtype)
    x, method, _ = tapi.leaf_policy(arr, "huffman")
    jx, jmethod, _ = japi.leaf_policy(arr, "huffman")
    assert method == jmethod == want
    assert tuple(x.shape) == jx.shape and tapi.dtype_name(x) == str(jx.dtype)
    assert np.array_equal(x.numpy(), jx)


def test_leaf_policy_of_unported_method_raises():
    # mgard-progressive, once the one method not ported, now takes the
    # reference's policy: floats to float32, > 4-D flattened
    for arr in (np.zeros(4, np.float16), np.zeros((1, 2, 1, 2, 2), np.float32)):
        x, method, _ = tapi.leaf_policy(arr, "mgard-progressive")
        jx, jmethod, _ = japi.leaf_policy(arr, "mgard-progressive")
        assert method == jmethod == "mgard-progressive"
        assert tapi.dtype_name(x) == str(jx.dtype) and tuple(x.shape) == jx.shape


def test_leaf_policy_routes_mgard_like_reference():
    arr = np.arange(12, dtype=np.float16).reshape(3, 4)
    x, method, _ = tapi.leaf_policy(arr, "mgard")
    jx, jmethod, _ = japi.leaf_policy(arr, "mgard")
    assert method == jmethod == "mgard"
    assert x.dtype == torch.float32 and np.array_equal(x.numpy(), jx)


@pytest.mark.parametrize("keys", [np.array([3, -1, 2], np.int32),
                                  np.array([3, 1 << 31, 2], np.uint32)])
def test_keys_that_do_not_round_trip_raise(keys):
    """Caveat: the reference folds negative keys (and uint32 keys of 2^31 or
    more, negative after its int32 cast) into bin 0; the port refuses them."""
    with pytest.raises(ValueError, match="huffman-bytes"):
        tapi.compress(keys, "huffman", backend="torch")


def test_float_data_to_huffman_raises():
    with pytest.raises(ValueError, match="integer keys"):
        tapi.compress(np.ones(4, np.float32), "huffman", backend="torch")


def _tamper(raw: bytes, key: str, value) -> TCompressed:
    c = TCompressed.from_bytes(raw)
    for s in c.meta["stages"]:
        if s["stage"] == "bit_pack":
            s["decode_index"][key] = value
    return c


@pytest.mark.parametrize("key", ["n_chunks", "chunk_size", "n_symbols"])
def test_tampered_decode_index_raises(key):
    keys = (np.arange(5000) % 11).astype(np.int32)
    raw = japi.compress(keys, "huffman", backend="xla").to_bytes()
    c = _tamper(raw, key, 3)
    with pytest.raises(ContainerError, match="decode_index"):
        tapi.decompress(c, backend="torch")
    c = TCompressed.from_bytes(raw)
    for s in c.meta["stages"]:
        s.pop("decode_index", None)
    assert tcodec.stream_decode_index(c) is None  # an older stream: geometry from meta
    assert np.array_equal(tapi.decompress(c, backend="torch").numpy(), keys)


def test_decode_tables_cache_is_a_fifo_of_eight():
    keys = (np.arange(3000) % 13).astype(np.int32)
    c = japi.compress(keys, "huffman", backend="xla")
    assert np.array_equal(tapi.decompress(c, backend="torch").numpy(), keys)
    plan = tapi.get_plan(tapi.make_spec(keys, "huffman", backend="torch"))
    lt = np.asarray(c.arrays["length_table"], np.int32)
    first = thuff.plan_decode_tables(plan, lt)  # the decode above cached it
    assert thuff.plan_decode_tables(plan, lt) is first
    for i in range(1, 10):
        thuff.plan_decode_tables(plan, np.concatenate([lt, np.full(i, 9, np.int32)]))
    cached = [k for k in plan.workspace if k.startswith("decode_tables:")]
    assert len(cached) == 8
    assert thuff.plan_decode_tables(plan, lt) is not first  # evicted first in, first out


def test_sections_to_encoded_decodes_and_bucket_key():
    keys = (np.arange(3000) * 7 % 23).astype(np.int32)
    c = TCompressed.from_bytes(japi.compress(keys, "huffman", backend="xla").to_bytes())
    enc = tcodec.sections_to_encoded(c)
    assert np.array_equal(thuff.decode(enc, adapter="torch").numpy(), keys)
    assert tcodec.entropy_bucket_key(c) == ("chunk_size", 4096)
