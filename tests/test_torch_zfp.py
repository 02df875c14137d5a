"""The port's ZFP slice against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages: the
reference's ``repro.core.zfp`` stages, its ``zfp_block`` kernel (Pallas in
interpret mode) and plain ``ref``, and ``repro.core.api`` with the ``xla``
backend; the port's plain PyTorch versions and ``backend="torch"``.
Tolerance: none.  Payload words, emax, container bytes and decoded floats
(compared as bit patterns) must be identical, special blocks included
(all-zero, subnormal, absmax below 2^-98, near FLT_MAX, inf and NaN).

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import api as japi
from repro.core import bitstream as jbits
from repro.core import zfp as jzfp
from repro.core.abstractions import pad_to_blocks as j_pad
from repro.core.container import Compressed as JCompressed
from repro.core.machine import block_view as j_block_view
from repro.core.machine import unblock_view as j_unblock_view
from repro.kernels.zfp_block import kernel as jkernel
from repro.kernels.zfp_block import ref as jref
from repro_torch.core import adapters
from repro_torch.core import api as tapi
from repro_torch.core import bitstream as tbits
from repro_torch.core import codecs as tcodecs
from repro_torch.core import zfp as tzfp
from repro_torch.core import zfp_tables
from repro_torch.core.abstractions import pad_to_blocks as t_pad
from repro_torch.core.container import Compressed as TCompressed
from repro_torch.core.machine import block_view as t_block_view
from repro_torch.core.machine import unblock_view as t_unblock_view
from repro_torch.kernels.zfp_block import kernel as tkernel
from repro_torch.kernels.zfp_block import ref as tref

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RATES = (1, 7, 16, 32)
TINY = np.finfo(np.float32).tiny


def _bits(a) -> np.ndarray:
    """32-bit values as their bit patterns (NaNs and signed zeros compare)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _blocks(dims: int, n: int, seed: int) -> np.ndarray:
    """Random blocks over a wide exponent range, then the special blocks."""
    rng = np.random.default_rng(seed)
    bs = 4 ** dims
    x = rng.normal(size=(n, bs)) * np.exp2(rng.integers(-30, 30, size=(n, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0                                                   # all zero
    x[1] = rng.uniform(-1, 1, bs).astype(np.float32) * TINY * 0.5  # subnormal
    x[2] = rng.normal(size=bs).astype(np.float32) * np.float32(2.0 ** -100)  # < 2^-98
    x[3] = rng.uniform(-1, 1, bs).astype(np.float32) * np.float32(3.4e38)  # ~FLT_MAX
    x[4, 0] = np.inf
    x[5, 1] = np.nan
    x[6, ::2] = TINY * 0.25                                     # normal + subnormal
    x[7] = -np.inf
    return x


def _field(shape: tuple, seed: int) -> np.ndarray:
    """A smooth field with noise, one special block's worth of values at
    each corner region (zero, subnormal, tiny, huge)."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 3, n) for n in shape], indexing="ij")
    f = np.sin(sum(grids)) + 0.05 * rng.normal(size=shape)
    f = f.astype(np.float32)
    flat = f.reshape(-1)
    k = min(16, flat.size // 8)
    flat[:k] = 0.0
    flat[k : 2 * k] = TINY * 0.5
    flat[2 * k : 3 * k] *= np.float32(2.0 ** -110)
    flat[-k:] *= np.float32(3e38)
    return f


def _int_field(shape: tuple, dtype, seed: int) -> np.ndarray:
    """Integers over the dtype's range (int32: values past 2^24 too, which
    round when cast to float32), with the type's minimum planted through
    the field: alone in a block, beside zeros and beside other values."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, size=shape, endpoint=True, dtype=np.int64)
    x = x >> rng.integers(0, 20 if info.bits > 16 else info.bits - 1, size=shape)
    x = x.astype(dtype)
    flat = x.reshape(-1)
    flat[::11] = info.min
    flat[:64] = info.min                         # whole blocks of the minimum
    flat[64:128] = 0
    flat[64:128:5] = info.min
    if info.bits == 32:
        flat[128:136] = ([2 ** 25 - 1, 2 ** 24 + 1, -(2 ** 31) + 1, 2 ** 31 - 1,
                          -(2 ** 31) + 100, 2 ** 31 - 100, 16777217, -16777217] if info.min
                         else [2 ** 32 - 1, 2 ** 25 - 1, 2 ** 24 + 1, 2 ** 31, 2 ** 32 - 100,
                               2 ** 31 - 1, 16777217, 0])
    return x


def _float_field(shape: tuple, dtype, seed: int) -> np.ndarray:
    """Values over a wide exponent range in ``dtype``, with blocks of the
    dtype's subnormals only, and subnormals beside normal values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-6, 4, size=shape)
    x = x.astype(dtype)
    tiny = float(ml_dtypes.finfo(dtype).smallest_subnormal)
    flat = x.reshape(-1)
    flat[:64] = (rng.integers(-40, 40, size=64) * tiny).astype(dtype)  # subnormal blocks
    flat[64:128:3] = (rng.integers(1, 9, size=22) * tiny).astype(dtype)
    return x


def _as_numpy(a) -> np.ndarray:
    """A decoded array of either package as numpy, bfloat16 as its bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


# ---------------------------------------------------------------------------
# scale tables
# ---------------------------------------------------------------------------


def test_scale_tables_equal_jnp_exp2_at_every_index():
    e = np.arange(zfp_tables.EMIN, zfp_tables.EMAX + 1, dtype=np.int32)
    enc = jax.jit(lambda e: jnp.exp2(30.0 - e.astype(jnp.float32)))(jnp.asarray(e))
    dec = jax.jit(lambda e: jnp.exp2(e.astype(jnp.float32) - 30.0))(jnp.asarray(e))
    np.testing.assert_array_equal(
        np.asarray(zfp_tables.ENC_SCALE_BITS, np.uint32), _bits(enc))
    np.testing.assert_array_equal(
        np.asarray(zfp_tables.DEC_SCALE_BITS, np.uint32), _bits(dec))


def test_scale_tables_saturate_so_clamping_is_exact():
    """Beyond the table the reference's values stay at the end values, so
    clamping any int32 emax into the table reproduces it."""
    far = jnp.asarray([-(2**31), -10**6, -1000, 1000, 10**6, 2**31 - 1], jnp.int32)
    enc = np.asarray(jnp.exp2(30.0 - far.astype(jnp.float32)))
    dec = np.asarray(jnp.exp2(far.astype(jnp.float32) - 30.0))
    enc_t = zfp_tables.scale_table(zfp_tables.ENC_SCALE_BITS)
    dec_t = zfp_tables.scale_table(zfp_tables.DEC_SCALE_BITS)
    idx = zfp_tables.table_index(torch.from_numpy(np.array(far)))
    np.testing.assert_array_equal(_bits(enc_t[idx]), _bits(enc))
    np.testing.assert_array_equal(_bits(dec_t[idx]), _bits(dec))


# ---------------------------------------------------------------------------
# stages, bit for bit on the same int32 input
# ---------------------------------------------------------------------------


def _ints(seed: int, shape: tuple) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
    q.reshape(-1)[:4] = [2**31 - 1, -(2**31), 0, -1]  # the wrap edges
    return q


def test_lifts_match_reference():
    q = _ints(1, (257, 4))
    np.testing.assert_array_equal(
        tzfp.fwd_lift_vec(torch.from_numpy(q)).numpy(),
        np.asarray(jzfp.fwd_lift_vec(jnp.asarray(q))))
    np.testing.assert_array_equal(
        tzfp.inv_lift_vec(torch.from_numpy(q)).numpy(),
        np.asarray(jzfp.inv_lift_vec(jnp.asarray(q))))


@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_block_transforms_match_reference(dims):
    q = _ints(dims, (5,) + (4,) * dims)
    fwd = np.asarray(jax.vmap(jzfp.fwd_transform)(jnp.asarray(q)))
    inv = np.asarray(jax.vmap(jzfp.inv_transform)(jnp.asarray(q)))
    np.testing.assert_array_equal(tzfp.fwd_transform(torch.from_numpy(q)).numpy(), fwd)
    np.testing.assert_array_equal(tzfp.inv_transform(torch.from_numpy(q)).numpy(), inv)


def test_negabinary_matches_reference():
    q = _ints(2, (1000,))
    u = np.asarray(jzfp.int_to_negabinary(jnp.asarray(q)))
    tu = tzfp.int_to_negabinary(torch.from_numpy(q))
    np.testing.assert_array_equal(_bits(tu), u)
    np.testing.assert_array_equal(
        tzfp.negabinary_to_int(tu).numpy(),
        np.asarray(jzfp.negabinary_to_int(jnp.asarray(u))))


@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_sequency_permutation_matches_reference(dims):
    np.testing.assert_array_equal(
        tzfp.sequency_permutation(dims), jzfp.sequency_permutation(dims))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("block_size", [4, 16, 64, 256])
def test_bitplane_pack_unpack_match_reference(block_size, rate):
    u = _ints(rate, (6, block_size))
    ju = jnp.asarray(u).view(jnp.uint32)
    words = np.asarray(jzfp.pack_bitplanes(ju, rate))
    tw = tzfp.pack_bitplanes(torch.from_numpy(u), rate)
    np.testing.assert_array_equal(_bits(tw), words)
    assert tw.shape[-1] == tzfp.words_per_block(block_size, rate)
    back = np.asarray(jzfp.unpack_bitplanes(jnp.asarray(words), rate, block_size))
    np.testing.assert_array_equal(
        _bits(tzfp.unpack_bitplanes(tw, rate, block_size)), back)


def test_bitstream_words_match_reference():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(9, 32)).astype(np.uint32)
    words = np.asarray(jbits.bits_to_words(jnp.asarray(bits)))
    tw = tbits.bits_to_words(torch.from_numpy(bits.astype(np.int32)))
    np.testing.assert_array_equal(_bits(tw), words)
    np.testing.assert_array_equal(tbits.words_to_bits(tw).numpy(), bits)
    assert tbits.words_needed(65) == jbits.words_needed(65) == 3


def test_fixed_point_steps_match_reference():
    x = _blocks(2, 12, seed=9)
    xf = tzfp.flush_subnormal(torch.from_numpy(x))
    emax = tzfp.block_emax(xf)
    jemax = np.asarray(jax.vmap(jzfp.block_emax)(jnp.asarray(x)))
    np.testing.assert_array_equal(emax.numpy(), jemax)
    enc = zfp_tables.scale_table(zfp_tables.ENC_SCALE_BITS)
    dec = zfp_tables.scale_table(zfp_tables.DEC_SCALE_BITS)
    q = tzfp.to_fixed_point(xf, emax, enc)
    jq = np.asarray(jax.vmap(jzfp.to_fixed_point)(jnp.asarray(x), jnp.asarray(jemax)))
    np.testing.assert_array_equal(q.numpy(), jq)
    back = tzfp.from_fixed_point(q, emax, dec)
    jback = np.asarray(jax.vmap(jzfp.from_fixed_point)(jnp.asarray(jq), jnp.asarray(jemax)))
    np.testing.assert_array_equal(_bits(back), _bits(jback))


@pytest.mark.parametrize("shape", [(10,), (5, 7), (3, 5, 6), (2, 3, 5, 6)])
def test_block_helpers_match_reference(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    block = (4,) * len(shape)
    jp = j_pad(jnp.asarray(x), block)
    tp = t_pad(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jb, jc = j_block_view(jp, block)
    tb, tc = t_block_view(tp, block)
    assert tc == jc
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        t_unblock_view(tb, tc, block).numpy(), np.asarray(j_unblock_view(jb, jc, block)))


# ---------------------------------------------------------------------------
# the kernel's plain version against the reference kernel and its ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_plain_kernel_matches_reference_kernel(dims, rate):
    x = _blocks(dims, 13, seed=10 * dims + rate)
    kp, ke = jkernel.compress_blocks(jnp.asarray(x), rate, dims, interpret=True)
    rp, re_ = jref.compress_blocks(jnp.asarray(x), rate, dims)
    tp, te = tref.compress_blocks(torch.from_numpy(x), rate, dims)
    for p, e in ((kp, ke), (rp, re_)):
        np.testing.assert_array_equal(_bits(tp), np.asarray(p))
        np.testing.assert_array_equal(te.numpy(), np.asarray(e))
    kd = jkernel.decompress_blocks(kp, ke, rate, dims, interpret=True)
    rd = jref.decompress_blocks(rp, re_, rate, dims)
    td = tref.decompress_blocks(tp, te, rate, dims)
    for d in (kd, rd):
        np.testing.assert_array_equal(_bits(td), _bits(d))


def test_plain_kernel_chunking_is_invisible():
    x = torch.from_numpy(_blocks(3, 23, seed=4))
    p1, e1 = tref.compress_blocks(x, 16, 3)
    p2, e2 = tref.compress_blocks(x, 16, 3, chunk=5)
    assert torch.equal(p1, p2) and torch.equal(e1, e2)
    d1 = tref.decompress_blocks(p1, e1, 16, 3)
    d2 = tref.decompress_blocks(p1, e1, 16, 3, chunk=4)
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32))


def test_kernel_wrapper_takes_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_blocks(2, 9, seed=2))
    before = dict(tkernel.launches)
    p, e = tkernel.compress_blocks(x, 7, 2)
    rp, re_ = tref.compress_blocks(x, 7, 2)
    assert torch.equal(p, rp) and torch.equal(e, re_)
    d = tkernel.decompress_blocks(p, e, 7, 2)
    assert torch.equal(d.view(torch.int32), tref.decompress_blocks(p, e, 7, 2).view(torch.int32))
    assert tkernel.launches == before  # no kernel ran


# ---------------------------------------------------------------------------
# the field form: the padded field where it lies, rows in block order
# ---------------------------------------------------------------------------

FIELD_SHAPES = {1: (37,), 2: (9, 14), 3: (5, 7, 10), 4: (3, 6, 5, 7)}


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_plain_field_form_is_block_view_then_plain_blocks(dims, rate):
    x = _field(FIELD_SHAPES[dims], seed=dims * rate)
    block = (4,) * dims
    padded = t_pad(torch.from_numpy(x), block)
    assert tuple(padded.shape) != x.shape  # the shapes need padding
    p, e = tref.compress_field(padded, rate, dims)
    blocks, counts = t_block_view(padded, block)
    bp, be = tref.compress_blocks(blocks.reshape(blocks.shape[0], -1), rate, dims)
    assert torch.equal(p, bp) and torch.equal(e, be)
    jb, _ = j_block_view(j_pad(jnp.asarray(x), block), block)
    jp, je = jref.compress_blocks(jb.reshape(jb.shape[0], -1), rate, dims)
    np.testing.assert_array_equal(_bits(p), np.asarray(jp))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    d = tref.decompress_field(p, e, rate, dims, tuple(padded.shape))
    bd = tref.decompress_blocks(bp, be, rate, dims)
    want = t_unblock_view(bd.reshape((-1,) + block), counts, block)
    assert tuple(d.shape) == tuple(padded.shape)
    assert torch.equal(d.view(torch.int32), want.view(torch.int32))
    jd = jref.decompress_blocks(jp, je, rate, dims)
    np.testing.assert_array_equal(
        _bits(d), _bits(j_unblock_view(jd.reshape((-1,) + block), counts, block)))


@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_kernel_compiled_permutation_is_the_sequency_permutation(dims):
    np.testing.assert_array_equal(tkernel.kernel_permutation(dims),
                                  tzfp.sequency_permutation(dims))


@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_cuda_path_hands_the_padded_field_to_the_kernel(monkeypatch, dims):
    """With the cuda wrappers replaced by recorders, core/zfp.py passes the
    padded field itself and gets the field back, calling no block view."""
    seen = {}

    def fake_compress(padded, rate, d, *, perm, scale, emax=None):
        seen["field"], seen["emax"] = padded, emax
        return tref.compress_field(padded, rate, d, perm=perm, scale=scale, emax=emax)

    def fake_decompress(payload, emax, rate, d, padded_shape, *, perm, scale):
        seen["shape"] = tuple(padded_shape)
        return tref.decompress_field(payload, emax, rate, d, padded_shape, perm=perm,
                                     scale=scale)

    def no_view(*args, **kwargs):
        raise AssertionError("the cuda ZFP path called a block view")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(adapters._REGISTRY, ("zfp_field_compress", "cuda"), fake_compress)
    monkeypatch.setitem(adapters._REGISTRY, ("zfp_field_decompress", "cuda"), fake_decompress)
    import repro_torch.core.machine as tmachine
    for mod in (tmachine, tzfp):
        for name in ("block_view", "unblock_view"):
            monkeypatch.setattr(mod, name, no_view, raising=False)

    x = _field(FIELD_SHAPES[dims], seed=3)
    tables = tref.default_tables(dims, "cpu")
    payload, emax = tzfp.compress_field(torch.from_numpy(x), 16, dims, x.shape, "cuda",
                                        perm=tables["perm"], scale=tables["enc_scale"])
    padded = t_pad(torch.from_numpy(x), (4,) * dims)
    assert torch.equal(seen["field"], padded) and seen["field"].is_contiguous()
    assert seen["emax"] is None  # float32 data: the kernel takes its own exponents
    out = tzfp.decompress_field(payload, emax, 16, dims, x.shape, "cuda",
                                perm=tables["perm"], scale=tables["dec_scale"])
    assert seen["shape"] == tuple(padded.shape)
    assert tuple(out.shape) == x.shape
    monkeypatch.undo()
    want = tapi.decompress(tapi.compress(x, "zfp", rate=16, backend="torch"), backend="torch")
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_cuda_path_aligns_a_misaligned_field(monkeypatch):
    """The kernel's bulk copies need a 16-byte aligned base: a field view
    that starts elsewhere reaches the kernel as an aligned copy."""
    seen = {}

    def fake_compress(padded, rate, d, *, perm, scale, emax=None):
        seen["ptr"] = padded.data_ptr()
        return tref.compress_field(padded, rate, d, perm=perm, scale=scale, emax=emax)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(adapters._REGISTRY, ("zfp_field_compress", "cuda"), fake_compress)
    x = _field((8, 12), seed=4)
    view = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(np.float32))[1:]
    assert view.data_ptr() % 16
    tables = tref.default_tables(2, "cpu")
    p, e = tzfp.compress_field(view, 9, 2, x.shape, "cuda",
                               perm=tables["perm"], scale=tables["enc_scale"])
    assert seen["ptr"] % 16 == 0
    rp, re_ = tref.compress_field(torch.from_numpy(x), 9, 2)
    assert torch.equal(p, rp) and torch.equal(e, re_)


def test_cuda_path_hands_integer_fields_the_reference_exponents(monkeypatch):
    """Signed integer data reaches the kernel as its float32 cast, with the
    reference's block exponents (the type's minimum left out), which the
    kernel would not take of the cast."""
    seen = {}

    def fake_compress(padded, rate, d, *, perm, scale, emax=None):
        seen["field"], seen["emax"] = padded, emax
        return tref.compress_field(padded, rate, d, perm=perm, scale=scale, emax=emax)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(adapters._REGISTRY, ("zfp_field_compress", "cuda"), fake_compress)
    x = _int_field((9, 10, 7), np.int32, seed=6)
    tables = tref.default_tables(3, "cpu")
    p, e = tzfp.compress_field(torch.from_numpy(x), 16, 3, x.shape, "cuda",
                               perm=tables["perm"], scale=tables["enc_scale"])
    assert seen["field"].dtype == torch.float32 and seen["emax"].dtype == torch.int32
    jblocks, _ = j_block_view(j_pad(jnp.asarray(x), (4, 4, 4)), (4, 4, 4))
    want = np.asarray(jax.vmap(jzfp.block_emax)(jblocks))
    np.testing.assert_array_equal(seen["emax"].numpy(), want)
    # the float32 cast alone would give other exponents (its minimum counts)
    assert not np.array_equal(want, tref.compress_field(seen["field"], 16, 3)[1].numpy())
    tc = tapi.compress(x, "zfp", rate=16, backend="torch")
    assert torch.equal(p, torch.from_numpy(tc.arrays["payload"].view(np.int32)).reshape(p.shape))
    assert torch.equal(e, torch.from_numpy(tc.arrays["emax"]))


def test_kernel_field_wrapper_takes_plain_version_for_cpu_tensors():
    padded = t_pad(torch.from_numpy(_field((9, 10, 11), seed=8)), (4, 4, 4))
    before = dict(tkernel.launches)
    p, e = tkernel.compress_field(padded, 7, 3)
    rp, re_ = tref.compress_field(padded, 7, 3)
    assert torch.equal(p, rp) and torch.equal(e, re_)
    d = tkernel.decompress_field(p, e, 7, 3, tuple(padded.shape))
    rd = tref.decompress_field(p, e, 7, 3, tuple(padded.shape))
    assert torch.equal(d.view(torch.int32), rd.view(torch.int32))
    assert tkernel.launches == before  # no kernel ran


def test_plain_decode_inverts_the_given_permutation():
    """decompress_blocks inverts whatever perm it is handed (on its device)."""
    x = torch.from_numpy(_blocks(2, 9, seed=12))
    tables = tref.default_tables(2, "cpu")
    perm = torch.flip(tables["perm"], [0]).contiguous()
    p, e = tref.compress_blocks(x, 32, 2, perm=perm)
    d = tref.decompress_blocks(p, e, 32, 2, perm=perm)
    want = tref.decompress_blocks(*tref.compress_blocks(x, 32, 2), 32, 2)
    assert torch.equal(d.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the slice end to end: containers byte-identical, cross-decode bit-identical
# ---------------------------------------------------------------------------

SHAPES = [(1001,), (33, 47), (13, 17, 9), (5, 6, 7, 9)]


def _cross_decode(jc: JCompressed, tc: TCompressed) -> None:
    ref_out = np.asarray(japi.decode(jc, backend="xla"))
    port_of_ref = tapi.decode(TCompressed.from_bytes(jc.to_bytes()), backend="torch")
    ref_of_port = japi.decode(JCompressed.from_bytes(tc.to_bytes()), backend="xla")
    assert port_of_ref.dtype == torch.float32
    assert tuple(port_of_ref.shape) == ref_out.shape
    np.testing.assert_array_equal(_bits(port_of_ref), _bits(ref_out))
    np.testing.assert_array_equal(_bits(ref_of_port), _bits(ref_out))
    # the port's container built straight from the reference's numpy sections
    from_sections = tapi.decode(
        TCompressed(jc.method, dict(jc.meta), {k: np.asarray(v) for k, v in jc.arrays.items()}),
        backend="torch",
    )
    np.testing.assert_array_equal(_bits(from_sections), _bits(ref_out))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_compress_bytes_identical_and_cross_decode(shape, rate):
    x = _field(shape, seed=rate)
    jc = japi.compress(x, "zfp", rate=rate, backend="xla")
    tc = tapi.compress(x, "zfp", rate=rate, backend="torch")
    assert tc.to_bytes() == jc.to_bytes()
    assert list(tc.meta) == ["shape", "dtype", "rate", "stages"]
    _cross_decode(jc, tc)


@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_special_blocks_bytes_identical(dims):
    blocks = _blocks(dims, 8, seed=dims)
    x = blocks.reshape((8 * 4,) + (4,) * (dims - 1))  # field blocks = rows
    for rate in (7, 32):
        jc = japi.compress(x, "zfp", rate=rate, backend="xla")
        tc = tapi.compress(x, "zfp", rate=rate, backend="torch")
        assert tc.to_bytes() == jc.to_bytes()
        _cross_decode(jc, tc)


def test_float64_input_recorded_as_float32():
    x = _field((20, 30), seed=3).astype(np.float64) * (1 + 1e-12)
    jc = japi.compress(x, "zfp", rate=9, backend="xla")
    tc = tapi.compress(x, "zfp", rate=9, backend="torch")
    assert tc.meta["dtype"] == "float32"
    assert tc.to_bytes() == jc.to_bytes()
    tc_t = tapi.compress(torch.from_numpy(x), "zfp", rate=9, backend="torch")
    assert tc_t.to_bytes() == jc.to_bytes()


@pytest.mark.parametrize("shape", [(37, 50), (4096,), (3, 5, 7)])
def test_compress_leaf_bytes_identical(shape):
    x = _field(shape, seed=11)
    jc = japi.compress_leaf(x, "zfp", rate=12, backend="xla")
    tc = tapi.compress_leaf(x, "zfp", rate=12, backend="torch")
    assert tc.to_bytes() == jc.to_bytes()
    tc_t = tapi.compress_leaf(torch.from_numpy(x), "zfp", rate=12, backend="torch")
    assert tc_t.to_bytes() == jc.to_bytes()
    ref = japi.decompress_leaf(jc)
    got = tapi.decompress_leaf(TCompressed.from_bytes(jc.to_bytes()), backend="torch")
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_leaf_policy_casts_float16_like_reference():
    with np.errstate(over="ignore"):  # the huge corner becomes inf in float16
        x = _field((40, 40), seed=6).astype(np.float16)
    jc = japi.compress_leaf(x, "zfp", rate=16, backend="xla")
    tc = tapi.compress_leaf(x, "zfp", rate=16, backend="torch")
    assert tc.to_bytes() == jc.to_bytes()
    got = tapi.decompress_leaf(tc, backend="torch")
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), japi.decompress_leaf(jc))


ZFP_DTYPE_CASES = {  # name: (make, meta dtype the reference records)
    "float16": (lambda: _float_field((13, 17, 9), np.float16, 1), "float16"),
    "float16 2-D": (lambda: _float_field((33, 47), np.float16, 2), "float16"),
    "bfloat16": (lambda: _float_field((13, 17, 9), ml_dtypes.bfloat16, 3), "bfloat16"),
    "float64": (lambda: _field((13, 17, 9), 4).astype(np.float64) * (1 + 1e-9), "float32"),
    "int32": (lambda: _int_field((13, 17, 9), np.int32, 5), "int32"),
    "int32 1-D": (lambda: _int_field((1001,), np.int32, 6), "int32"),
    "int16": (lambda: _int_field((13, 17, 9), np.int16, 7), "int16"),
    "int8": (lambda: _int_field((33, 47), np.int8, 8), "int8"),
    "int64": (lambda: _int_field((13, 17, 9), np.int32, 9).astype(np.int64), "int32"),
    "uint8": (lambda: _int_field((33, 47), np.uint8, 10), "uint8"),
    "uint16": (lambda: _int_field((13, 17, 9), np.uint16, 11), "uint16"),
    "uint32": (lambda: _int_field((13, 17, 9), np.uint32, 12), "uint32"),
    "bool": (lambda: np.random.default_rng(13).random((33, 47)) < 0.3, "bool"),
}


@pytest.mark.parametrize("case", sorted(ZFP_DTYPE_CASES))
def test_compress_dtypes_bytes_identical_and_cross_decode(case):
    """Every dtype the reference compresses: the same container bytes, and
    each package decodes the other's stream to the same values, in the
    recorded dtype (float16/bfloat16 subnormals, the int32 minimum and
    int32 values past 2^24 included)."""
    make, dtype = ZFP_DTYPE_CASES[case]
    x = make()
    for rate in (7, 16):
        jc = japi.compress(x, "zfp", rate=rate, backend="xla")
        tc = tapi.compress(x, "zfp", rate=rate, backend="torch")
        assert tc.meta["dtype"] == jc.meta["dtype"] == dtype
        assert tc.to_bytes() == jc.to_bytes()
        ref_out = _as_numpy(japi.decode(jc, backend="xla"))
        outs = {
            "port": tapi.decode(tc, backend="torch"),
            "ref->port": tapi.decode(TCompressed.from_bytes(jc.to_bytes()), backend="torch"),
            "port->ref": japi.decode(JCompressed.from_bytes(tc.to_bytes()), backend="xla"),
        }
        for name, out in outs.items():
            out = _as_numpy(out)
            assert out.dtype == ref_out.dtype and out.shape == x.shape, name
            np.testing.assert_array_equal(out.view(np.uint8), ref_out.view(np.uint8), name)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.uint8])
def test_compress_leaf_integer_leaf_bytes_identical(dtype):
    """``leaf_policy`` passes integer leaves to ZFP uncast."""
    x = _int_field((37, 50), dtype, seed=14)
    jc = japi.compress_leaf(x, "zfp", rate=12, backend="xla")
    tc = tapi.compress_leaf(x, "zfp", rate=12, backend="torch")
    assert tc.to_bytes() == jc.to_bytes()
    for got in (tapi.decompress_leaf(TCompressed.from_bytes(jc.to_bytes()), backend="torch"),
                torch.from_numpy(np.asarray(
                    japi.decompress_leaf(JCompressed.from_bytes(tc.to_bytes()))))):
        want = np.asarray(japi.decompress_leaf(jc))
        assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.int8])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_integer_block_emax_matches_reference(dtype, dims):
    shape = {1: (1001,), 2: (33, 47), 3: (13, 17, 9)}[dims]
    x = _int_field(shape, dtype, seed=dims)
    padded = j_pad(jnp.asarray(x), (4,) * dims)
    jblocks, _ = j_block_view(padded, (4,) * dims)
    want = np.asarray(jax.vmap(jzfp.block_emax)(jblocks))
    got = tzfp.integer_block_emax(torch.from_numpy(np.array(padded)), dims)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int32", "int16", "int8", "uint8",
                                   "uint16", "uint32", "bool"])
def test_float32_to_converts_like_xla(dtype):
    """The decoded values' cast: round to nearest even, truncate and
    saturate, NaN to 0, subnormals as zero for bool."""
    from repro_torch.core.stages.library import float32_to

    v = np.array([np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, 2.5, -2.5, 3.5, 0.49,
                  -0.7, 65504, 65520, 1e5, -1e5, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 128, 4e9,
                  5e9, -1.0,
                  300, -300, 40000, 70000, 6e-8, 2e-8, 3e-8, 1e-39, -1e-39, 2.0 ** -133, 0.0,
                  -0.0, 255.9, 256.0, -128.5, 127.5], np.float32)
    want = _as_numpy(jax.jit(lambda a: a.astype(jnp.dtype(dtype)))(jnp.asarray(v)))
    got = _as_numpy(float32_to(torch.from_numpy(v), getattr(torch, dtype)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_plans_are_cached_and_profiled():
    x = _field((16, 16, 16), seed=1)
    spec = tapi.make_spec(torch.from_numpy(x), "zfp", rate=8, backend="torch")
    assert tapi.get_plan(spec) is tapi.get_plan(spec)
    assert spec.key() == ("zfp", (16, 16, 16), "float32", (("backend", "torch"), ("rate", 8)))
    c, prof, transfers = tapi.encode_profiled(spec, x)
    assert set(prof) == {"stage_in", "zfp_block_transform", "fetch"}
    assert transfers.as_dict() == {"h2d_bytes": 0, "d2h_bytes": 0}  # CPU plan
    out, dprof, _ = tapi.decode_profiled(c, backend="torch")
    assert set(dprof) == {"stage_in", "invert[zfp_block_transform]"}
    np.testing.assert_array_equal(_bits(out), _bits(tapi.decompress(c, backend="torch")))


# ---------------------------------------------------------------------------
# no fallback, nothing not yet ported, no JAX in the port
# ---------------------------------------------------------------------------


def test_auto_and_cuda_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _field((8, 8), seed=0)
    for backend in (None, "auto", "cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            tapi.compress(x, "zfp", backend=backend)
    c = tapi.compress(x, "zfp", backend="torch")
    for backend in (None, "auto", "cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            tapi.decode(c, backend=backend)


def test_dispatch_raises_for_a_missing_cuda_kernel(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    adapters.register("probe_only_torch", adapters.TORCH)(lambda: None)
    with pytest.raises(NotImplementedError, match="cuda"):
        adapters.dispatch("probe_only_torch", "cuda")
    assert adapters.dispatch("zfp_block_compress", "cuda") is tkernel.compress_blocks


def test_kernel_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkernel.compress_blocks(torch.zeros((2, 16), device="meta"), 8, 2)


@pytest.mark.parametrize("method", ["mgard-progressive"])
def test_unported_methods_raise(method):
    # every method of the reference is ported now: it is registered, and a
    # name the registry does not hold raises
    assert tcodecs.get_codec(method).name == method
    with pytest.raises(ValueError, match="unknown method"):
        tcodecs.get_codec(method + "-unknown")


def test_mgard_is_registered():
    assert "mgard" in tcodecs.available_methods()
    assert tcodecs.get_codec("mgard").name == "mgard"


@pytest.mark.parametrize("method", ["huffman", "huffman-bytes"])
def test_huffman_methods_are_registered(method):
    assert method in tcodecs.available_methods()
    assert tcodecs.get_codec(method).name == method


def test_invalid_zfp_specs_raise():
    with pytest.raises(ValueError, match="rate"):
        tapi.compress(np.zeros((8, 8), np.float32), "zfp", rate=33, backend="torch")
    with pytest.raises(ValueError, match="1-4"):
        tapi.compress(np.zeros((4,) * 5, np.float32), "zfp", backend="torch")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = {
        str(f.relative_to(ROOT)): name
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    }
    assert not bad, bad
