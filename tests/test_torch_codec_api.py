"""The port's standalone codec API against the JAX reference, on the CPU:
``zfp.compress``/``decompress`` and ``mgard.compress``/``decompress`` (the
whole-array paths beside the codec registry), ``quantize``/``dequantize``,
``huffman.histogram``, ``symbol_lengths_total``, the ``huffman_pack_stream``
op, ``DeviceExecutor.map`` and the engine's data mesh.

Inputs come from numpy with a seed.  Tolerance: none for ZFP (payload words,
emax and decoded floats as bit patterns), the quantizer, the histogram, the
bit total and the packed stream.  MGARD decomposes in floating point, so it
is held to its absolute error bound, to the port's own ``mgard`` codec
container (sections equal), and to cross-decoding within the bound both ways;
its compression ratio to the reference's within 1e-3 (a stream may differ by
a word where a coefficient rounds the other way).  A float64, int64 or
uint64 input keeps its dtype in the record, and so its itemsize in the
ratio, and decodes as the 32-bit type, in both packages.
"""

import warnings

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import huffman as jhuff
from repro.core import mgard as jmgard
from repro.core import quantize as jq
from repro.core import zfp as jzfp
from repro.kernels.huffman_encode import ops as jenc_ops
from repro.runtime.executor import DeviceExecutor as JExecutor
from repro_torch.core import api as tapi
from repro_torch.core import huffman as thuff
from repro_torch.core import mgard as tmgard
from repro_torch.core import quantize as tq
from repro_torch.core import zfp as tzfp
from repro_torch.kernels.huffman_encode import ops as tenc_ops
from repro_torch.runtime.executor import DeviceExecutor as TExecutor
from conftest import smooth_field_3d

ROOT = Path(__file__).resolve().parents[1]
ZFP_SHAPES = {1: (37,), 2: (9, 10), 3: (9, 10, 11), 4: (5, 6, 7, 9)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


def _field(shape, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * 10).astype(np.float32)


# ---------------------------------------------------------------------------
# ZFP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [1, 8, 16, 32])
@pytest.mark.parametrize("dims", [1, 2, 3, 4])
def test_zfp_compress_byte_identical_and_cross_decodes(dims, rate):
    x = _field(ZFP_SHAPES[dims], seed=dims)
    t = tzfp.compress(torch.from_numpy(x), rate=rate)
    j = jzfp.compress(jnp.asarray(x), rate=rate)
    np.testing.assert_array_equal(_bits(t.payload), np.asarray(j.payload))
    np.testing.assert_array_equal(t.emax.numpy(), np.asarray(j.emax))
    assert (t.shape, t.rate, t.dtype, t.dims) == (j.shape, j.rate, j.dtype, j.dims)
    assert t.nbytes() == j.nbytes()
    assert tzfp.compression_ratio(t) == jzfp.compression_ratio(j)
    tout = tzfp.decompress(t)
    np.testing.assert_array_equal(_bits(tout), _bits(np.asarray(jzfp.decompress(j))))
    # cross-decode through numpy, both ways
    from_j = tzfp.ZFPCompressed(
        payload=torch.from_numpy(np.asarray(j.payload).view(np.int32).copy()),
        emax=torch.from_numpy(np.asarray(j.emax).copy()), shape=j.shape, rate=j.rate)
    np.testing.assert_array_equal(_bits(tzfp.decompress(from_j)), _bits(tout))
    from_t = jzfp.ZFPCompressed(payload=jnp.asarray(t.payload.numpy().view(np.uint32)),
                                emax=jnp.asarray(t.emax.numpy()), shape=t.shape, rate=t.rate)
    np.testing.assert_array_equal(_bits(np.asarray(jzfp.decompress(from_t))), _bits(tout))


@pytest.mark.parametrize("dtype", ["float16", "int16"])
def test_zfp_compress_other_dtypes_byte_identical(dtype):
    x = _field((9, 10, 11), seed=7).astype(dtype)
    t = tzfp.compress(torch.from_numpy(x), rate=12)
    j = jzfp.compress(jnp.asarray(x), rate=12)
    np.testing.assert_array_equal(_bits(t.payload), np.asarray(j.payload))
    np.testing.assert_array_equal(t.emax.numpy(), np.asarray(j.emax))
    assert t.dtype == j.dtype == dtype
    np.testing.assert_array_equal(_bits(tzfp.decompress(t)),
                                  _bits(np.asarray(jzfp.decompress(j))))


def _wide(dtype: str, shape, seed=11) -> np.ndarray:
    """A seeded numpy array of a 64-bit ``dtype``, as a user hands one in."""
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        return rng.normal(size=shape) * 10
    lo = -1000 if dtype == "int64" else 0
    return rng.integers(lo, lo + 2000, shape).astype(dtype)


def _ref(fn, *args, **kw):
    with warnings.catch_warnings():  # JAX warns as it narrows a 64-bit array
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kw)


@pytest.mark.parametrize("dtype", ["float64", "int64", "uint64"])
def test_zfp_standalone_64_bit_input_records_its_dtype(dtype):
    """The record keeps the input's dtype, so the ratio counts its 8 bytes a
    value; the payload is the 32-bit array's and decodes as the 32-bit type."""
    x = _wide(dtype, ZFP_SHAPES[3])
    t = tzfp.compress(x, rate=16, device="cpu")
    j = _ref(jzfp.compress, x, rate=16)
    assert t.dtype == j.dtype == dtype
    np.testing.assert_array_equal(_bits(t.payload), np.asarray(j.payload))
    np.testing.assert_array_equal(t.emax.numpy(), np.asarray(j.emax))
    narrow = tzfp.compress(torch.from_numpy(x).to(getattr(torch, f"{dtype[:-2]}32")), rate=16)
    assert torch.equal(narrow.payload, t.payload) and torch.equal(narrow.emax, t.emax)
    assert tzfp.compression_ratio(t) == jzfp.compression_ratio(j)
    assert tzfp.compression_ratio(t) == 2 * tzfp.compression_ratio(narrow)
    tout, jout = tzfp.decompress(t), np.asarray(_ref(jzfp.decompress, j))
    assert str(tout.dtype) == f"torch.{jout.dtype}" == f"torch.{dtype[:-2]}32"
    np.testing.assert_array_equal(_bits(tout), _bits(jout))


@pytest.mark.parametrize("dtype", ["float64", "int64", "uint64"])
def test_mgard_standalone_64_bit_input_records_its_dtype(dtype):
    x = _wide(dtype, (17, 9, 5), seed=12)
    t = tmgard.compress(x, 1e-2, device="cpu")
    j = _ref(jmgard.compress, x, 1e-2)
    assert t.dtype == j.dtype == dtype
    assert tmgard.compression_ratio(t) == x.size * 8 / t.nbytes()
    assert tmgard.compression_ratio(t) == pytest.approx(jmgard.compression_ratio(j), rel=1e-3)
    tout, jout = tmgard.decompress(t), np.asarray(_ref(jmgard.decompress, j))
    assert str(tout.dtype) == f"torch.{jout.dtype}" == f"torch.{dtype[:-2]}32"
    # an integer record truncates the decoded floats: within the bound plus one
    slack = 1e-2 if dtype == "float64" else 1.0 + 1e-2
    assert np.abs(tout.numpy().astype(np.float64) - x).max() <= slack
    assert np.abs(jout.astype(np.float64) - x).max() <= slack


def test_zfp_compress_jit_adapters_agree_and_errors():
    x = torch.from_numpy(_field((9, 10, 11), seed=8))
    p0, e0 = tzfp.compress_jit(x, 16, 3, (9, 10, 11))
    p1, e1 = tzfp.compress_jit(x, 16, 3, (9, 10, 11), adapter="torch")
    assert torch.equal(p0, p1) and torch.equal(e0, e1)
    d0 = tzfp.decompress_jit(p0, e0, 16, 3, (9, 10, 11))
    d1 = tzfp.decompress_jit(p0, e0, 16, 3, (9, 10, 11), adapter="torch")
    np.testing.assert_array_equal(_bits(d0), _bits(d1))
    with pytest.raises(ValueError, match="1-4"):
        tzfp.compress(torch.zeros((2,) * 5))
    for rate in (0, 33):
        with pytest.raises(ValueError, match="rate"):
            tzfp.compress(x, rate=rate)


def test_zfp_compress_places_arrays_on_the_card_by_default(monkeypatch):
    """A tensor runs where it lies; any other data goes to the card, and
    without one that raises as the ``auto`` backend does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        tzfp.compress(_field((8, 8)))
    z = tzfp.compress(_field((8, 8)), device="cpu")
    assert z.payload.device.type == "cpu"


# ---------------------------------------------------------------------------
# MGARD
# ---------------------------------------------------------------------------

MGARD_CASES = [((16, 16, 16), 1e-2), ((33, 20), 1e-3), ((17, 9), 1e-2), ((65,), 1e-4)]


def _mgard_input(shape) -> np.ndarray:
    if len(shape) == 3:
        return smooth_field_3d(shape[0], noise=0.01)
    rng = np.random.default_rng(len(shape))
    grids = np.meshgrid(*[np.linspace(0, 3, n) for n in shape], indexing="ij")
    return (np.sin(sum(grids)) + 0.01 * rng.normal(size=shape)).astype(np.float32)


def _to_reference(obj: tmgard.MGARDCompressed) -> jmgard.MGARDCompressed:
    e = obj.entropy
    enc = jhuff.Encoded(words=jnp.asarray(e.words.numpy().view(np.uint32)),
                        total_bits=e.total_bits, n_symbols=e.n_symbols,
                        chunk_size=e.chunk_size,
                        chunk_offsets=jnp.asarray(e.chunk_offsets.numpy()),
                        length_table=e.length_table, num_keys=e.num_keys)
    return jmgard.MGARDCompressed(
        entropy=enc, outlier_idx=obj.outlier_idx.numpy(), outlier_val=obj.outlier_val.numpy(),
        bins=obj.bins, shape=obj.shape, padded=obj.padded, error_bound=obj.error_bound,
        dict_size=obj.dict_size, dtype=obj.dtype)


def _from_reference(obj: jmgard.MGARDCompressed) -> tmgard.MGARDCompressed:
    e = obj.entropy
    enc = thuff.Encoded(words=torch.from_numpy(np.asarray(e.words).view(np.int32).copy()),
                        total_bits=e.total_bits, n_symbols=e.n_symbols,
                        chunk_size=e.chunk_size,
                        chunk_offsets=torch.from_numpy(np.asarray(e.chunk_offsets).copy()),
                        length_table=e.length_table, num_keys=e.num_keys)
    return tmgard.MGARDCompressed(
        entropy=enc, outlier_idx=torch.from_numpy(obj.outlier_idx.copy()),
        outlier_val=torch.from_numpy(obj.outlier_val.copy()), bins=obj.bins,
        shape=obj.shape, padded=obj.padded, error_bound=obj.error_bound,
        dict_size=obj.dict_size, dtype=obj.dtype)


@pytest.mark.parametrize("shape,eb", MGARD_CASES)
def test_mgard_compress_within_bound_and_cross_decodes(shape, eb):
    x = _mgard_input(shape)
    t = tmgard.compress(torch.from_numpy(x), eb)
    out = tmgard.decompress(t).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    assert np.abs(out - x).max() <= eb
    # the reference reads the port's stream, and the port the reference's
    j_of_t = np.asarray(jmgard.decompress(_to_reference(t)))
    assert np.abs(j_of_t - x).max() <= eb
    j = jmgard.compress(jnp.asarray(x), eb)
    t_of_j = tmgard.decompress(_from_reference(j)).numpy()
    assert np.abs(t_of_j - x).max() <= eb
    np.testing.assert_array_equal(t.bins, j.bins)
    assert (t.padded, t.shape, t.dict_size, t.dtype) == (j.padded, j.shape, j.dict_size, j.dtype)
    assert tmgard.compression_ratio(t) == pytest.approx(
        np.prod(shape) * 4 / t.nbytes())


@pytest.mark.parametrize("shape", [(17,), (33, 20), (17, 9, 5), (65, 3, 2, 9), (2, 2), (1, 5)])
def test_level_map_on_the_device_equals_the_reference_s(shape):
    """The standalone path's level map, made by a broadcast minimum where
    the data lies, is the reference's numpy map."""
    got = tmgard.level_map(shape, "cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), jmgard.level_map(shape))


@pytest.mark.parametrize("shape,eb", MGARD_CASES[:2] + [((17, 9), 1e-6)])
def test_mgard_stream_equals_the_codec_container(shape, eb):
    """The standalone path's stream is the ``mgard`` codec's at the same
    absolute bound, section for section (the reference's
    ``test_mgard_stream_bit_identical_to_host_path``); 1e-6 makes outliers."""
    x = _mgard_input(shape)
    t = tmgard.compress(torch.from_numpy(x), eb, dict_size=64 if eb < 1e-5 else 4096)
    c = tapi.compress(torch.from_numpy(x), "mgard", error_bound=eb, relative=False,
                      dict_size=t.dict_size, backend="torch")
    np.testing.assert_array_equal(c.arrays["words"].view(np.int32), t.entropy.words.numpy())
    np.testing.assert_array_equal(c.arrays["chunk_offsets"], t.entropy.chunk_offsets.numpy())
    np.testing.assert_array_equal(c.arrays["length_table"], t.entropy.length_table)
    np.testing.assert_array_equal(c.arrays["outlier_idx"], t.outlier_idx.numpy())
    np.testing.assert_array_equal(c.arrays["outlier_val"], t.outlier_val.numpy())
    np.testing.assert_array_equal(c.arrays["bins"], t.bins)
    assert c.meta["total_bits"] == t.entropy.total_bits
    if eb < 1e-5:
        assert t.outlier_idx.numel() > 0


# ---------------------------------------------------------------------------
# quantizer, histogram, bit total, pack_stream
# ---------------------------------------------------------------------------


def _quant_inputs() -> np.ndarray:
    rng = np.random.default_rng(3)
    x = rng.normal(size=4096).astype(np.float32) * 100
    special = np.array([0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5, 1e-40, -1e-40, 3e38, -3e38,
                        np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([x, special])


@pytest.mark.parametrize("bin_size", [0.25, 1.0, 0.1, 1e-30])
def test_quantize_dequantize_bit_identical(bin_size):
    x = _quant_inputs()
    tqv = tq.quantize(torch.from_numpy(x), bin_size)
    jqv = np.asarray(jq.quantize(jnp.asarray(x), bin_size))
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    tdv = tq.dequantize(tqv, bin_size)
    jdv = np.asarray(jq.dequantize(jnp.asarray(jqv), bin_size))
    np.testing.assert_array_equal(_bits(tdv), _bits(jdv))
    for dtype in ("float16", "int32"):
        np.testing.assert_array_equal(
            _bits(tq.dequantize(tqv, bin_size, dtype=getattr(torch, dtype))),
            _bits(np.asarray(jq.dequantize(jnp.asarray(jqv), bin_size, dtype=dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64", "int32"])
def test_dequantize_by_subset_in_every_dtype_bit_identical(dtype):
    """``q * bins[level]`` computed in ``dtype``: float32 and bfloat16 with
    XLA's subnormal flush (a subnormal bin, tiny products), float16's own
    subnormals kept, float64 as float32 (JAX without 64-bit types)."""
    rng = np.random.default_rng(13)
    q = rng.integers(-70000, 70000, 4096).astype(np.int32)
    q[:64] = rng.integers(-2 ** 31, 2 ** 31 - 1, 64)
    levels = rng.integers(0, 12, 4096).astype(np.int32)
    bins = (10.0 ** rng.uniform(-45, 2, 12)).astype(np.float32)
    bins[3], bins[4] = 1e-39, 3e-6   # a float32 subnormal; float16 subnormal products
    t = tq.dequantize_by_subset(torch.from_numpy(q), torch.from_numpy(levels),
                                torch.from_numpy(bins), dtype=getattr(torch, dtype))
    j = np.asarray(_ref(jq.dequantize_by_subset, jnp.asarray(q), jnp.asarray(levels),
                        jnp.asarray(bins), dtype=getattr(jnp, dtype)))
    assert str(t.dtype) == f"torch.{j.dtype}"
    got = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(j))
    if dtype == "float32":   # the default is the quantize_map kernel's oracle
        np.testing.assert_array_equal(_bits(t), _bits(tq.dequantize_by_subset(
            torch.from_numpy(q), torch.from_numpy(levels), torch.from_numpy(bins))))


def test_quantize_integer_input_bit_identical():
    x = np.random.default_rng(4).integers(-1000, 1000, 333).astype(np.int32)
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(x), 3.0).numpy(),
                                  np.asarray(jq.quantize(jnp.asarray(x), 3.0)))


@pytest.mark.parametrize("num_bins", [1, 7, 256])
def test_histogram_and_histogram_op_match_reference(num_bins):
    keys = np.random.default_rng(num_bins).integers(-3, num_bins + 3, (40, 25)).astype(np.int32)
    ref = np.asarray(jhuff.histogram(jnp.asarray(keys), num_bins))
    np.testing.assert_array_equal(thuff.histogram(torch.from_numpy(keys), num_bins).numpy(), ref)
    np.testing.assert_array_equal(
        thuff.histogram_op(torch.from_numpy(keys), num_bins).numpy(), ref)


def test_symbol_lengths_total_matches_reference():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 33, 100).astype(np.int32)
    for keys in (rng.integers(0, 100, 5000), rng.integers(-150, 250, 5000)):
        keys = keys.astype(np.int32)
        assert thuff.symbol_lengths_total(torch.from_numpy(keys), torch.from_numpy(lengths)) \
            == jhuff.symbol_lengths_total(jnp.asarray(keys), jnp.asarray(lengths))


@pytest.mark.parametrize("chunk_size", [64, 4096])
def test_pack_stream_matches_reference(chunk_size):
    rng = np.random.default_rng(chunk_size)
    lens = rng.integers(0, 33, 3000).astype(np.int32)
    codes = (rng.integers(0, 2 ** 32, 3000, dtype=np.uint64)
             & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    num_words = int(lens.sum()) // 32 + 1
    tw, to, tt = tenc_ops.pack_stream(torch.from_numpy(codes.view(np.int32)),
                                      torch.from_numpy(lens), num_words, chunk_size,
                                      adapter="torch")
    jw, jo, jt = jenc_ops.pack_stream(jnp.asarray(codes), jnp.asarray(lens), num_words,
                                      chunk_size, adapter="xla")
    np.testing.assert_array_equal(_bits(tw), np.asarray(jw))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tt) == int(jt)


# ---------------------------------------------------------------------------
# executor map, data mesh
# ---------------------------------------------------------------------------


def test_device_executor_map_ordered_as_reference():
    items = list(range(17))
    fn = lambda i: i * i - 3  # noqa: E731
    tex = TExecutor([torch.device("cpu")] * 3)
    jex = JExecutor()
    try:
        assert tex.map(fn, items) == jex.map(fn, items) == [fn(i) for i in items]
        assert tex.stats()["completed"] == len(items)
    finally:
        tex.shutdown()
        jex.shutdown()


@pytest.mark.parametrize("names,shape", [(("data",), (4,)), (("data", "model"), (2, 3)),
                                         (("model", "data"), (3, 2)), (("pod", "data", "model"),
                                                                       (2, 2, 2)),
                                         (("model",), (3,))])
def test_data_devices_walks_the_mesh_as_the_reference(monkeypatch, names, shape):
    """The ``data`` axis walked with every other axis pinned at 0 (every
    device where the mesh has no ``data`` axis): the port's ranks on a
    DeviceMesh-shaped object against the reference's devices on a
    Mesh-shaped one, both numbered row-major."""
    import types

    from repro.core.engine import data_devices as jdata_devices
    from repro_torch.core.engine import data_devices as tdata_devices

    n = int(np.prod(shape))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    port_mesh = types.SimpleNamespace(mesh=torch.arange(n).reshape(shape), mesh_dim_names=names,
                                      device_type="cuda")
    ref_mesh = types.SimpleNamespace(devices=np.arange(n).reshape(shape), axis_names=names)
    got = [d.index for d in tdata_devices(port_mesh)]
    assert got == [int(d) for d in jdata_devices(ref_mesh)]


_MESH_SCRIPT = r"""
import numpy as np, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core import engine as E
from repro_torch.launch import mesh as M

# a world-size-1 gloo group: the engine's mesh, its ring and its bytes
m = E.make_data_mesh([torch.device("cpu")])
assert m.mesh_dim_names == ("data",) and M.data_axis_size(m) == 1
assert E.data_devices(m) == [torch.device("cpu")]
tree = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(128, 96)).astype(np.float32)),
        "b": torch.zeros(7)}
with E.ExecutionEngine(mesh=m, backend="torch") as a, \
        E.ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as b:
    assert a.mesh is m and b.mesh is None and a.devices == b.devices
    fa, _ = a.compress_pytree(tree)
    fb, _ = b.compress_pytree(tree)
    assert fa["w"].to_bytes() == fb["w"].to_bytes() and torch.equal(fa["b"], fb["b"])
dist.destroy_process_group()

# four fake ranks: the data axis of a 1-D and of a (data, model) mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
m1 = M.make_data_mesh(device="cpu")
assert M.data_axis_size(m1) == 4 and len(E.data_devices(m1)) == 4
m2 = M.make_mesh((2, 2), ("data", "model"), "cpu")
ranks = np.moveaxis(m2.mesh.numpy(), 0, 0).reshape(2, -1)[:, 0]
assert M.data_axis_size(m2) == 2 and len(E.data_devices(m2)) == len(ranks) == 2
m3 = M.make_mesh((2, 2), ("model", "data"), "cpu")
assert M.data_axis_size(m3) == 2 and len(E.data_devices(m3)) == 2
try:
    M.make_data_mesh(2, device="cpu")
except ValueError:
    pass
else:
    raise AssertionError("a data mesh of 2 of 4 ranks was made")
dist.destroy_process_group()
print("MESH OK")
"""


def test_data_mesh_on_gloo_and_fake_groups():
    """In a subprocess (a process group must not start in the test process):
    ``make_data_mesh`` on a world-size-1 gloo group feeds an engine whose
    bytes equal the ``devices=`` engine's; on four fake ranks the data axis
    is walked with the other axis pinned at 0, as the reference's
    ``data_devices`` does, and ``data_axis_size`` reads it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT], capture_output=True, text=True,
                         env=env, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "MESH OK" in out.stdout
