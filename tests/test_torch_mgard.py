"""The port's MGARD slice against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages: the
reference's ``repro.core.mgard``, its ``quantize_map`` / ``mgard_lerp`` /
``tridiag`` kernels (Pallas in interpret mode and the plain ``xla`` path)
and ``repro.core.api`` with the ``xla`` backend; the port's plain PyTorch
versions and ``backend="torch"``.

Tolerances, each with its reason:
  * quantize, dequantize and the lerp stencil: none (bit for bit), special
    values included — the port reproduces XLA's subnormal flush and
    saturating float → int32 conversion;
  * the tridiagonal solve: rtol 3e-5, atol 3e-6, the reference's own
    tolerance between its two paths (XLA may contract the sweep into FMAs);
  * decomposition coefficients: 2^-16 of the value range; recomposition of
    a decomposition: 5e-6, as the reference's own test;
  * reconstructions: the effective error bound, both packages decoding
    both packages' streams.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from conftest import smooth_field_3d
from repro.core import api as japi
from repro.core import mgard as jmgard
from repro.core.container import Compressed as JCompressed
from repro.kernels.mgard_lerp import ops as jlerp
from repro.kernels.quantize_map import ops as jquant
from repro.kernels.tridiag import ops as jtri
from repro_torch.core import api as tapi
from repro_torch.core import codecs as tcodecs
from repro_torch.core import mgard as tmgard
from repro_torch.core import quantize as tquant
from repro_torch.core.container import Compressed as TCompressed
from repro_torch.core.container import ContainerError
from repro_torch.kernels.mgard_lerp import kernel as tlerp_kernel
from repro_torch.kernels.mgard_lerp import ops as tlerp_ops
from repro_torch.kernels.mgard_lerp import ref as tlerp
from repro_torch.kernels.quantize_map import kernel as tquant_kernel
from repro_torch.kernels.quantize_map import ops as tquant_ops
from repro_torch.kernels.quantize_map import ref as tquant_ref
from repro_torch.kernels.tridiag import kernel as ttri_kernel
from repro_torch.kernels.tridiag import ops as ttri_ops
from repro_torch.kernels.tridiag import ref as ttri

torch.set_num_threads(2)

JAX_PATHS = ("xla", "pallas_interpret")
TINY = np.float32(np.finfo(np.float32).tiny)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# quantize_map
# ---------------------------------------------------------------------------


def special_quantize_case():
    """±0, ±inf, NaN, ±2^31 and just inside, exact ties x/bin = k + ½,
    subnormal values, and one subnormal bin (level 2)."""
    f = np.float32
    x = np.array([
        0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 128,
        -(2.0 ** 31) + 128, 2.0 ** 32, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 1e30, -1e30,
        TINY * f(0.25), -TINY * f(0.25), TINY, 1e-40, 0.375, 0.125, -0.375,
        5.0, TINY * f(0.25), 0.0, -1.0, 1e-39,
    ], np.float32)
    levels = np.array([0] * 22 + [1] * 3 + [2] * 5, np.int32)
    bins = np.array([1.0, 0.25, TINY * f(0.5)], np.float32)
    return x, levels, bins


def random_quantize_case(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    levels = rng.integers(0, 6, n).astype(np.int32)
    bins = (10.0 ** -rng.uniform(1, 4, 6)).astype(np.float32)
    return x, levels, bins


QUANT_CASES = {
    "special": special_quantize_case,
    "random-1": lambda: random_quantize_case(1, 1),
    "random-1001": lambda: random_quantize_case(1001, 2),
    "random-65539": lambda: random_quantize_case(65539, 3),
}


@pytest.mark.parametrize("path", JAX_PATHS)
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_matches_reference_bit_for_bit(case, path):
    x, levels, bins = QUANT_CASES[case]()
    want = np.asarray(jquant.quantize(jnp.asarray(x), jnp.asarray(levels), jnp.asarray(bins),
                                      adapter=path))
    got = tquant_ref.quantize(_t(x), _t(levels), _t(bins))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("path", JAX_PATHS)
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_dequantize_matches_reference_bit_for_bit(case, path):
    _, levels, bins = QUANT_CASES[case]()
    rng = np.random.default_rng(len(case))
    keys = rng.integers(0, 1 << 32, levels.size, dtype=np.uint64).astype(np.uint32)
    keys[: min(6, keys.size)] = np.array([0, 1, 2, 0xFFFFFFFF, 0xFFFFFFFE, 7], np.uint32)[
        : min(6, keys.size)]
    want = np.asarray(jquant.dequantize(jnp.asarray(keys), jnp.asarray(levels),
                                        jnp.asarray(bins), adapter=path))
    got = tquant_ref.dequantize(_t(keys.view(np.int32)), _t(levels), _t(bins))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_zigzag_matches_reference():
    from repro.core import quantize as jq

    q = np.array([0, 1, -1, 2, -2, 2 ** 30, -(2 ** 30), 2 ** 31 - 1, -(2 ** 31)], np.int32)
    u = np.asarray(jq.signed_to_unsigned(jnp.asarray(q)))
    got = tquant.signed_to_unsigned(_t(q))
    assert np.array_equal(got.numpy().view(np.uint32), u)
    assert np.array_equal(tquant.unsigned_to_signed(got).numpy(), q)
    assert np.array_equal(np.asarray(jq.unsigned_to_signed(jnp.asarray(u))), q)


def test_quantize_wrappers_route_cpu_tensors_to_plain_versions():
    x, levels, bins = random_quantize_case(777, 9)
    before = dict(tquant_kernel.launches)
    u = tquant_kernel.quantize(_t(x), _t(levels), _t(bins))
    assert torch.equal(u, tquant_ref.quantize(_t(x), _t(levels), _t(bins)))
    assert torch.equal(tquant_ops.quantize(_t(x), _t(levels), _t(bins), adapter="torch"), u)
    back = tquant_kernel.dequantize(u, _t(levels), _t(bins))
    assert torch.equal(back, tquant_ops.dequantize(u, _t(levels), _t(bins), adapter="torch"))
    assert tquant_kernel.launches == before  # nothing launched on the CPU
    err = np.abs(back.numpy() - x)
    assert (err <= bins[levels] / 2 + 1e-7 * np.abs(x)).all()


# ---------------------------------------------------------------------------
# mgard_lerp and tridiag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", JAX_PATHS)
@pytest.mark.parametrize("b,n", [(1, 3), (19, 17), (5, 65), (3, 4097)])
def test_lerp_matches_reference_bit_for_bit(b, n, path):
    rows = np.random.default_rng(n).normal(size=(b, n)).astype(np.float32)
    want = np.asarray(jlerp.lerp_coefficients(jnp.asarray(rows), adapter=path))
    got = tlerp.lerp_coefficients(_t(rows))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(tlerp_kernel.lerp_coefficients(_t(rows)), got)
    assert torch.equal(tlerp_ops.lerp_coefficients(_t(rows), adapter="torch"), got)


def test_lerp_rejects_even_rows():
    with pytest.raises(ValueError, match="2m\\+1"):
        tlerp_kernel.lerp_coefficients(torch.zeros((2, 4)))


@pytest.mark.parametrize("path", JAX_PATHS)
@pytest.mark.parametrize("n,h", [(2, 2.0), (3, 4.0), (17, 1.0), (33, 2.0), (129, 8.0)])
def test_tridiag_matches_reference(n, h, path):
    rhs = np.random.default_rng(n).normal(size=(7, n)).astype(np.float32)
    want = np.asarray(jtri.solve_mass(jnp.asarray(rhs), h, adapter=path))
    got = ttri.solve_mass(_t(rhs), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)
    assert torch.equal(ttri_kernel.solve_mass(_t(rhs), h), got)
    assert torch.equal(ttri_ops.solve_mass(_t(rhs), h, adapter="torch"), got)
    # the column layout the codec hands the kernel gives the same bits
    assert torch.equal(ttri_kernel.solve_columns(_t(rhs.T.copy()), h).t(), got)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tridiag_solve_1d_matches_reference(axis):
    rhs = np.random.default_rng(axis).normal(size=(9, 5, 17)).astype(np.float32)
    want = np.asarray(jmgard.tridiag_solve_1d(jnp.asarray(rhs), axis, 4.0))
    got = tmgard.tridiag_solve_1d(_t(rhs), axis, 4.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


def _moved_axis_sweep(rhs: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """The solve as the port made it before it viewed the grid as (P, n, Q):
    the axis moved first and copied into (n, B) columns."""
    v = rhs.movedim(axis, 0)
    n = v.shape[0]
    return ttri.sweep_columns(v.reshape(n, -1).contiguous(), h).reshape(v.shape).movedim(0, axis)


@pytest.mark.parametrize("shape,axis", [((9, 5, 17), 0), ((9, 5, 17), 1), ((9, 5, 17), 2),
                                        ((33, 9), 0), ((33, 9), 1), ((5, 4, 3, 9), 2),
                                        ((17,), 0)])
def test_tridiag_solve_1d_views_any_axis_without_moving_it(shape, axis):
    rhs = np.random.default_rng(len(shape) + axis).normal(size=shape).astype(np.float32)
    got = tmgard.tridiag_solve_1d(_t(rhs), axis, 2.0)
    assert got.is_contiguous() and tuple(got.shape) == shape
    assert np.array_equal(_bits(got.numpy()), _bits(_moved_axis_sweep(_t(rhs), axis, 2.0).numpy()))
    want = np.asarray(jmgard.tridiag_solve_1d(jnp.asarray(rhs), axis, 2.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("p,n,q", [(1, 17, 1), (4, 9, 1), (3, 5, 7), (1, 33, 40), (2, 3, 33)])
def test_solve_columns_views_match_the_sweep_of_each_system(p, n, q):
    v = np.random.default_rng(n * q).normal(size=(p, n, q)).astype(np.float32)
    got = ttri_kernel.solve_columns(_t(v), 4.0)
    assert got.is_contiguous() and tuple(got.shape) == (p, n, q)
    for a in range(p):  # system (a, b) is v[a, :, b], solved on its own
        want = ttri.solve_mass(_t(np.ascontiguousarray(v[a].T)), 4.0).t()
        assert torch.equal(got[a], want)


# ---------------------------------------------------------------------------
# solver state, grid bookkeeping, 1-D operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h", [(2, 2.0), (5, 1.0), (257, 2.0), (4097, 512.0)])
def test_thomas_coeffs_identical_in_float64(n, h):
    for got, want in zip(tmgard._thomas_coeffs(n, h), jmgard._thomas_coeffs(n, h)):
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(17,), (2,), (20, 33), (17, 9, 13), (5, 5, 5, 5), (129, 3)])
def test_level_map_and_grid_identical(shape):
    padded = tuple(tmgard.padded_dim(n) for n in shape)
    assert padded == tuple(jmgard.padded_dim(n) for n in shape)
    assert tmgard.total_levels(padded) == jmgard.total_levels(padded)
    got, want = tmgard.level_map(padded).numpy(), jmgard.level_map(padded)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    u = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    assert np.array_equal(tmgard.pad_to_dyadic(_t(u)).numpy(),
                          np.asarray(jmgard.pad_to_dyadic(jnp.asarray(u))))


@pytest.mark.parametrize("eb,L", [(0.02, 0), (1e-3, 4), (0.5, 9), (3.0, 31)])
def test_level_bins_identical(eb, L):
    got, want = tmgard.level_bins(eb, L), jmgard.level_bins(eb, L)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("op", ["interp", "mass_mult", "restrict"])
@pytest.mark.parametrize("axis", [0, 1])
def test_1d_operators_match_reference(op, axis):
    u = np.random.default_rng(3).normal(size=(9, 17)).astype(np.float32)
    fns = {
        "interp": (lambda m, x: m.interp_1d(x, axis)),
        "mass_mult": (lambda m, x: m.mass_mult_1d(x, axis, 4.0)),
        "restrict": (lambda m, x: m.restrict_1d(x, axis)),
    }
    got = fns[op](tmgard, _t(u)).numpy()
    want = np.asarray(fns[op](jmgard, jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-7)


DECOMP_SHAPES = [(17,), (33,), (20, 33), (17, 9, 13), (5, 5, 5, 5), (24, 24, 24)]


@pytest.mark.parametrize("shape", DECOMP_SHAPES)
def test_decompose_matches_reference(shape):
    u = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    got = tmgard.decompose(_t(u), shape)
    want = np.asarray(jmgard.decompose(jnp.asarray(u), shape))
    assert tuple(got.shape) == want.shape
    vrange = float(u.max() - u.min())
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -16 * vrange
    back = tmgard.recompose(got, shape)
    assert tuple(back.shape) == shape
    assert np.abs(back.numpy() - u).max() < 5e-6
    assert np.abs(np.asarray(jmgard.recompose(jnp.asarray(got.numpy()), shape)) - u).max() < 5e-6


def test_decompose_leaves_its_input_alone():
    u = torch.from_numpy(np.random.default_rng(4).normal(size=(17, 9)).astype(np.float32))
    keep = u.clone()
    tmgard.decompose(u, (17, 9))
    assert torch.equal(u, keep)


# ---------------------------------------------------------------------------
# the codec end to end
# ---------------------------------------------------------------------------


def _spike_field():
    f = smooth_field_3d(16)
    f[3, 3, 3] = 100.0
    return f


def _overflow_field():
    """Noise under a tight bound and a 16-key alphabet: most keys escape,
    past the device compaction's cap of n // 16."""
    return np.random.default_rng(5).normal(size=(17, 17, 17)).astype(np.float32)


CODEC_CASES = {
    "smooth-1e-2": (lambda: smooth_field_3d(20), {"error_bound": 1e-2}),
    "smooth-1e-3": (lambda: smooth_field_3d(20), {"error_bound": 1e-3}),
    "noisy": (lambda: smooth_field_3d(17, noise=0.1), {"dict_size": 65536}),
    "spike-outlier": (_spike_field, {"error_bound": 1e-3, "dict_size": 256}),
    "outlier-cap-overflow": (_overflow_field, {"error_bound": 1e-4, "dict_size": 16}),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_error_bound_and_cross_decode(case):
    make, params = CODEC_CASES[case]
    f = make()
    tc = tapi.compress(f, "mgard", backend="torch", **params)
    jc = japi.compress(f, "mgard", backend="xla", **params)
    eb = tc.meta["error_bound"]
    assert eb == jc.meta["error_bound"]
    assert np.array_equal(tc.arrays["bins"], jc.arrays["bins"])
    n_out = tc.arrays["outlier_idx"].size
    cap = max(64, math.prod(tc.meta["padded"]) // 16)
    if case == "spike-outlier":
        assert n_out > 0
    if case == "outlier-cap-overflow":
        assert n_out > cap
    outs = {
        "port": tapi.decompress(TCompressed.from_bytes(tc.to_bytes()), backend="torch").numpy(),
        "port->ref": np.asarray(japi.decompress(JCompressed.from_bytes(tc.to_bytes()))),
        "ref->port": tapi.decompress(TCompressed.from_bytes(jc.to_bytes()),
                                     backend="torch").numpy(),
    }
    for name, out in outs.items():
        assert out.shape == f.shape and out.dtype == np.float32, name
        assert np.abs(out - f).max() <= eb, name


@pytest.mark.parametrize("case", ["spike-outlier", "outlier-cap-overflow"])
def test_codec_outlier_sections_match_reference(case):
    """The device outlier compaction, under its cap and past it (where the
    container fetches the keys whole), stores the reference's outliers."""
    make, params = CODEC_CASES[case]
    f = make()
    tc = tapi.compress(f, "mgard", backend="torch", **params)
    jc = japi.compress(f, "mgard", backend="xla", **params)
    for k in ("outlier_idx", "outlier_val", "bins"):
        assert tc.arrays[k].dtype == np.asarray(jc.arrays[k]).dtype, k
        assert np.array_equal(tc.arrays[k], np.asarray(jc.arrays[k])), k


def test_codec_is_the_default_and_registered():
    assert "mgard" in tcodecs.available_methods()
    assert tcodecs.get_codec("mgard").name == "mgard"
    f = smooth_field_3d(12)
    c = tapi.compress(f, backend="torch")
    assert c.method == "mgard" and c.meta["dict_size"] == 4096
    assert c.meta["error_bound"] == pytest.approx(1e-2 * float(f.max() - f.min()))
    assert [s["stage"] for s in c.meta["stages"]] == [
        s["stage"] for s in japi.compress(f, backend="xla").meta["stages"]]


@pytest.mark.parametrize("shape", [(17,), (20, 33), (5, 5, 5, 5)])
def test_codec_containers_match_reference_sections(shape):
    """Held to the bound, not to bit identity; at these inputs the
    sections come out identical all the same (recorded in PERF.md)."""
    u = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    tc = tapi.compress(u, "mgard", backend="torch")
    jc = japi.compress(u, "mgard", backend="xla")
    assert sorted(tc.arrays) == sorted(jc.arrays)
    assert tc.meta == {k: v for k, v in jc.meta.items()}
    for k in tc.arrays:
        assert np.array_equal(np.asarray(tc.arrays[k]), np.asarray(jc.arrays[k])), k


def test_stream_without_decode_index_decodes():
    f = smooth_field_3d(12)
    c = TCompressed.from_bytes(japi.compress(f, "mgard", backend="xla").to_bytes())
    for s in c.meta["stages"]:
        s.pop("decode_index", None)
    out = tapi.decompress(c, backend="torch").numpy()
    assert np.abs(out - f).max() <= c.meta["error_bound"]


@pytest.mark.parametrize("idx", [[-1], [10 ** 9], [0, 1]])
def test_outlier_indices_off_the_grid_raise(idx):
    c = TCompressed.from_bytes(japi.compress(smooth_field_3d(9), "mgard",
                                             backend="xla").to_bytes())
    c.arrays["outlier_idx"] = np.asarray(idx, np.int64)
    c.arrays["outlier_val"] = np.zeros(1, np.int32)  # [0, 1]: one value short
    with pytest.raises(ContainerError, match="outlier"):
        tapi.decompress(c, backend="torch")


def test_integer_input_keeps_its_dtype():
    x = (np.arange(9 * 17) % 50).reshape(9, 17).astype(np.int32)
    c = tapi.compress(x, "mgard", backend="torch", error_bound=1e-3)
    out = tapi.decompress(c, backend="torch")
    assert out.dtype == torch.int32 and c.meta["dtype"] == "int32"
    assert np.abs(out.numpy() - x).max() <= 1


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (17, 9)), ("float16", (33,)), ("bfloat16", (9, 9)), ("float64", (2, 3, 2, 3, 5)),
    ("float32", ()), ("int32", (10,)),
])
def test_leaf_policy_routes_like_reference(dtype, shape):
    rng = np.random.default_rng(2)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = (rng.normal(size=shape) * 10).astype(np_dtype)
    x, method, _ = tapi.leaf_policy(arr, "mgard")
    jx, jmethod, _ = japi.leaf_policy(arr, "mgard")
    assert method == jmethod == "mgard"
    assert tuple(x.shape) == jx.shape and tapi.dtype_name(x) == str(jx.dtype)
    assert np.array_equal(x.numpy(), jx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_leaf_round_trip_within_bound(dtype):
    w = (np.random.default_rng(3).normal(size=(33, 40)) * 0.02).astype(np.float32)
    x = torch.from_numpy(w).to(getattr(torch, dtype))
    c = tapi.compress_leaf(x, "mgard", backend="torch")
    out = tapi.decompress_leaf(c, backend="torch")
    assert out.dtype == x.dtype and tuple(out.shape) == tuple(x.shape)
    ref = x.to(torch.float32)
    slack = 0.0 if dtype == "float32" else float(ref.abs().max()) * 2.0 ** -8  # bf16 rounding
    assert float((out.to(torch.float32) - ref).abs().max()) <= c.meta["error_bound"] + slack
    jc = japi.compress_leaf(np.asarray(w if dtype == "float32" else x.to(torch.float32).numpy()),
                            "mgard")
    assert c.meta["error_bound"] == pytest.approx(jc.meta["error_bound"])


def _unsigned_field(dtype, seed: int) -> np.ndarray:
    """A smooth field of counts near the middle of ``dtype``'s range, with
    its minimum and maximum planted."""
    rng = np.random.default_rng(seed)
    top = min(np.iinfo(dtype).max, 2 ** 32 - 1)
    f = smooth_field_3d(12, noise=0.05)
    x = (f - f.min()) / (f.max() - f.min()) * (0.8 * top) + 0.1 * top
    x = x.astype(np.float64) + rng.integers(0, 3, size=x.shape)
    x.flat[0], x.flat[-1] = 0, top
    return x.astype(np.uint64).astype(dtype)


def _bfloat16_field(seed: int) -> np.ndarray:
    """bfloat16 values whose range, max - min, is no bfloat16 (3 + 3 * 2^-8):
    the reference rounds that difference to bfloat16, 3.015625."""
    f = smooth_field_3d(12, noise=0.05).astype(np.float64)
    x = np.clip(f / np.abs(f).max() * 2.5, -0.01, 2.9)
    x.flat[0], x.flat[-1] = 3.0, -0.01171875
    return x.astype(ml_dtypes.bfloat16)


DTYPE_CASES = {  # name: (make, params, the dtype the reference records)
    "uint16 relative": (lambda: _unsigned_field(np.uint16, 1), {}, "uint16"),
    "uint16 absolute": (lambda: _unsigned_field(np.uint16, 2),
                        {"relative": False, "error_bound": 40.0}, "uint16"),
    "uint16 tight": (lambda: _unsigned_field(np.uint16, 3), {"error_bound": 1e-4}, "uint16"),
    "uint32 relative": (lambda: _unsigned_field(np.uint32, 4), {}, "uint32"),
    "uint32 absolute": (lambda: _unsigned_field(np.uint32, 5),
                        {"relative": False, "error_bound": 3e6}, "uint32"),
    "uint64 relative": (lambda: _unsigned_field(np.uint64, 6), {}, "uint32"),
    "uint64 absolute": (lambda: _unsigned_field(np.uint64, 7),
                        {"relative": False, "error_bound": 3e6}, "uint32"),
    "bfloat16 relative": (lambda: _bfloat16_field(8), {}, "bfloat16"),
    "bfloat16 tight": (lambda: _bfloat16_field(9), {"error_bound": 1e-3}, "bfloat16"),
    "bfloat16 absolute": (lambda: _bfloat16_field(10),
                          {"relative": False, "error_bound": 0.05}, "bfloat16"),
}


def _values(a) -> np.ndarray:
    """A decoded array of either package as float64 values."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(a).astype(np.float64)


@pytest.mark.parametrize("case", sorted(DTYPE_CASES))
def test_codec_unsigned_and_bfloat16_match_reference(case):
    """Unsigned and bfloat16 data through ``api.compress``: the reference's
    bound and bins (its range subtracted in the data's dtype; a bfloat16
    difference rounded to bfloat16), the recorded dtype, and every decode
    of either package's stream within the bound, in that dtype."""
    make, params, dtype = DTYPE_CASES[case]
    x = make()
    tc = tapi.compress(x, "mgard", backend="torch", **params)
    jc = japi.compress(x, "mgard", backend="xla", **params)
    assert tc.meta["dtype"] == jc.meta["dtype"] == dtype
    assert tc.meta["error_bound"] == jc.meta["error_bound"]
    assert np.array_equal(tc.arrays["bins"], np.asarray(jc.arrays["bins"]))
    if dtype == "bfloat16" and params.get("relative", True):
        span = np.float32(x.max()) - np.float32(x.min())
        assert tc.meta["error_bound"] != pytest.approx(params.get("error_bound", 1e-2) * span)
    eb = tc.meta["error_bound"]
    want = _values(x.astype(np.uint32) if dtype == "uint32" else x)
    outs = {
        "port": tapi.decompress(TCompressed.from_bytes(tc.to_bytes()), backend="torch"),
        "port->ref": japi.decompress(JCompressed.from_bytes(tc.to_bytes())),
        "ref->port": tapi.decompress(TCompressed.from_bytes(jc.to_bytes()), backend="torch"),
    }
    for name, out in outs.items():
        got_dtype = tapi.dtype_name(out) if isinstance(out, torch.Tensor) else str(out.dtype)
        assert got_dtype == dtype and tuple(out.shape) == x.shape, name
        # bfloat16 holds the decoded value to 8 bits: its rounding adds to the bound
        slack = float(np.abs(want).max()) * 2.0 ** -8 if dtype == "bfloat16" else 0.0
        assert np.abs(_values(out) - want).max() <= eb + slack, name


def test_mgard_progressive_still_raises():
    # ported now: it still raises where the reference raises, on a tier
    # ladder it cannot build
    x = np.zeros(4, np.float32)
    assert tapi.leaf_policy(x, "mgard-progressive")[1] == "mgard-progressive"
    for params in ({"tiers": 0}, {"tier_ratio": 1.0}):
        with pytest.raises(ValueError, match="tier"):
            tapi.compress(x, "mgard-progressive", backend="torch", **params)
        with pytest.raises(ValueError, match="tier"):
            japi.compress(x, "mgard-progressive", **params)


# ---------------------------------------------------------------------------
# the quantize stage
# ---------------------------------------------------------------------------


def test_escape_compares_as_unsigned():
    """A zig-zagged key of 2^31 or more is negative in the int32 carrier and
    must escape, as the reference's uint32 comparison does."""
    coeffs = torch.tensor([0.0, 1.0, 3e9, -3e9, 2047.0, -2048.0], dtype=torch.float32)
    lmap = torch.zeros(6, dtype=torch.int32)
    bins = torch.tensor([1.0], dtype=torch.float32)
    q, keys, inlier = tmgard._quantize_stage_impl(coeffs, lmap, bins, (6,), 4096, "torch")
    jq, jkeys, jin = jmgard._quantize_stage_impl(
        jnp.asarray(coeffs.numpy()), jnp.asarray(lmap.numpy()), jnp.asarray(bins.numpy()),
        (6,), 4096, None)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(keys.numpy(), np.asarray(jkeys))
    assert np.array_equal(inlier.numpy(), np.asarray(jin))
    assert inlier.tolist() == [True, True, False, False, True, False]  # 4094 in, 4095 escapes
