"""The port's parallel abstractions and GEM/DEM programs against the JAX
reference, on the CPU, and its adapter registry.

Inputs come from numpy with a seed and go through ``repro.core.abstractions``
/ ``repro.core.machine`` (eager JAX on XLA:CPU) and their counterparts in
``repro_torch``.  Tolerance: none where ``fn`` is elementwise (outputs
compared as bit patterns); 2 ulps of float32 (``rtol=2.4e-7`` of the largest
magnitude) where ``fn`` reduces (a mean, a sum), because the two libraries
sum in another order.  ``pad_to_blocks`` is held to ``jnp.pad`` bit for bit
in every mode, apart from ``mean`` on float32: there XLA sums an axis longer
than 32 in another order and folds the mean of one padded dim into the sum
of the next, so there within the same 2 ulps; ``empty`` leaves the pad unset, so
only its shape and the original region are compared.  ``iterative`` over an
axis of length 0 is held to ``lax.scan``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import abstractions as jab
from repro.core import machine as jm
from repro_torch.core import abstractions as tab
from repro_torch.core import adapters
from repro_torch.core import machine as tm
from repro_torch.kernels.histogram import ops as _histogram_ops  # noqa: F401  (registers)

REDUCE_RTOL = 2.4e-7


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32 if a.dtype == np.float32 else a.dtype)


def _same(t, j) -> None:
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _close(t, j) -> None:
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(t - j).max() <= REDUCE_RTOL * scale * 2


def _field(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# locality
# ---------------------------------------------------------------------------

ODD = [((12, 8), (4, 4)), ((10, 7), (4, 4)), ((37,), (8,)), ((9, 10, 11), (4, 4, 4)),
       ((5, 6, 7, 9), (4, 4, 4, 4)), ((3, 13), (2, 5))]


@pytest.mark.parametrize("shape,block", ODD)
def test_locality_elementwise_bit_identical(shape, block):
    x = _field(shape)
    t = tab.locality(torch.from_numpy(x), lambda b: b * 2.0 + torch.abs(b), block)
    j = jab.locality(jnp.asarray(x), lambda b: b * 2.0 + jnp.abs(b), block)
    _same(t, j)


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("shape,block", [((10, 7), (4, 4)), ((9, 10, 11), (4, 4, 4)),
                                         ((37,), (8,))])
def test_locality_halo_stencil_bit_identical(shape, block, halo):
    """A stencil over each halo'd patch (the block's values plus their
    neighbours one ``halo`` away along every axis), edge-padded as the
    reference pads."""
    def stencil(p, lib):
        inner = tuple(slice(halo, -halo) for _ in block)
        out = p[inner] * 2.0
        for ax in range(len(block)):
            lo = tuple(slice(0, -2 * halo) if a == ax else slice(halo, -halo)
                       for a in range(len(block)))
            hi = tuple(slice(2 * halo, None) if a == ax else slice(halo, -halo)
                       for a in range(len(block)))
            out = out + (p[lo] - p[hi])
        return out

    x = _field(shape, seed=1)
    t = tab.locality(torch.from_numpy(x), lambda p: stencil(p, torch), block, halo=halo)
    j = jab.locality(jnp.asarray(x), lambda p: stencil(p, jnp), block, halo=halo)
    _same(t, j)


@pytest.mark.parametrize("halo", [0, 1])
def test_locality_changing_block_shape_returns_blocks(halo):
    """``fn`` that does not keep the block shape: the per-block results come
    back in row-major block order, ``(num_blocks, ...)``."""
    x = _field((10, 7), seed=2)
    t = tab.locality(torch.from_numpy(x), lambda b, s: b.sum(dim=1) * s, (4, 4), 0.5, halo=halo)
    j = jab.locality(jnp.asarray(x), lambda b, s: b.sum(axis=1) * s, (4, 4), 0.5, halo=halo)
    _close(t, j)


def test_locality_extra_args_reach_fn():
    x = _field((8, 8), seed=3)
    shift = 1.5
    t = tab.locality(torch.from_numpy(x), lambda b, s: b - s, (4, 4), shift)
    j = jab.locality(jnp.asarray(x), lambda b, s: b - s, (4, 4), shift)
    _same(t, j)


# ---------------------------------------------------------------------------
# iterative
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_iterative_prefix_sum_bit_identical(axis, reverse):
    x = _field((6, 5, 4), seed=4)
    n = [d for a, d in enumerate(x.shape) if a != axis % 3]

    def step(carry, s):
        carry = carry + s
        return carry, carry

    tc, ty = tab.iterative(torch.from_numpy(x), step, torch.zeros(n), axis, reverse=reverse)
    jc, jy = jab.iterative(jnp.asarray(x), step, jnp.zeros(n), axis, reverse=reverse)
    _same(tc, jc)
    _same(ty, jy)


def test_iterative_reverse_tuple_carry():
    """A tuple carry (a running sum and a step count) visited last to first:
    ``ys[i]`` still belongs to ``xs[i]``."""
    x = _field((7, 3), seed=5)

    def step(carry, s):
        total, count = carry
        total = total + s
        count = count + 1.0
        return (total, count), total / count

    (tt, tn), ty = tab.iterative(torch.from_numpy(x), step,
                                 (torch.zeros(3), torch.zeros(())), 0, reverse=True)
    (jt, jn), jy = jab.iterative(jnp.asarray(x), step, (jnp.zeros(3), jnp.zeros(())), 0,
                                 reverse=True)
    _same(tt, jt)
    _same(tn, jn)
    _same(ty, jy)
    np.testing.assert_array_equal(ty[-1].numpy(), x[-1])  # the first step visited


def _empty_step(carry, s):
    total, count = carry
    return (total + s, count + 1), total * 2.0 + s


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_iterative_over_an_empty_axis_is_lax_scan_s(axis, reverse):
    """No slice: the carry (a tuple here) comes back as given and the ys are
    an empty stack of the step's slice shape on ``axis``."""
    shape = [3, 4, 2]
    shape[axis] = 0
    x = np.zeros(shape, np.float32)
    rest = tuple(d for a, d in enumerate(shape) if a != axis)
    init = (np.arange(np.prod(rest), dtype=np.float32).reshape(rest), np.float32(2))
    (tt, tn), ty = tab.iterative(torch.from_numpy(x), _empty_step,
                                 (torch.from_numpy(init[0]), torch.tensor(init[1])), axis,
                                 reverse=reverse)
    (jt, jn), jy = jab.iterative(jnp.asarray(x), _empty_step,
                                 (jnp.asarray(init[0]), jnp.asarray(init[1])), axis,
                                 reverse=reverse)
    _same(tt, jt)
    _same(tn, jn)
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32 and jy.dtype == jnp.float32
    assert tuple(ty.shape) == tuple(shape)


@pytest.mark.parametrize("reverse", [False, True])
def test_iterative_over_an_empty_axis_dict_ys(reverse):
    """A dict of ys of two dtypes over an empty axis 1, against ``lax.scan``
    with its ys moved back (the reference's ``moveaxis`` takes one array)."""
    x = np.zeros((3, 0, 2), np.float32)

    def step(to_int):
        return lambda c, s: (c + s, {"sum": c + s, "key": to_int(s), "row": s[0]})

    tc, ty = tab.iterative(torch.from_numpy(x), step(lambda s: s.to(torch.int32)),
                           torch.ones(3, 2), 1, reverse=reverse)
    jc, jy = jax.lax.scan(step(lambda s: s.astype(jnp.int32)), jnp.ones((3, 2)),
                          jnp.moveaxis(jnp.asarray(x), 1, 0), reverse=reverse)
    jy = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), jy)
    _same(tc, jc)
    assert set(ty) == set(jy) == {"sum", "key", "row"}
    for k in ty:
        assert tuple(ty[k].shape) == jy[k].shape, k
        assert str(ty[k].dtype) == f"torch.{jy[k].dtype}", k
    assert tuple(ty["sum"].shape) == (3, 0, 2) and tuple(ty["row"].shape) == (2, 0)


# ---------------------------------------------------------------------------
# pad_to_blocks
# ---------------------------------------------------------------------------

PAD_MODES = ["constant", "edge", "reflect", "symmetric", "wrap", "maximum", "minimum", "mean",
             "median", "linear_ramp", "empty"]
# dims of 1 and 2 padded by up to 3 (the reflections repeat), 1-D to 4-D,
# an axis past 32, a dim left as it is
PAD_CASES = [((1,), (4,)), ((2,), (4,)), ((37,), (8,)), ((10, 7), (4, 4)), ((1, 2), (4, 4)),
             ((3, 13), (2, 5)), ((12, 6), (4, 4)), ((9, 10, 11), (4, 4, 4)),
             ((2, 5, 1), (4, 4, 4)), ((5, 6, 7, 9), (4, 4, 4, 4))]


def _pad_input(shape, dtype, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return (rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


def _mean_reordered(shape, block) -> bool:
    """Where XLA's float32 mean takes another order: two or more dims
    padded, or a padded axis longer than 32."""
    padded = [d for d, b in zip(shape, block) if d % b]
    return len(padded) > 1 or any(d > 32 for d in padded)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("mode", PAD_MODES)
def test_pad_to_blocks_equals_jnp_pad(mode, dtype):
    for i, (shape, block) in enumerate(PAD_CASES):
        x = _pad_input(shape, dtype, seed=i)
        t = tab.pad_to_blocks(torch.from_numpy(x), block, mode=mode)
        j = jab.pad_to_blocks(jnp.asarray(x), block, mode=mode)
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", (shape, mode)
        if mode == "empty":
            _same(t[tuple(slice(0, d) for d in shape)], x)
        elif mode == "mean" and dtype == "float32" and _mean_reordered(shape, block):
            _close(t, j)
        else:
            _same(t, j)


@pytest.mark.parametrize("mode", ["mean", "median"])
def test_pad_to_blocks_integer_statistics_round_half_to_even(mode):
    """Means and medians of integers that end in .5 round to even, as jnp's."""
    x = np.array([[1, 2], [2, 3]], np.int32)  # 1.5 -> 2, 2.5 -> 2 along both dims
    t = tab.pad_to_blocks(torch.from_numpy(x), (4, 4), mode=mode)
    j = jab.pad_to_blocks(jnp.asarray(x), (4, 4), mode=mode)
    _same(t, j)
    assert t[2, 0] == 2 and t[0, 2] == 2


def test_pad_to_blocks_keeps_a_fitting_array_and_rejects_other_modes():
    x = torch.from_numpy(_field((8, 4), seed=9))
    assert tab.pad_to_blocks(x, (4, 4), mode="reflect") is x
    for mode in ("bogus", "Edge", "stat"):
        with pytest.raises(ValueError, match=repr(mode)):
            tab.pad_to_blocks(torch.zeros(3), (4,), mode=mode)


# ---------------------------------------------------------------------------
# map & process
# ---------------------------------------------------------------------------


def test_map_and_process_elementwise_bit_identical():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64,)).astype(np.float32)
    ids = rng.integers(-1, 4, 64).astype(np.int32)  # -1 and 3: outside [0, 3)
    fns = [lambda v: v, lambda v: 2 * v, lambda v: -v]
    t = tab.map_and_process(torch.from_numpy(x), torch.from_numpy(ids), fns)
    j = jab.map_and_process(jnp.asarray(x), jnp.asarray(ids), fns)
    _same(t, j)
    outside = (ids < 0) | (ids >= 3)
    np.testing.assert_array_equal(t.numpy()[outside], x[outside])  # fns[0]'s value


def test_map_and_process_non_elementwise_sees_the_whole_array():
    """``fn`` that is not elementwise (centred on the whole array's mean, a
    stencil): each sees every element, as the reference's masked-dense
    form; a per-subset gather would change both."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 9)).astype(np.float32)
    ids = rng.integers(-2, 5, (8, 9)).astype(np.int32)
    t = tab.map_and_process(
        torch.from_numpy(x), torch.from_numpy(ids),
        [lambda v: v - v.mean(), lambda v: torch.roll(v, 1, 0) + v, lambda v: v * 3.0])
    j = jab.map_and_process(
        jnp.asarray(x), jnp.asarray(ids),
        [lambda v: v - v.mean(), lambda v: jnp.roll(v, 1, 0) + v, lambda v: v * 3.0])
    _close(t, j)
    exact = (ids == 1) | (ids == 2)
    np.testing.assert_array_equal(_bits(t.numpy()[exact]), _bits(np.asarray(j)[exact]))


def test_map_and_process_param_bit_identical():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(33, 17)).astype(np.float32)
    ids = rng.integers(0, 5, (33, 17)).astype(np.int32)
    params = rng.uniform(0.1, 2, 5).astype(np.float32)
    t = tab.map_and_process_param(torch.from_numpy(x), torch.from_numpy(ids).long(),
                                  lambda v, b: v / b, torch.from_numpy(params))
    j = jab.map_and_process_param(jnp.asarray(x), jnp.asarray(ids), lambda v, b: v / b,
                                  jnp.asarray(params))
    _same(t, j)


# ---------------------------------------------------------------------------
# global pipeline, GEM / DEM programs
# ---------------------------------------------------------------------------


def test_global_pipeline_matches_reference():
    x = _field((100,), seed=9)
    t = tab.global_pipeline(lambda v: v * 0.5, lambda v: v + 1.0)(torch.from_numpy(x))
    j = jab.global_pipeline(lambda v: v * 0.5, lambda v: v + 1.0)(jnp.asarray(x))
    _same(t, j)
    t = tab.global_pipeline(lambda v: v - v.mean(), lambda v: v / (v.std(correction=0) + 1e-9))(
        torch.from_numpy(x))
    j = jab.global_pipeline(lambda v: v - jnp.mean(v), lambda v: v / (jnp.std(v) + 1e-9))(
        jnp.asarray(x))
    assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-5  # normalised values, sums reordered


def test_gem_program_multi_stage_bit_identical():
    x = _field((8, 12, 4), seed=10)
    stages = (lambda b, s: b * s, lambda b, s: b - 1.0, lambda b, s: torch.abs(b) if
              isinstance(b, torch.Tensor) else jnp.abs(b))
    tp = tm.GEMProgram(block_shape=(4, 4, 4), stages=stages, name="three")
    jp = jm.GEMProgram(block_shape=(4, 4, 4), stages=stages, name="three")
    _same(tm.run_gem(tp, torch.from_numpy(x), 3.0), jm.run_gem(jp, jnp.asarray(x), 3.0))
    # a stage that changes the block shape: blocks come back as they are
    tq = tm.GEMProgram(block_shape=(4, 4, 4), stages=(lambda b: b[0],))
    jq = jm.GEMProgram(block_shape=(4, 4, 4), stages=(lambda b: b[0],))
    out = tm.run_gem(tq, torch.from_numpy(x))
    assert tuple(out.shape) == (6, 4, 4)
    _same(out, jm.run_gem(jq, jnp.asarray(x)))
    blocks, counts = tm.block_view(torch.from_numpy(x), (4, 4, 4))
    np.testing.assert_array_equal(tm.unblock_view(blocks, counts, (4, 4, 4)).numpy(), x)


def test_dem_program_fused_and_cached():
    x = _field((50,), seed=11)
    stages = (lambda d, a: d + a, lambda d, a: d * d)
    tp = tm.DEMProgram(stages=stages, name="sq")
    jp = jm.DEMProgram(stages=stages, name="sq")
    _same(tm.run_dem(tp, torch.from_numpy(x), 2.0), jm.run_dem(jp, jnp.asarray(x), 2.0))
    _same(tm.jitted_dem(tp)(torch.from_numpy(x), 2.0), jm.jitted_dem(jp)(jnp.asarray(x), 2.0))
    assert tm.jitted_dem(tp) is tm.jitted_dem(tp)
    assert tm.jitted_dem(tm.DEMProgram(stages=stages, name="sq")) is tm.jitted_dem(tp)
    with pytest.raises(Exception):  # frozen, as the reference's
        tp.name = "other"


# ---------------------------------------------------------------------------
# the adapter registry
# ---------------------------------------------------------------------------


def test_adapter_resolve_and_default_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert adapters.resolve("torch") == adapters.TORCH
    for req in (None, "auto", "cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            adapters.resolve(req)
    with pytest.raises(ValueError, match="CUDA"):
        adapters.default_adapter()
    with pytest.raises(ValueError, match="unknown backend"):
        adapters.resolve("xla")


def test_adapter_default_is_cuda_with_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert adapters.default_adapter() == adapters.CUDA
    assert adapters.resolve(None) == adapters.CUDA


def test_dispatch_unknown_op_raises_key_error(monkeypatch):
    with pytest.raises(KeyError):
        adapters.dispatch("nonexistent_op", "torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(KeyError):
        adapters.dispatch("nonexistent_op", "cuda")
    # an op that lacks only the requested backend keeps raising NotImplementedError
    adapters.register("probe_torch_only_op", adapters.TORCH)(lambda: None)
    with pytest.raises(NotImplementedError, match="cuda"):
        adapters.dispatch("probe_torch_only_op", "cuda")


def test_registered_ops_is_a_copy():
    ops = adapters.registered_ops()
    assert callable(ops[("histogram", "torch")]) and ("histogram", "cuda") in ops
    ops.clear()
    assert adapters.registered_ops()
