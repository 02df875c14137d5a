"""The port's optimizer side (``repro_torch.optim``: the schedules, AdamW and
error-feedback gradient compression) and the model-FLOP half of
``repro_torch.runtime.roofline`` against the reference, on the CPU.

Tolerances:
  * schedules — float32, equal to the reference's; the cosine's last bit
    may differ at a few steps (XLA's float32 ``cos`` against the port's,
    rounded from float64): at most 1 ulp;
  * AdamW — after each of three steps every value within 2^-21 of its
    magnitude (2 ulp: the global norm is a float32 sum in another order,
    so the clip scale may differ in its last bit, and ``b ** step`` is
    another ``pow``) plus, where the step's sum cancels, 2^-20 of its
    terms: the learning rate for a parameter, the leaf's largest
    magnitude for a moment; the in-place form equals the functional form
    bit for bit;
  * grad compression — the int8 mantissas and float32 scales bit for bit,
    the error-feedback residual within 1 ulp of the values it subtracts
    (XLA fuses that subtraction into a multiply-add);
  * roofline — parameter counts, FLOPs and bytes equal.
Every input comes from a numpy seed.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jschedule
from repro.runtime import fault as jfault
from repro.runtime import roofline as jroofline
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.core import api
from repro_torch.core.context import GLOBAL_CMM
from repro_torch.models import build_model
from repro_torch.optim import adamw, grad_compress as gc, schedule
from repro_torch.runtime import fault, roofline

ROOT = Path(__file__).resolve().parents[1]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(_bits(a) - _bits(b))
    return int(np.where(both_nan, 0, d).max(initial=0))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHED_CASES = [(3e-4, 1, 6), (3e-4, 5, 50), (1.0, 10, 100), (1e-2, 0, 7), (2.5e-3, 3, 33)]


@pytest.mark.parametrize("name", ["cosine", "wsd"])
@pytest.mark.parametrize("peak,warmup,total", SCHED_CASES)
def test_schedule_matches_reference_in_float32(name, peak, warmup, total):
    differ = 0
    for step in range(total + 6):
        want = np.float32(jschedule.SCHEDULES[name](step, peak_lr=peak, warmup=warmup,
                                                    total=total))
        got = schedule.SCHEDULES[name](step, peak_lr=peak, warmup=warmup, total=total)
        from_tensor = schedule.SCHEDULES[name](torch.tensor(step, dtype=torch.int32),
                                               peak_lr=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32 and from_tensor.item() == got.item()
        differ += int(np.float32(got.item()) != want)
        assert _ulps(got.item(), want) <= (1 if name == "cosine" else 0), (step, got, want)
    assert differ <= 2  # a few last bits of XLA's cos, never more


def test_schedule_follows_the_optimizer_step_tensor():
    step = torch.tensor(7, dtype=torch.int32)
    assert schedule.cosine(step, peak_lr=1.0, warmup=2, total=20).device == step.device
    assert float(schedule.wsd(step, peak_lr=1.0, warmup=2, total=20)) == 1.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES_TREE = {"attn": {"w": (33, 17), "b": (17,)}, "embed": {"table": (50, 8)},
               "layers": (5, 3, 2), "scalar": ()}


def _tree(rng, scale=1.0):
    def make(s):
        return (rng.normal(size=s) * scale).astype(np.float32)
    return jax.tree.map(make, SHAPES_TREE, is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _np(tree):
    return jax.tree.map(lambda a: a.float().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a, np.float32), tree)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    words = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(words), b.view(words))


def _assert_close(ref_tree, tree, atol: float | None = None) -> None:
    """Within 2^-21 relative plus ``atol`` (default: 2^-20 of the leaf's
    largest magnitude)."""
    for a, b in zip(jax.tree.leaves(_np(ref_tree)), jax.tree.leaves(_np(tree))):
        finite = np.abs(a[np.isfinite(a)])
        tol = 2.0 ** -20 * float(finite.max(initial=0.0)) if atol is None else atol
        np.testing.assert_allclose(b, a, rtol=2.0 ** -21, atol=tol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nan_at", [None, 1])
def test_adamw_matches_reference_functional_and_in_place(moment_dtype, nan_at):
    """Three steps with the clip active (|g| ~ 90, clip 1.0); with
    ``nan_at`` one gradient holds a NaN at that step: the reference's guard
    keeps the parameters and still advances the moments (to NaN) and the
    step, and the next finite step writes NaN parameters."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jcfg = jadamw.AdamWConfig(moment_dtype=moment_dtype)
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jadamw.init_state(jp, jcfg)
    fp = _torch(p0)
    fstate = adamw.init_state(fp, cfg)
    ip = _torch(p0)
    istate = adamw.init_state(ip, cfg)
    assert fstate["m"]["attn"]["w"].dtype == getattr(torch, moment_dtype)
    for step in range(3):
        g = _tree(rng, 3.0)
        if step == nan_at:
            g["attn"]["w"][4, 5] = np.nan
        lr = np.float32(1e-2 * (step + 1))
        jnew, jstate, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), jstate,
                                                jnp.float32(lr), jcfg)
        jp, jfinite = jfault.skip_nonfinite_update(jnew, jp, jax.tree.map(jnp.asarray, g))
        fnew, fstate, fm = adamw.apply_updates(fp, _torch(g), fstate, torch.tensor(lr), cfg)
        fp, ffinite = fault.skip_nonfinite_update(fnew, fp, _torch(g))
        im = adamw.apply_updates_(ip, _torch(g), istate, torch.tensor(lr), cfg)
        assert bool(jfinite) == bool(ffinite) == bool(im["finite"]) == (step != nan_at)
        assert _ulps(float(jm["grad_norm"]), float(fm["grad_norm"])) <= 2
        assert int(istate["step"]) == int(fstate["step"]) == int(jstate["step"]) == step + 1
        for ref, fun, inp, atol in ((jp, fp, ip, float(lr) * 2.0 ** -20),
                                    (jstate["m"], fstate["m"], istate["m"], None),
                                    (jstate["v"], fstate["v"], istate["v"], None)):
            _assert_close(ref, fun, atol)
            for a, b in zip(jax.tree.leaves(fun), jax.tree.leaves(inp)):
                assert _same_bits(a, b)
    if nan_at is not None:  # the reference's guard lets the poisoned moments through
        assert np.isnan(np.asarray(jp["attn"]["w"])).all()
        assert torch.isnan(ip["attn"]["w"]).all()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("magnitude", [1e-18, 1e-20, 1e-22])
def test_adamw_at_tiny_gradients_flushes_as_the_reference(moment_dtype, magnitude):
    """Three steps at |g| ~ ``magnitude``: XLA flushes the subnormal squares
    (the norm is 0.0 from 1e-20 down) and the subnormal products of the
    moments.  Parameters, ``m`` and ``v`` equal the reference's bit for bit
    in both forms; ``grad_norm`` is within the 2 ulps of the test above and
    0.0 where the reference's is."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    jcfg = jadamw.AdamWConfig(moment_dtype=moment_dtype)
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jadamw.init_state(jp, jcfg)
    fp, ip = _torch(p0), _torch(p0)
    fstate, istate = adamw.init_state(fp, cfg), adamw.init_state(ip, cfg)
    for step in range(3):
        g = _tree(rng, magnitude)
        lr = np.float32(1e-3)
        jp, jstate, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), jstate,
                                              jnp.float32(lr), jcfg)
        fp, fstate, fm = adamw.apply_updates(fp, _torch(g), fstate, torch.tensor(lr), cfg)
        im = adamw.apply_updates_(ip, _torch(g), istate, torch.tensor(lr), cfg)
        jnorm = float(jm["grad_norm"])
        for norm in (float(fm["grad_norm"]), float(im["grad_norm"])):
            assert _ulps(jnorm, norm) <= 2 and (norm == 0.0) == (jnorm == 0.0), (jnorm, norm)
        if magnitude <= 1e-20:
            assert jnorm == 0.0
        for ref, fun, inp in ((jp, fp, ip), (jstate["m"], fstate["m"], istate["m"]),
                              (jstate["v"], fstate["v"], istate["v"])):
            for a, b, c in zip(jax.tree.leaves(ref), jax.tree.leaves(fun), jax.tree.leaves(inp)):
                want = torch.from_numpy(np.asarray(a).view(
                    np.int16 if a.dtype == jnp.bfloat16 else np.int32).copy())
                assert torch.equal(b.view(want.dtype), want), (step, b, a)
                assert _same_bits(b, c)


def test_adamw_in_place_keeps_old_parameters_on_a_nan_gradient():
    rng = np.random.default_rng(1)
    params = _torch(_tree(rng))
    before = {k: v.clone() for k, v in params["attn"].items()}
    state = adamw.init_state(params, adamw.AdamWConfig())
    grads = _torch(_tree(rng))
    grads["scalar"] = torch.tensor(float("inf"))
    out = adamw.apply_updates_(params, grads, state, 1e-3, adamw.AdamWConfig())
    assert not bool(out["finite"]) and int(state["step"]) == 1
    assert all(torch.equal(params["attn"][k], before[k]) for k in before)
    # an infinite norm makes the clip scale 0: inf·0 is NaN in that leaf alone
    assert torch.isnan(state["m"]["scalar"]) and not state["m"]["attn"]["w"].any()


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def _tiny_blocks(g: np.ndarray, rng) -> np.ndarray:
    """Blocks 1-3 of ``g`` (where it has them) rescaled so that their
    largest magnitude is subnormal (1e-39), a tiny normal whose scale
    underflows (2e-37) and a tiny normal whose scale does not (1e-33):
    XLA flushes subnormal inputs and results."""
    for i, top in zip(range(1, 4), (1e-39, 2e-37, 1e-33)):
        blk = g[i * 256:(i + 1) * 256]
        if blk.size:
            blk[:] = (rng.normal(size=blk.size) * top / 3).astype(np.float32)
            blk[::5] = 0.0
    return g


@pytest.mark.parametrize("n", [1, 255, 257, 5000])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_blocks_bit_identical(n, bits):
    rng = np.random.default_rng(n + bits)
    g = rng.normal(size=n).astype(np.float32)
    g[::7] = 0.0
    g[1:2] = 0.5 * (g[1:2] != 0) + 0.5  # a tie of the rounding in some block
    g = _tiny_blocks(g, rng)
    jq, js = jgc.quantize_blocks(jnp.asarray(g), bits=bits)
    q, s = gc.quantize_blocks(torch.from_numpy(g), bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(js)))
    np.testing.assert_array_equal(
        gc.dequantize_blocks(q, s, (n,)).numpy(),
        np.asarray(jgc.dequantize_blocks(jq, js, (n,))))
    np.testing.assert_array_equal(gc.compress_decompress(torch.from_numpy(g), bits).numpy(),
                                  np.asarray(jgc.compress_decompress(jnp.asarray(g), bits)))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_dequantize_blocks_of_an_inf_block_bit_identical(dtype):
    """A block holding inf has scale inf: ``0 · inf`` is NaN, which the
    reference's bfloat16 cast writes as 0xFFC0 (and ``1 / inf · inf`` too)."""
    g = np.random.default_rng(5).normal(size=700).astype(np.float32)
    g[3] = np.inf
    g[600] = -np.inf
    jout = np.asarray(jgc.compress_decompress(jnp.asarray(g).astype(dtype), 8))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = gc.compress_decompress(torch.from_numpy(g).to(tdt), 8)
    assert out.dtype == tdt
    words = np.int16 if dtype == jnp.bfloat16 else np.int32
    np.testing.assert_array_equal(out.view({np.int16: torch.int16,
                                            np.int32: torch.int32}[words]).numpy(),
                                  jout.view(words))
    assert np.isnan(jout[:256].astype(np.float32)).all()


def test_quantize_blocks_zero_block_and_shape():
    g = torch.zeros((3, 100))
    q, s = gc.quantize_blocks(g)
    assert q.shape == (2, gc.BLOCK) and torch.equal(s, torch.ones(2))
    assert torch.equal(gc.dequantize_blocks(q, s, (3, 100)), g)


def test_ef_step_matches_reference_and_hits_the_cmm():
    rng = np.random.default_rng(3)
    shape = (37, 29)
    g = _tiny_blocks(rng.normal(size=shape).astype(np.float32).reshape(-1), rng).reshape(shape)
    res = (rng.normal(size=shape) * 0.01).astype(np.float32)
    res.reshape(-1)[256:768] = g.reshape(-1)[256:768] * np.float32(0.5)
    (jq, js), jres = jgc.ef_step(jnp.asarray(g), jnp.asarray(res), bits=8)
    before = GLOBAL_CMM.stats()
    (q, s), new_res = gc.ef_step(torch.from_numpy(g), torch.from_numpy(res), bits=8)
    mid = GLOBAL_CMM.stats()
    (q2, s2), res2 = gc.ef_step(torch.from_numpy(g), torch.from_numpy(res), bits=8)
    after = GLOBAL_CMM.stats()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(js)))
    # XLA fuses corrected - q·scale into one multiply-add; the port rounds
    # the product first: within 1 ulp of the operands, not of the residual
    corrected = g + res
    approx = gc.dequantize_blocks(q, s, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(corrected), np.abs(approx)))
    assert (np.abs(new_res.numpy() - np.asarray(jres)) <= ulp).all()
    # the residual is flushed as the reference's: no subnormal survives, and
    # blocks 1 and 2 (elements 256-767: a subnormal block and one whose
    # scale underflows, where no multiply-add rounds) are the reference's
    # bit for bit
    tiny = np.finfo(np.float32).tiny
    assert not ((np.abs(new_res.numpy()) < tiny) & (new_res.numpy() != 0)).any()
    np.testing.assert_array_equal(_bits(new_res.numpy().reshape(-1)[256:768]),
                                  _bits(np.asarray(jres).reshape(-1)[256:768]))
    assert torch.equal(q2, q) and torch.equal(res2, new_res)
    assert after["hits"] == mid["hits"] + 1 and after["misses"] == mid["misses"]
    assert mid["hits"] + mid["misses"] == before["hits"] + before["misses"] + 1


_WORKER = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.optim import grad_compress as gc
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=__import__("datetime").timedelta(seconds=60))
    g = np.random.default_rng(10 + rank).normal(size=(3, 301)).astype(np.float32)
    mean = gc.pod_compressed_mean(torch.from_numpy(g))
    tree = gc.tree_pod_compressed_mean({"a": torch.from_numpy(g), "b": [torch.from_numpy(g[0])]})
    np.savez(out, mean=mean.numpy(), a=tree["a"].numpy(), b=tree["b"][0].numpy())
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_compressed_mean_over_two_gloo_ranks(tmp_path):
    """Two processes on a gloo group: each rank's result is the mean of the
    reference's per-rank dequantized blocks, bit for bit."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port),
                               str(tmp_path / f"r{r}.npz")], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    for p in procs:
        _out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    gs = [np.random.default_rng(10 + r).normal(size=(3, 301)).astype(np.float32)
          for r in range(2)]
    deq = [np.asarray(jgc.dequantize_blocks(*jgc.quantize_blocks(jnp.asarray(g)), g.shape))
           for g in gs]
    want = (deq[0] + deq[1]) / np.float32(2)
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        np.testing.assert_array_equal(got["mean"], want)
        np.testing.assert_array_equal(got["a"], want)
        deq0 = [np.asarray(jgc.dequantize_blocks(*jgc.quantize_blocks(jnp.asarray(g[0])),
                                                 g[0].shape)) for g in gs]
        np.testing.assert_array_equal(got["b"], (deq0[0] + deq0[1]) / np.float32(2))


# ---------------------------------------------------------------------------
# roofline: the model-FLOP half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b", "mamba2-370m", "qwen2-vl-72b",
                                  "deepseek-v3-671b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_roofline_counts_flops_and_bytes_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    jcounts = jroofline.count_params(jshapes)
    shapes = build_model(cfg).param_shapes()
    assert shapes["embed"]["table"].device.type == "meta"
    # the parameters' tree: every leaf's path, shape and dtype the reference's
    jflat = {k: (tuple(a.shape), str(a.dtype)) for k, a in api.flatten_with_keys(jshapes)}
    flat = {k: (tuple(t.shape), api.dtype_name(t)) for k, t in api.flatten_with_keys(shapes)}
    assert flat == jflat
    counts = roofline.count_params(shapes)
    assert counts == jcounts
    assert roofline.active_params(cfg, counts) == jroofline.active_params(jcfg, jcounts)
    nbytes = 4 * sum(counts.values())
    for name in applicable_shapes(cfg):  # long_500k where the decode state is sub-quadratic
        assert roofline.model_flops(cfg, SHAPES[name], counts) == \
            jroofline.model_flops(jcfg, JSHAPES[name], jcounts)
        for chips in (1, 4):
            assert roofline.analytic_memory_bytes(cfg, SHAPES[name], counts, nbytes, chips) \
                == jroofline.analytic_memory_bytes(jcfg, JSHAPES[name], jcounts, nbytes, chips)
    assert roofline._decode_state_bytes(cfg, 4, 8192) == \
        jroofline._decode_state_bytes(jcfg, 4, 8192)


def test_roofline_terms_use_the_h100_datasheet():
    t = roofline.terms_from_analysis({"bytes accessed": 3.35e12}, 450e9, flops_override=989e12)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 1.0)
    assert t.bound_time == 1.0 and t.to_dict()["flops_per_device"] == 989e12
    t = roofline.terms_from_analysis({"flops": 2 * 989e12, "bytes accessed": 0.0}, 0.0)
    assert t.dominant == "compute" and t.t_compute == 2.0
    assert roofline.HBM_PER_CHIP == 80e9
