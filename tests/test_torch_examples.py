"""The port's four examples (``examples/*_torch.py``) on the CPU at a small
size, each ``main``'s returned dict held against the same calls through the
reference (``repro``) on the same inputs.

quickstart (a 16^3 field): zfp and ``huffman-bytes`` stream lengths equal
the reference's, MGARD within its relative bound, the re-encode a CMM hit.
serve_batched (qwen2.5-3b's smoke cut, the reference's weights carried
across with ``load_params``): the served tokens equal the reference's, the
parked cache's ratio equals the reference's and the resumed cache is within
zfp rate 12's error (0.05 of the largest |value|).  compressed_checkpoint_io
(qwen1.5-4b's smoke cut, the reference's weights): the lossless and zfp
ratios equal the reference manager's, MGARD within its relative bound.
train_lm: 2 steps, every loss finite, its checkpoint report; the 100m preset
builds the reference's resize (the same parameter count).
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.configs import get_config as jget_config
from repro.core import api as japi
from repro.models import build_model as jbuild
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import compress_kv_cache as jcompress_kv
from repro_torch.models import load_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _jparams(arch: str, seed: int = 0):
    model = jbuild(jget_config(arch).smoke())
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed))


def test_quickstart_matches_reference_calls():
    ex = _example("quickstart")
    out = ex.main(n=16, device="cpu")
    data = ex.smooth_field(16)
    span = float(data.max() - data.min())
    assert [r["method"] for r in out["methods"]] == [m for m, _, _ in ex.METHODS]
    for row in out["methods"]:
        spec = japi.make_spec(data, row["method"], **row["params"])
        comp = japi.encode(spec, jnp.asarray(data))
        if row["method"] == "mgard":
            assert row["max_rel_err"] <= row["params"]["error_bound"]
            back = np.asarray(japi.decompress(comp))
            assert np.abs(back - data).max() / span <= row["params"]["error_bound"]
        else:
            assert row["stream_bytes"] == len(comp.to_bytes()), row
            assert row["ratio"] == comp.ratio()
    assert out["reencode_hits"] == 1
    assert out["methods"][-1]["max_rel_err"] == 0.0  # lossless


def test_serve_batched_tokens_equal_reference():
    ex = _example("serve_batched")
    jmodel, jparams = _jparams("qwen2.5-3b")
    out = ex.main(device="cpu", params=load_params(jax.tree.map(np.asarray, jparams), CPU))
    jengine = JServingEngine(jmodel, jparams, batch_size=2, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [JRequest(uid=i, prompt=rng.integers(0, jmodel.cfg.vocab, 6).astype(np.int32),
                     max_new_tokens=8) for i in range(5)]
    jstats = jengine.serve(reqs)
    assert out["tokens"] == {r.uid: list(r.out_tokens) for r in reqs}
    assert out["serve"]["new_tokens"] == jstats["new_tokens"]
    assert out["serve"]["decode_steps"] == jstats["decode_steps"]
    _, jc = jcompress_kv(jengine.cache, rate=12)
    assert out["parked"]["ratio"] == jc["ratio"]
    for key in ("k", "v"):
        want = np.asarray(jengine.cache[key])
        got = out["cache"][key].numpy()
        assert np.abs(got - want).max() <= 0.05 * max(1e-6, float(np.abs(want).max()))


def test_compressed_checkpoint_io_ratios_equal_reference(tmp_path):
    ex = _example("compressed_checkpoint_io")
    _, jparams = _jparams("qwen1.5-4b")
    out = ex.main(device="cpu", params=load_params(jax.tree.map(np.asarray, jparams), CPU))
    rows = {r["policy"]: r for r in out["policies"]}
    assert len(rows) == 4 and out["device"] == "CPU"
    span = max(float(np.ptp(np.asarray(x))) for x in jax.tree.leaves(jparams))
    policies = {
        "lossless (huffman-bytes)": JPolicy(exact=True),
        "zfp rate-28 (~1e-6 rel)": JPolicy(float_method="zfp", zfp_rate=28, lossless_small=1),
        "zfp rate-16 (transport)": JPolicy(float_method="zfp", zfp_rate=16, lossless_small=1),
    }
    for i, (name, policy) in enumerate(policies.items()):
        rep = JManager(tmp_path / str(i), policy).save(0, {"params": jparams})
        assert rows[name]["ratio"] == rep["ratio"], name
    assert rows["lossless (huffman-bytes)"]["max_abs_err"] == 0.0
    assert rows["mgard eb 1e-4"]["max_abs_err"] <= 1e-4 * span
    assert [p["ratio"] for p in out["projection"]] == ["4.0x (mgard 1e-2)", "2.6x (zfp r12)"]
    assert out["projection"][0]["write_accel"] == pytest.approx(2.2, abs=0.05)


def test_train_lm_two_steps_finite_with_checkpoint(tmp_path):
    ex = _example("train_lm")
    out = ex.main(["--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / "small")])
    assert out["finite"] and out["result"]["steps_run"] == 2
    assert np.isfinite(out["result"]["first_loss"]) and np.isfinite(out["result"]["last_loss"])
    rep = out["ckpt_report"]
    assert rep is not None and rep["step"] == 2 and rep["ratio"] > 0
    assert rep["compressed_bytes"] > 0 and rep["raw_bytes"] > 0


def test_train_lm_100m_preset_builds_the_resize(tmp_path):
    ex = _example("train_lm")
    out = ex.main(["--preset", "100m", "--steps", "0", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "big")])
    cfg = dataclasses.replace(jget_config("qwen2.5-3b").smoke(), d_model=512, n_layers=12,
                              n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab=32000)
    shapes = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    assert out["n_params"] == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert out["result"]["steps_run"] == 0
