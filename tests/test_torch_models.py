"""The port's dense decode path (``repro_torch.models``, ``repro_torch.configs``)
and ``ServingEngine`` against the reference's, on the CPU.

qwen2.5-3b's smoke cut (4 layers, d_model 64, 4 heads of 16, 2 KV heads,
vocab 256, float32 compute) is initialised by the reference and carried
across with ``load_params``; both packages then decode the same tokens.
Tolerance: logits within 1e-5 absolute (about 2e-5 of their largest
magnitude; float32 sums in another order), the KV cache within 1e-5, and
greedy tokens equal.  The port's cache is written in place; the
reference's is returned anew.
"""

import os
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model, load_params
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config("qwen2.5-3b").smoke()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen2.5-3b").smoke()
    model = build_model(cfg)
    params = load_params(jax.tree.map(np.asarray, jparams), torch.device("cpu"))
    return jmodel, jparams, model, params


def test_config_is_the_reference_s():
    for ours, theirs in ((get_config("qwen2.5-3b"), jget_config("qwen2.5-3b")),
                         (get_config("qwen2.5-3b").smoke(), jget_config("qwen2.5-3b").smoke())):
        assert asdict(ours) == asdict(theirs)
        assert ours.resolved_head_dim == theirs.resolved_head_dim
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("mamba2-370m")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-17")


def test_init_has_the_reference_structure_and_scales(pair):
    jmodel, jparams, model, params = pair
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(jax.tree.map(np.asarray, jparams)) == shapes(mine) == shapes(params)
    d = model.cfg.d_model
    assert mine["layers"]["attn"]["wq"]["b"].abs().max() == 0
    assert mine["layers"]["ln1"]["scale"].abs().max() == 0
    assert abs(float(mine["layers"]["attn"]["wq"]["w"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(mine["embed"]["table"].std()) - 0.02) < 0.002
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["mlp"]["wd"], mine["layers"]["mlp"]["wd"])


def test_decode_step_logits_match_reference(pair):
    jmodel, jparams, model, params = pair
    batch, max_len = 3, 12
    jcache = jmodel.init_cache(batch, max_len, jnp.float32)
    cache = model.init_cache(batch, max_len, torch.float32, "cpu")
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape) == (4, batch, max_len, 2, 16)
    rng = np.random.default_rng(0)
    for step in range(max_len + 3):  # past max_len: the ring write wraps
        tok = rng.integers(0, model.cfg.vocab, batch).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(step))
        logits, out = model.decode_step(params, torch.from_numpy(tok), cache, step)
        assert out is cache  # written in place
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (batch, 256)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=0, atol=ATOL)


def test_decode_step_in_bfloat16_stays_close(pair):
    """qwen2.5-3b's own compute dtype: bfloat16 over float32 parameters."""
    jmodel, jparams, model, params = pair
    jcfg = replace(jmodel.cfg, dtype="bfloat16")
    jm = jbuild(jcfg)
    m = build_model(replace(model.cfg, dtype="bfloat16"))
    jcache = jm.init_cache(2, 8, jnp.float32)
    cache = m.init_cache(2, 8, torch.float32, "cpu")
    tok = np.array([3, 200], np.int32)
    jl, _ = jm.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(0))
    tl, _ = m.decode_step(params, torch.from_numpy(tok), cache, 0)
    assert tl.dtype == torch.bfloat16
    ref = np.asarray(jl.astype(jnp.float32))
    # bfloat16 keeps 8 bits: a few rounding steps of the largest logit
    assert np.abs(tl.float().numpy() - ref).max() <= 2 ** -5 * (np.abs(ref).max() + 1)


def _requests(cls, vocab, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, 5).astype(np.int32), max_new_tokens=6)
            for i in range(n)]


def test_serve_tokens_equal_reference(pair):
    """Four requests on two slots (the refill path): the same greedy tokens
    as the reference's engine on the same weights."""
    jmodel, jparams, model, params = pair
    vocab = model.cfg.vocab
    reqs, jreqs = _requests(Request, vocab), _requests(JRequest, vocab)
    stats = ServingEngine(model, params, 2, 64).serve(reqs)
    JServingEngine(jmodel, jparams, 2, 64).serve(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert stats["requests"] == 4 and stats["new_tokens"] == 24
    assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
    assert all(0 <= t < vocab for r in reqs for t in r.out_tokens)


def test_greedy_decode_is_deterministic(pair):
    _jmodel, _jparams, model, params = pair
    prompt = np.random.default_rng(2).integers(0, model.cfg.vocab, 4).astype(np.int32)
    r1 = Request(uid=0, prompt=prompt, max_new_tokens=5)
    r2 = Request(uid=0, prompt=torch.from_numpy(prompt), max_new_tokens=5)
    ServingEngine(model, params, 1, 32).serve([r1])
    ServingEngine(model, params, 1, 32).serve([r2])
    assert r1.out_tokens == r2.out_tokens


def test_unported_families_raise():
    cfg = replace(get_config("qwen2.5-3b").smoke(), family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg).init(torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(replace(get_config("qwen2.5-3b").smoke(), kv_replicate=2)).init_cache(1, 4)


def test_port_imports_no_jax_or_reference_in_a_subprocess():
    """Importing every module of the port (serving and models included)
    loads no ``jax`` and nothing of ``repro``."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serving.server' in sys.modules\n"
        "assert 'repro_torch.models.model' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_default_to_the_card():
    """Without ``device`` the cache and the weights go to the card; with no
    card that raises (the CPU is asked for by name, as these tests do)."""
    model = build_model(get_config("qwen2.5-3b").smoke())
    if torch.cuda.is_available():
        assert model.init_cache(1, 4)["k"].device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        model.init_cache(1, 4)
    with pytest.raises((RuntimeError, AssertionError)):
        model.init(torch.Generator())
