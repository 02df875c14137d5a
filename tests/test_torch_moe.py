"""The port's moe family (``repro_torch.models.moe``, MLA in
``repro_torch.models.attention``; deepseek-v3-671b and
llama4-scout-17b-a16e) against the reference's, on the CPU.

Both smoke cuts (d_model 64, 4 heads of 16, 4 routed experts of width 64
plus 1 shared, vocab 256, float32; deepseek-v3: MLA with ranks 32 / 16,
rope 8, 1 dense layer then 3 MoE layers, top-2, MTP; llama4-scout: GQA
with 4 KV heads, 4 MoE layers, top-1) are initialised by the reference and
carried across with ``load_params``; inputs come from numpy seeds.
Tolerances:
  * routing (top-k indices, capacity positions, the keep mask) identical,
    on logits with exact ties too (the lower index first, as
    ``jax.lax.top_k``);
  * the softmax probabilities within 2e-6 relative (XLA's float32 ``exp``
    is 1 ulp off the port's here and there, and it sums in another order:
    a few ulp), so the gates, normalised over the k chosen, within 4 ulp of
    the reference's (2 seen), and summing to 1 within 1e-5 (the
    reference's own test);
  * ``moe_layer``'s output within 1e-5 of its largest magnitude (a token's
    k routed products summed in another order), the aux loss within 1e-6
    relative (float32 means in another order);
  * MLA, the loss, its terms and the decode logits in float32: within 1e-5
    of their largest magnitude (the loss terms relative to each);
    gradients within 1e-4 of each leaf's largest magnitude (the router's
    gradient is the aux loss's plus the rounding noise of the normalised
    gates, zero in exact arithmetic at top-1);
  * parked caches: the reference's containers, byte for byte, and the same
    greedy tokens decoded from the restored cache.
"""

import math
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.serving import engine as jengine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import api
from repro_torch.core import engine as tengine
from repro_torch.models import attention, build_model, load_params, moe
from repro_torch.serving import KVPageStore, Request, ServingEngine, compress_kv_cache

CPU = torch.device("cpu")
ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e")


def _pair(arch, **kw):
    jmodel = jbuild(replace(jget_config(arch).smoke(), **kw))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(replace(get_config(arch).smoke(), **kw))
    return jmodel, jparams, model, load_params(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def jdecode(pairs):
    """The reference's decode step, jitted once an arch."""
    return {arch: jax.jit(pairs[arch][0].decode_step) for arch in ARCHS}


def _close(got: torch.Tensor, want, rel: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got.detach().float().numpy() - want).max()) <= bound, what


def _batch(vocab: int, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    return jb, tb


def _blob(v) -> bytes:
    """A parked leaf's bytes: a container's, or a raw leaf's values."""
    if hasattr(v, "to_bytes"):
        return v.to_bytes()
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).tobytes()


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _tree_specs(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_s(arch, pairs):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_config(arch).smoke(), jget_config(arch).smoke())):
        assert asdict(ours) == asdict(theirs)
    assert arch not in NOT_PORTED
    assert NOT_PORTED == ()
    # the port's own init has the reference's tree, the MTP block unstacked
    _jm, jparams, model, _p = pairs[arch]
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    assert _tree_specs(jax.tree.map(np.asarray, jparams)) == _tree_specs(mine)
    assert abs(float(mine["moe_layers"]["moe"]["wg"].std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5


# ---------------------------------------------------------------------------
# gating and routing
# ---------------------------------------------------------------------------


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("k,ties", [(1, False), (2, False), (2, True), (8, True)])
def test_top_k_gating_matches_reference(k, ties):
    rng = np.random.default_rng(k + 10 * ties)
    e = 16
    if ties:  # a few distinct values a row: most choices are among equals
        logits = rng.integers(0, 3, (256, e)).astype(np.float32)
        logits[0] = 1.0  # a row of one value: the first k experts
    else:
        logits = rng.normal(size=(256, e)).astype(np.float32)
    jprobs, jgates, jidx = jmoe._top_k_gating(jnp.asarray(logits), k)
    probs, gates, idx = moe._top_k_gating(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _ulps(gates.numpy(), np.asarray(jgates)) <= 4
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=2e-6, atol=0)
    np.testing.assert_allclose(gates.numpy().sum(-1), 1.0, rtol=1e-5)
    if ties:
        assert list(idx[0].numpy()) == list(range(k))


def _jroute(x, router, cfg, capacity_factor):
    """The reference's routing, its ``moe_layer`` lines through ``keep``."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    e, k = m.n_experts, m.top_k
    logits = x.reshape(t, -1).astype(jnp.float32) @ router.astype(jnp.float32)
    _probs, _gates, idx = jmoe._top_k_gating(logits, k)
    capacity = max(1, int(math.ceil(t * k / e * capacity_factor)))
    slot_major = jnp.swapaxes(jax.nn.one_hot(idx, e, dtype=jnp.int32), 0, 1)
    pos = jnp.sum((jnp.cumsum(slot_major.reshape(k * t, e), axis=0).reshape(k, t, e)
                   - slot_major) * slot_major, axis=-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < capacity), capacity


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.1, 1.25, 2.0, 8.0])
def test_moe_layer_matches_reference(arch, capacity_factor, pairs):
    jmodel, jparams, model, params = pairs[arch]
    cfg = model.cfg
    x = np.random.default_rng(3).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    jp, tp = _layer(jparams["moe_layers"]["moe"], 1), _layer(params["moe_layers"]["moe"], 1)
    jidx, jpos, jkeep, jcap = _jroute(jnp.asarray(x), jp["router"], jmodel.cfg, capacity_factor)
    _probs, _gates, idx, pos, keep, cap = moe.route(torch.from_numpy(x), tp["router"], cfg,
                                                    capacity_factor)
    assert cap == jcap
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    jy, jaux = jmoe.moe_layer(jnp.asarray(x), jp, jmodel.cfg, capacity_factor)
    y, aux = moe.moe_layer(torch.from_numpy(x), tp, cfg, capacity_factor)
    _close(y, jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert float(aux) > 0
    if capacity_factor == 0.1:  # tight capacity drops tokens: the outputs change
        assert not jkeep.all()
        full, _ = moe.moe_layer(torch.from_numpy(x), tp, cfg, 8.0)
        assert float((full - y).abs().max()) > 1e-6
    if capacity_factor == 8.0:
        assert jkeep.all()


@pytest.mark.parametrize("kw", [{"moe_group_size": 16}, {"moe_impl": "a2a"}])
def test_unported_dispatches_raise(kw, pairs):
    """The mesh dispatches no longer raise: with no mesh, the grouped
    dispatch runs as the reference's does, and the all-to-all one declines
    (None) so that ``moe_layer`` takes the dense dispatch, as the
    reference's does; the same routing, the output within 1e-5 of its
    largest magnitude, the aux loss within 1e-6 relative."""
    jmodel, jp, model, params = pairs["deepseek-v3-671b"]
    cfg, jcfg = replace(model.cfg, **kw), replace(jmodel.cfg, **kw)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_layer(jnp.asarray(x), _layer(jp["moe_layers"]["moe"], 0), jcfg)
    y, aux = moe.moe_layer(torch.from_numpy(x), _layer(params["moe_layers"]["moe"], 0), cfg)
    _close(y, jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert moe.moe_layer_a2a(torch.from_numpy(x), _layer(params["moe_layers"]["moe"], 0),
                             cfg) is None
    assert _tree_specs(build_model(cfg).param_shapes()) == _tree_specs(model.param_shapes())


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_attention_and_decode_match_reference(pairs):
    """The training forward, then decode steps over a 12-token prompt: each
    step's output the reference's and the forward's row at its position,
    the compressed cache (written in place) the reference's."""
    jmodel, jparams, model, params = pairs["deepseek-v3-671b"]
    cfg = model.cfg
    jp, tp = _layer(jparams["moe_layers"]["attn"], 0), _layer(params["moe_layers"]["attn"], 0)
    x = np.random.default_rng(4).normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    want = jattn.mla_attention(jnp.asarray(x), jp, jmodel.cfg)
    full = attention.mla_attention(torch.from_numpy(x), tp, cfg)
    jstep = jax.jit(jattn.mla_decode, static_argnums=2)
    _close(full, want, 1e-5)
    m = cfg.mla
    jcache = {"c_kv": jnp.zeros((3, 16, m.kv_lora_rank)),
              "k_rope": jnp.zeros((3, 16, 1, m.qk_rope_head_dim))}
    cache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    storage = {k: v.data_ptr() for k, v in cache.items()}
    for i in range(12):
        jy, jcache = jstep(jnp.asarray(x[:, i:i + 1]), jp, jmodel.cfg, jcache, jnp.int32(i))
        y, out = attention.mla_decode(torch.from_numpy(x[:, i:i + 1].copy()), tp, cfg, cache, i)
        assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == storage
        _close(y, jy, 1e-5)
        _close(y[:, 0], full[:, i].numpy(), 1e-5)
    for k in cache:
        _close(cache[k], jcache[k], 1e-5, k)
    assert not cache["c_kv"][:, 12:].any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_cache_is_the_reference_s(arch, dtype, pairs):
    jmodel, _jp, model, _p = pairs[arch]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcache = jmodel.init_cache(2, 24, jdt)
    cache = model.init_cache(2, 24, dtype, "cpu")
    assert _tree_specs(jcache) == _tree_specs(cache)
    if arch == "llama4-scout-17b-a16e":
        assert cache["dense"] is None and set(cache["moe"]) == {"k", "v"}
    else:
        assert cache["moe"]["c_kv"].shape == (3, 2, 24, 16)
        assert cache["dense"]["k_rope"].shape == (1, 2, 24, 1, 8)


# ---------------------------------------------------------------------------
# the model: loss, gradients, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,remat", [("deepseek-v3-671b", True),
                                        ("llama4-scout-17b-a16e", False)])
def test_loss_and_grads_match_reference(arch, remat, pairs):
    """``remat`` recomputes the port's blocks in the backward (the values
    are the same either way, as the reference's ``jax.checkpoint``)."""
    jmodel, jparams, model, params = pairs[arch]
    model = build_model(replace(model.cfg, remat=remat))
    jb, tb = _batch(256, 2, 24, seed=5)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert set(met) == set(jmet)
    assert ("mtp_ce" in met) == (arch == "deepseek-v3-671b")
    for k in met:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    assert float(met["aux"]) > 0
    flat = dict(api.flatten_with_keys(grads))
    jflat = dict(api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)))
    assert set(flat) == set(jflat)
    for k, want in jflat.items():
        assert torch.isfinite(flat[k]).all(), k
        _close(flat[k], want, 1e-4, k)
    assert flat["moe_layers/moe/router"].abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, pairs, jdecode):
    jmodel, jparams, model, params = pairs[arch]
    jcache = jmodel.init_cache(4, 10, jnp.float32)
    cache = model.init_cache(4, 10, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    for step in range(3):
        tok = rng.integers(0, 256, 4).astype(np.int32)
        jlogits, jcache = jdecode[arch](jparams, jnp.asarray(tok), jcache, jnp.int32(step))
        logits, out = model.decode_step(params, torch.from_numpy(tok), cache, step)
        assert out is cache and tuple(logits.shape) == (4, 256)
        _close(logits, jlogits, 1e-5)
    for k, leaf in api.flatten_with_keys(jax.tree.map(np.asarray, jcache)):
        _close(dict(api.flatten_with_keys(cache))[k], leaf, 1e-5, k)


# ---------------------------------------------------------------------------
# serving: tokens, then the served cache parked and restored
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_park_and_restore(arch, pairs, tmp_path):
    """Four requests on two slots: the reference's greedy tokens.  The served
    cache parks into the reference's containers (the ``None`` dense stack
    of llama4-scout skipped, as the reference's tree skips it), restores
    from memory and from a spill to the same values, and the next decode
    step from the restored cache gives the reference's tokens from its own
    restore of the same containers."""
    jmodel, jparams, model, params = pairs[arch]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 5).astype(np.int32) for _ in range(4)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    engine = ServingEngine(model, params, 2, 32)
    engine.serve(reqs)
    JServingEngine(jmodel, jparams, 2, 32).serve(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]

    cache = engine.cache
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    with tengine.ExecutionEngine(devices=[CPU], backend="torch") as eng:
        flat, _stats = compress_kv_cache(cache, rate=12, engine=eng)
        jflat, _jstats = jengine.compress_kv_cache(jcache, rate=12)
        assert list(flat) == list(jflat) and all("dense" not in k for k in flat) == (
            arch == "llama4-scout-17b-a16e")
        assert [_blob(v) for v in flat.values()] == [_blob(v) for v in jflat.values()]
        store = KVPageStore(spill_dir=tmp_path / "kv", engine=eng)
        store.park("s", cache)
        resident = store.restore("s", cache)
        store.cache.evict(store._key("s"))
        spilled = store.restore("s", cache)
        assert store.stats()["loads"] == 1
    jrestored = jengine.decompress_kv_cache(jflat, jcache)
    assert (resident["dense"] is None) == (cache["dense"] is None)
    for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jrestored)):
        got = dict(api.flatten_with_keys(resident))[k]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(dict(api.flatten_with_keys(spilled))[k].numpy(), want)
        orig = dict(api.flatten_with_keys(cache))[k]
        assert float((got - orig).abs().max()) <= 0.05 * float(orig.abs().max()), k
    tok = np.array([r.out_tokens[-1] for r in reqs[:2]], np.int32)
    at = int(engine.lens.max())
    logits, _ = model.decode_step(params, torch.from_numpy(tok), resident, at)
    jlogits, _ = jmodel.decode_step(jparams, jnp.asarray(tok), jrestored, jnp.int32(at))
    _close(logits, jlogits, 1e-5)
    assert logits.argmax(-1).tolist() == np.asarray(jlogits).argmax(-1).tolist()
