"""The port's encdec family (``repro_torch.models.encdec``,
``cross_attention``, ``gelu_mlp``; seamless-m4t-medium) against the
reference's, on the CPU.

seamless-m4t-medium's smoke cut (2 encoder and 2 decoder layers, d_model
64, 4 heads of 16, 4 KV heads, d_ff 128, vocab 256, float32) is
initialised by the reference and carried across with ``load_params``;
inputs come from numpy seeds.  As in the reference's own tests, the family
runs through ``Model.loss`` / ``value_and_grad`` / ``init_cache`` /
``decode_step`` and ``encdec.encode`` / ``precompute_cross`` (the
reference's ``ServingEngine`` and ``train_loop`` have no ``enc_embeds``).
Tolerances:
  * ``gelu``: within 1e-6 absolute (XLA:CPU's float32 ``tanh`` is its own
    rational approximation: a few ulps off torch's near 1, and where
    ``1 + tanh`` cancels in the negative tail the difference stays below
    1e-6 absolute while its relative share grows); ``gelu_mlp`` and
    ``cross_attention`` within 1e-5 of their largest magnitude;
  * ``encode``, ``decode_train``, the loss and the decode logits in
    float32: within 1e-5 of their largest magnitude; gradients within 1e-4
    of each leaf's largest magnitude; the caches within 1e-5 of each
    leaf's largest magnitude;
  * bfloat16 compute: the loss within 1e-2 of its value.
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import api
from repro_torch.models import attention, build_model, encdec, layers, load_params

CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"


def _pair(**kw):
    jcfg = replace(jget_config(ARCH).smoke(), **kw)
    jmodel = jbuild(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(replace(get_config(ARCH).smoke(), **kw))
    return jmodel, jparams, model, load_params(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(cfg, b: int, s_enc: int, s_dec: int, seed: int):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s_dec + 1)).astype(np.int32)
    arrays = {"enc_embeds": enc, "tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _close(got: torch.Tensor, want, rel: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    diff = float(np.abs(got.detach().float().numpy() - want).max())
    assert diff <= bound, (what, diff, bound)


def _specs(tree):
    return {k: (tuple(x.shape), api.dtype_name(x)) for k, x in api.flatten_with_keys(tree)}


def test_configs_are_the_reference_s():
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_config(ARCH).smoke(), jget_config(ARCH).smoke())):
        assert asdict(ours) == asdict(theirs)
        assert ours.resolved_head_dim == theirs.resolved_head_dim
    cut = get_config(ARCH).smoke()
    assert (cut.n_enc_layers, cut.n_dec_layers, cut.family) == (2, 2, "encdec")
    assert ARCH not in NOT_PORTED and NOT_PORTED == ()


def test_init_tree_is_the_reference_s(pair):
    _jm, jparams, model, _p = pair
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    assert list(_specs(mine).items()) == list(_specs(jax.tree.map(np.asarray, jparams)).items())
    assert "ln_f" not in mine and set(mine) == {"embed", "enc_layers", "dec_layers", "ln_enc",
                                                "ln_dec", "head"}
    mlp = mine["dec_layers"]["mlp"]
    assert mlp["b1"].abs().max() == 0 and mlp["b2"].abs().max() == 0
    assert abs(float(mlp["w1"].std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    full = build_model(get_config(ARCH)).param_shapes()
    assert full["enc_layers"]["mlp"]["w1"].shape == (12, 1024, 4096)
    assert full["head"]["w"].shape == (1024, 256206)


def test_gelu_is_the_reference_s_tanh_form():
    x = np.concatenate([np.linspace(-6, 6, 10001, dtype=np.float32),
                        np.random.default_rng(0).normal(size=10000).astype(np.float32) * 3])
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    got = layers.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the erf form is another function: 4.7e-4 away on this grid
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_gelu_mlp_and_cross_attention_match_reference(pair):
    jm, jparams, model, params = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    mem = rng.normal(size=(2, 11, 64)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jparams["dec_layers"])
    tl = jax.tree.map(lambda a: a[0], params["dec_layers"])
    _close(layers.gelu_mlp(torch.from_numpy(x), tl["mlp"]),
           jax.jit(jlayers.gelu_mlp)(x, jl["mlp"]), 1e-5, "gelu_mlp")
    got = attention.cross_attention(torch.from_numpy(x), torch.from_numpy(mem), tl["cross"],
                                    model.cfg)
    want = jax.jit(lambda x, m, p: jattn.cross_attention(x, m, p, jm.cfg))(x, mem, jl["cross"])
    assert tuple(got.shape) == (2, 7, 64)
    _close(got, want, 1e-5, "cross_attention")


@pytest.mark.parametrize("remat", [False, True])
def test_encode_decode_loss_and_grads_match_reference(remat):
    jmodel, jparams, model, params = _pair(remat=remat)
    cfg = model.cfg
    jb, tb = _batch(cfg, 2, 24, 16, seed=2)
    mem = encdec.encode(params, tb["enc_embeds"], cfg)
    jmem = jax.jit(lambda p, e: jencdec.encode(p, e, jmodel.cfg))(jparams, jb["enc_embeds"])
    _close(mem, jmem, 1e-5, "encode")
    logits = encdec.decode_train(params, tb["tokens"], mem, cfg)
    jlogits = jax.jit(lambda p, t, m: jencdec.decode_train(p, t, m, jmodel.cfg))(
        jparams, jb["tokens"], jmem)
    assert tuple(logits.shape) == (2, 16, cfg.vocab)
    _close(logits, jlogits, 1e-5, "decode_train")
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert set(met) == set(jmet) == {"ce", "loss"}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = dict(api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)))
    flat = dict(api.flatten_with_keys(grads))
    assert list(flat) == list(jflat)
    for k, want in jflat.items():
        _close(flat[k], want, 1e-4, k)


def test_loss_in_bfloat16_stays_close(pair):
    """seamless-m4t-medium's own compute dtype over float32 parameters:
    ``enc_embeds`` cast to bfloat16 before the encoder, the decoder embedded
    in the memory's dtype."""
    jmodel, jparams, model, params = pair
    jb, tb = _batch(model.cfg, 2, 24, 16, seed=3)
    jm = jbuild(replace(jmodel.cfg, dtype="bfloat16"))
    m = build_model(replace(model.cfg, dtype="bfloat16"))
    jloss, _ = jax.jit(jm.loss)(jparams, jb)
    loss, _ = m.loss(params, tb)
    mem = encdec.encode(params, tb["enc_embeds"].bfloat16(), m.cfg)
    assert mem.dtype == torch.bfloat16
    assert encdec.decode_train(params, tb["tokens"], mem, m.cfg).dtype == torch.bfloat16
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))


def test_precompute_cross_and_decode_steps_match_reference(pair):
    """``precompute_cross`` over 12 frames, then 8 greedy decode steps from
    the reference's and the port's caches; the port writes its
    self-attention cache in place and leaves the cross K/V as set."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    b = 3
    enc = np.random.default_rng(4).normal(size=(b, 12, cfg.d_model)).astype(np.float32)
    jmem = jencdec.encode(jparams, jnp.asarray(enc), jmodel.cfg)
    mem = encdec.encode(params, torch.from_numpy(enc), cfg)
    jcache = jmodel.init_cache(b, 16, jnp.float32)
    cache = model.init_cache(b, 16, torch.float32, "cpu")
    assert cache["cross_k"] is None and jcache["cross_k"] is None
    with pytest.raises(ValueError, match="precompute_cross"):
        model.decode_step(params, torch.zeros(b, dtype=torch.int32), cache, 0)
    jcache["cross_k"], jcache["cross_v"] = jencdec.precompute_cross(jparams, jmem, jmodel.cfg)
    cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(params, mem, cfg)
    assert tuple(cache["cross_k"].shape) == (2, b, 12, 4, 16)
    for k in ("cross_k", "cross_v"):
        _close(cache[k], jcache[k], 1e-5, k)
    cross_k = cache["cross_k"].clone()
    step = jax.jit(jmodel.decode_step)
    tok = np.random.default_rng(5).integers(0, cfg.vocab, b).astype(np.int32)
    jtok = jnp.asarray(tok)
    for i in range(8):
        jlogits, jcache = step(jparams, jtok, jcache, jnp.int32(i))
        logits, out = model.decode_step(params, torch.from_numpy(tok), cache, i)
        assert out is cache and tuple(logits.shape) == (b, cfg.vocab)
        _close(logits, jlogits, 1e-5, f"step {i}")
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1).to(torch.int32).numpy()
        np.testing.assert_array_equal(tok, np.asarray(jtok))
    for k in ("k", "v"):
        _close(cache[k], jcache[k], 1e-5, k)
    assert torch.equal(cache["cross_k"], cross_k)
