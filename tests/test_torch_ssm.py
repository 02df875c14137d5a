"""The port's ssm family (``repro_torch.models.ssm``, mamba2-370m) against the
reference's, on the CPU.

mamba2-370m's smoke cut (4 layers, d_model 64, 8 heads of 16, one group of
state 16, chunk 16, vocab 256) is initialised by the reference and carried
across with ``load_params``; inputs come from numpy seeds.  Tolerances:
  * ``ssd_chunked``: within 1e-5 of the output's largest magnitude against
    the reference (float32 sums in another order: XLA picks its own
    contraction order for the three-operand einsums, and its ``cumsum``
    adds in another order), and within 2e-3 / 2e-4 (rtol / atol) of the
    float64 sequential recurrence, the reference's own test's bound;
  * the mixer, the loss and the decode logits in float32: within 1e-5 of
    their largest magnitude; gradients within 1e-4 of each leaf's largest
    magnitude; the cache's state and conv buffer within 1e-5 of theirs;
  * bfloat16 compute: the loss within 1e-3 of its value, gradients within
    5e-2 of each leaf's largest magnitude;
  * three train steps: the loss within 1e-5, the parameters within twice
    the learning rates' sum and, but for at most 0.1% of a leaf (where
    Adam's normalised step takes either sign on rounding noise), within
    1e-6;
  * the deterministic leaves of init: ``D``, ``dt_bias``, ``conv_b`` and
    the norm bit for bit, ``A_log`` within 1 ulp (XLA's float32 ``log`` is
    not correctly rounded; the port rounds float64's);
  * ``ServingEngine``: the same greedy tokens.
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import fault as jfault
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import api
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model, load_params, ssm
from repro_torch.optim import adamw, schedule
from repro_torch.serving import Request, ServingEngine

CPU = torch.device("cpu")
ARCH = "mamba2-370m"


def _pair(**kw):
    jcfg = replace(jget_config(ARCH).smoke(), **kw)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(replace(get_config(ARCH).smoke(), **kw))
    return jmodel, jparams, model, load_params(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(vocab: int, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    return jb, tb


def _close(got: torch.Tensor, want, rel: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got.detach().float().numpy() - want).max()) <= bound, what


def test_configs_are_the_reference_s():
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_config(ARCH).smoke(), jget_config(ARCH).smoke())):
        assert asdict(ours) == asdict(theirs)
    cut = get_config(ARCH).smoke().ssm
    assert (cut.d_state, cut.head_dim, cut.chunk) == (16, 16, 16)
    assert ARCH not in NOT_PORTED and len(NOT_PORTED) == 0


def _ssd_inputs(b, l, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, l, h))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    Bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("l,chunk,g", [(24, 8, 2), (21, 8, 2), (24, 5, 1), (40, 16, 4), (7, 16, 2)])
def test_ssd_chunked_matches_reference_and_the_sequential_recurrence(l, chunk, g):
    """``g`` > 1 holds the heads' group order (``jnp.repeat``'s, not a
    tiling); ``l`` no multiple of ``chunk`` the padded tail."""
    b, h, p, n = 2, 4, 8, 16
    x, dt, A, Bm, Cm = _ssd_inputs(b, l, h, p, g, n, seed=l + chunk + g)
    want = np.asarray(jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk))
    got = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, l, h, p)
    _close(got, want, 1e-5)
    rep = h // g
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    y_seq = np.zeros_like(x)
    state = np.zeros((b, h, p, n), np.float64)
    for t in range(l):
        decay = np.exp(dt[:, t] * A)
        state = state * decay[..., None, None] + np.einsum(
            "bhp,bhn,bh->bhpn", x[:, t], Bh[:, t], dt[:, t])
        y_seq[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    np.testing.assert_allclose(got.numpy(), y_seq, rtol=2e-3, atol=2e-4)


def test_ssd_chunked_gradient_has_no_nan_on_a_padded_tail():
    """``_segsum``'s -inf above the diagonal sends no gradient (as
    ``jnp.where``): the gradients at l = 21, chunk 8 are finite and the
    reference's."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 21, 4, 8, 2, 16, seed=5)
    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jf(*args):
        return jnp.sum(jssm.ssd_chunked(*args, chunk=8) * cot)

    jgrads = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    (ssm.ssd_chunked(*ts, chunk=8) * torch.from_numpy(cot)).sum().backward()
    for t, jg in zip(ts, jgrads):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, jg, 1e-4)


def test_softplus_is_logaddexp_without_a_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 20.5, 25.0, 80.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(ssm._softplus(x).numpy(), want)


def test_init_has_the_reference_structure_and_deterministic_leaves(pair):
    jmodel, jparams, model, _params = pair
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(jax.tree.map(np.asarray, jparams)) == shapes(mine)
    jm, m = jparams["layers"]["mixer"], mine["layers"]["mixer"]
    for k in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(m[k].numpy().view(np.int32), np.asarray(jm[k]).view(np.int32))
    assert not mine["layers"]["mixer"]["norm"]["scale"].any()
    ulps = np.abs(m["A_log"].numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jm["A_log"]).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # the full config's 32 heads (the card's): A_log within 1 ulp of XLA's
    h = 2 * 1024 // 64
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h).astype(jnp.float32)))
    got = ssm._a_log_values(h)
    assert np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32)).max() <= 1
    np.testing.assert_array_equal(np.exp(got.astype(np.float64)).astype(np.float32)[[0, -1]],
                                  [1.0, 16.0])
    assert abs(float(m["conv_w"].std()) - 0.1) < 0.01
    assert m["A_log"].data_ptr() != mine["layers"]["mixer"]["D"].data_ptr()


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_mamba2_forward_matches_reference(pair, dtype, rel):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    x = np.random.default_rng(7).normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["mixer"])
    tp = jax.tree.map(lambda a: a[1], params["layers"]["mixer"])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jssm.mamba2_forward(jnp.asarray(x).astype(jdt), jp, jmodel.cfg)
    got = ssm.mamba2_forward(torch.from_numpy(x).to(getattr(torch, dtype)), tp, cfg)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, np.asarray(want.astype(jnp.float32)), rel)


def test_mamba2_decode_writes_the_cache_in_place(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    jp = jax.tree.map(lambda a: a[2], jparams["layers"]["mixer"])
    tp = jax.tree.map(lambda a: a[2], params["layers"]["mixer"])
    d_inner, h, p, g, n = ssm._dims(cfg)
    jcache = {"state": jnp.zeros((3, h, p, n), jnp.float32),
              "conv": jnp.zeros((3, cfg.ssm.d_conv - 1, d_inner + 2 * g * n), jnp.float32)}
    cache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    storage = {k: v.data_ptr() for k, v in cache.items()}
    rng = np.random.default_rng(8)
    for _ in range(6):
        x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jssm.mamba2_decode(jnp.asarray(x), jp, jmodel.cfg, jcache)
        y, out = ssm.mamba2_decode(torch.from_numpy(x), tp, cfg, cache)
        assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == storage
        _close(y, jy, 1e-5)
        for k in cache:
            _close(cache[k], jcache[k], 1e-5, k)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference_in_float32(remat):
    jmodel, jparams, model, params = _pair(remat=remat)
    jb, tb = _batch(256, 2, 37, seed=1)   # 37 tokens: two chunks of 16 and a padded tail
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert set(met) == {"ce", "aux", "loss"} and float(met["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    flat = dict(api.flatten_with_keys(grads))
    for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)):
        assert torch.isfinite(flat[k]).all(), k
        _close(flat[k], want, 1e-4, k)


def test_loss_and_grads_in_bfloat16_stay_close():
    jmodel, jparams, model, params = _pair(dtype="bfloat16")
    jb, tb = _batch(256, 4, 40, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, _), grads = model.value_and_grad(params, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    flat = dict(api.flatten_with_keys(grads))
    for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)):
        _close(flat[k], want, 5e-2, k)


def test_three_train_steps_match_reference_step():
    jmodel, jparams, model, params = _pair()
    jcfg = jadamw.AdamWConfig()
    jstate = jadamw.init_state(jparams, jcfg)
    state = adamw.init_state(params, adamw.AdamWConfig())
    step_fn = make_train_step(model, adamw.AdamWConfig(), schedule.cosine, 3e-4, 10)

    @jax.jit
    def jstep(p, s, b):
        (loss, _m), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
        lr_t = jschedule.cosine(s["step"], peak_lr=3e-4, warmup=1, total=10)
        new_p, new_s, _om = jadamw.apply_updates(p, g, s, lr_t, jcfg)
        new_p, finite = jfault.skip_nonfinite_update(new_p, p, g)
        return new_p, new_s, loss, finite

    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(256, 4, 20, seed=10 + i)
        lr_sum += float(jschedule.cosine(i, peak_lr=3e-4, warmup=1, total=10))
        jparams, jstate, jloss, jfinite = jstep(jparams, jstate, jb)
        metrics = step_fn(params, state, tb)
        assert bool(metrics["finite"]) and bool(jfinite)
        assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
        flat = dict(api.flatten_with_keys(params))
        for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jparams)):
            diff = np.abs(flat[k].numpy() - want)
            assert diff.max() <= 2 * lr_sum, k
            assert (diff > 1e-6).mean() <= 1e-3, k
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_decode_steps_match_reference_and_the_forward(pair):
    """The family's central identity: the decode steps over a prompt (an
    O(1) state) give the last position's logits of the forward over it,
    and both the reference's."""
    jmodel, jparams, model, params = pair
    batch, steps = 3, 21
    jcache = jmodel.init_cache(batch, 8, jnp.float32)
    cache = model.init_cache(batch, 8, torch.float32, "cpu")
    assert tuple(cache["state"].shape) == tuple(jcache["state"].shape) == (4, batch, 8, 16, 16)
    assert tuple(cache["conv"].shape) == tuple(jcache["conv"].shape) == (4, batch, 3, 160)
    toks = np.random.default_rng(9).integers(0, 256, (batch, steps)).astype(np.int32)
    for i in range(steps):
        jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, i]), jcache,
                                             jnp.int32(i))
        logits, out = model.decode_step(params, torch.from_numpy(toks[:, i].copy()), cache, i)
        assert out is cache
        _close(logits, jlogits, 1e-5)
    for k in cache:
        _close(cache[k], jcache[k], 1e-5, k)
    h = model._backbone(params, model._embed_in(params, {"tokens": torch.from_numpy(toks)}),
                        {})[0]
    from repro_torch.models.layers import rms_norm
    full = model._head(params, rms_norm(h, params["ln_f"]["scale"], model.cfg.norm_eps))
    _close(full[:, -1], logits.numpy(), 1e-5)


def test_serve_tokens_equal_reference(pair):
    """Six requests on two slots (the refill path; prefill advances every
    slot's state, as the reference's does): the same greedy tokens."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, 5).astype(np.int32) for _ in range(6)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    stats = ServingEngine(model, params, 2, 64).serve(reqs)
    JServingEngine(jmodel, jparams, 2, 64).serve(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert stats["requests"] == 6 and stats["new_tokens"] == 36
