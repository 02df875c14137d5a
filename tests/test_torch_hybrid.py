"""The port's hybrid family (``repro_torch.models.rglru``, the hybrid
sublayers of ``models/transformer.py``, ``local_causal_mask``;
recurrentgemma-9b) against the reference's, on the CPU.

recurrentgemma-9b's smoke cut (4 layers: one ``(rec, rec, attn)``
superblock and a one-layer tail; d_model 64, 4 heads of 16, one KV head,
lru_width 64, window 32, vocab 256, float32) is initialised by the
reference and carried across with ``load_params``; inputs come from numpy
seeds.  Tolerances:
  * ``local_causal_mask`` and the associative scan on the same (a, b):
    bit for bit (the scan against the reference run op by op; under
    ``jax.jit`` XLA fuses a multiply-add, and the port is within 2 ulps of
    the largest magnitude); the scan against a sequential loop within 1e-5
    of its largest magnitude (the loop adds in another order);
  * ``_gates``: within 4e-7 (a few ulps of values <= 1: XLA's float32
    ``exp``, ``logistic`` and ``log1p`` differ from torch's in the last
    bit here and there);
  * the recurrent block, its decode step, the loss and decode logits in
    float32: within 1e-5 of their largest magnitude; gradients within 1e-4
    of each leaf's largest magnitude; the cache within 1e-5 of each leaf's
    largest magnitude;
  * decode over 48 tokens, past the window of 32, against the port's own
    forward: within 1e-4 of 1 + the largest |logit|;
  * ``ServingEngine`` and ``train_loop``'s losses: the reference's tokens,
    losses within 1e-5.
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import api
from repro_torch.core.engine import ExecutionEngine
from repro_torch.models import attention, build_model, load_params, rglru
from repro_torch.models.layers import rms_norm
from repro_torch.serving import Request, ServingEngine

CPU = torch.device("cpu")
ARCH = "recurrentgemma-9b"


def _pair(**kw):
    jcfg = replace(jget_config(ARCH).smoke(), **kw)
    jmodel = jbuild(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
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
    assert (cut.n_layers, cut.hybrid.lru_width, cut.hybrid.window) == (4, 64, 32)
    assert ARCH not in NOT_PORTED and NOT_PORTED == ()


def test_init_tree_is_the_reference_s(pair):
    """Keys, shapes and dtypes (the ``tail`` list of unstacked sublayers
    included), in the reference's flattening order; the scheme's fixed
    leaves and ranges."""
    _jm, jparams, model, _p = pair
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    jspecs = _specs(jax.tree.map(np.asarray, jparams))
    assert list(_specs(mine).items()) == list(jspecs.items())
    assert isinstance(mine["tail"], list) and len(mine["tail"]) == 1
    assert "tail/0/temporal/lam" in jspecs
    full = build_model(get_config(ARCH)).param_shapes()
    assert len(full["tail"]) == 2 and full["super"]["attn"]["temporal"]["wq"]["w"].shape == \
        (12, 4096, 4096)
    t = mine["super"]["rec_a"]["temporal"]
    assert t["conv_b"].abs().max() == 0 and t["in_x"]["b"].abs().max() == 0
    u = torch.sigmoid(2 * t["lam"])  # lam = log(sqrt(u / (1 - u))), u in [0.9^2, 0.999^2]
    assert float(u.min()) >= 0.81 - 1e-6 and float(u.max()) <= 0.998001 + 1e-6
    assert abs(float(t["conv_w"].std()) - 0.1) < 0.02


@pytest.mark.parametrize("s_q,s_k,window,q_offset", [(8, 8, 3, 0), (48, 48, 32, 0),
                                                     (5, 40, 16, 35), (1, 64, 32, 63),
                                                     (17, 17, 1, 0)])
def test_local_causal_mask_bit_for_bit(s_q, s_k, window, q_offset):
    want = np.asarray(jattn.local_causal_mask(s_q, s_k, window, q_offset))
    got = attention.local_causal_mask(s_q, s_k, window, q_offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length", [1, 2, 17, 64, 65])
def test_associative_scan_bit_for_bit_and_near_a_loop(length):
    """The same (a, b) through ``jax.lax.associative_scan`` op by op and the
    port's recursion: identical bits at even and odd lengths.  Under
    ``jax.jit`` XLA:CPU contracts ``a2·b1 + b2`` into one fused
    multiply-add, which rounds once; the port rounds the product as the
    reference's code writes it, so against the jitted scan it is within
    2 ulps of the largest magnitude, not bit for bit."""
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, (2, length, 64)).astype(np.float32)
    b = rng.normal(size=(2, length, 64)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = rglru._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _ja, jit_b = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    _close(tb, jit_b, 2 ** -22)
    h, seq = np.zeros((2, 64), np.float32), np.zeros_like(b)
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        seq[:, t] = h
    _close(tb, seq, 1e-5)


def _rec_params(pair):
    _jm, jparams, _m, params = pair
    jp = jax.tree.map(lambda x: x[0], jparams["super"]["rec_a"]["temporal"])
    tp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in params["super"]["rec_a"]["temporal"].items()}
    return jp, tp


def test_gates_and_scan_match_reference(pair):
    jp, tp = _rec_params(pair)
    x = np.random.default_rng(3).normal(size=(2, 33, 64)).astype(np.float32)
    ja, jc = jax.jit(jrglru._gates)(jnp.asarray(x), jp)
    ta, tc = rglru._gates(torch.from_numpy(x), tp)
    assert ta.dtype == tc.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=4e-7)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=4e-7)
    _close(rglru.rglru_scan(torch.from_numpy(x), tp), jax.jit(jrglru.rglru_scan)(x, jp), 1e-5)


def test_rglru_block_and_its_decode_match_reference(pair):
    """The block over 20 positions, then 6 decode steps from a cache the
    reference and the port each carry (the port's written in place)."""
    jm, _jp, model, _p = pair
    cfg = model.cfg
    jp, tp = _rec_params(pair)
    x = np.random.default_rng(4).normal(size=(3, 20, 64)).astype(np.float32)
    _close(rglru.rglru_block(torch.from_numpy(x), tp, cfg),
           jax.jit(lambda x, p: jrglru.rglru_block(x, p, jm.cfg))(x, jp), 1e-5, "block")
    jstep = jax.jit(lambda x, p, c: jrglru.rglru_block_decode(x, p, jm.cfg, c))
    w, cw = cfg.hybrid.lru_width, cfg.hybrid.conv_width
    jcache = {"h": jnp.zeros((3, w), jnp.float32), "conv": jnp.zeros((3, cw - 1, w), jnp.float32)}
    cache = {"h": torch.zeros(3, w), "conv": torch.zeros(3, cw - 1, w)}
    for t in range(6):
        jy, jcache = jstep(x[:, t:t + 1], jp, jcache)
        y, out = rglru.rglru_block_decode(torch.from_numpy(x[:, t:t + 1].copy()), tp, cfg, cache)
        assert out is cache
        _close(y, jy, 1e-5, f"decode {t}")
        for k in ("h", "conv"):
            _close(cache[k], jcache[k], 1e-5, k)
    # decode from a zero state equals the block's scan on the same tokens
    _close(y, rglru.rglru_block(torch.from_numpy(x[:, :6].copy()), tp, cfg)[:, -1:], 1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """Both superblock sublayer kinds and the tail, the local window of 32
    crossed by 40 positions."""
    jmodel, jparams, model, params = _pair(remat=remat)
    jb, tb = _batch(256, 2, 40, seed=5)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert set(met) == {"ce", "aux", "loss"} and float(met["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = dict(api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)))
    flat = dict(api.flatten_with_keys(grads))
    assert list(flat) == list(jflat)
    for k, want in jflat.items():
        _close(flat[k], want, 1e-4, k)


def test_decode_past_the_window_matches_reference_and_the_forward(pair):
    """48 decode steps on a cache of 64 positions: the attention ring holds
    32 slots and wraps at step 32; logits and cache against the reference
    every step, and the last step's logits against the port's forward over
    the 48 tokens (the forward's local mask at window 32)."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    b, steps = 2, 48
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, steps)).astype(np.int32)
    jcache = jmodel.init_cache(b, 64, jnp.float32)
    cache = model.init_cache(b, 64, torch.float32, "cpu")
    jshapes = {k: v.shape for k, v in api.flatten_with_keys(jax.tree.map(np.asarray, jcache))}
    assert {k: tuple(v.shape) for k, v in api.flatten_with_keys(cache)} == jshapes
    assert tuple(cache["attn"]["k"].shape) == (1, b, 32, 1, 16)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        logits, out = model.decode_step(params, torch.from_numpy(toks[:, t].copy()), cache, t)
        assert out is cache and tuple(logits.shape) == (b, cfg.vocab)
        _close(logits, jlogits, 1e-5, f"step {t}")
    jflat = dict(api.flatten_with_keys(jax.tree.map(np.asarray, jcache)))
    for k, x in api.flatten_with_keys(cache):
        _close(x, jflat[k], 1e-5, k)
    with torch.no_grad():
        h, _ = model._backbone(params, model._embed_in(params, {"tokens": torch.from_numpy(toks)}),
                               {})
        fwd = model._head(params, rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps))[:, -1]
    assert float((logits - fwd).abs().max()) <= 1e-4 * (1.0 + float(fwd.abs().max()))


def _requests(cls, vocab, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, 5).astype(np.int32), max_new_tokens=6)
            for i in range(n)]


def test_serve_tokens_equal_reference(pair):
    """Four requests on two slots (the refill path): idle slots step on
    token 0 and a refilled slot keeps its state and length, as in the
    reference; the same greedy tokens."""
    jmodel, jparams, model, params = pair
    vocab = model.cfg.vocab
    reqs, jreqs = _requests(Request, vocab), _requests(JRequest, vocab)
    stats = ServingEngine(model, params, 2, 64).serve(reqs)
    JServingEngine(jmodel, jparams, 2, 64).serve(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert stats["new_tokens"] == 24


def test_train_loop_runs_the_hybrid_smoke_cut():
    """``train_loop`` needs nothing new for the family: 3 steps on the CPU,
    finite and falling."""
    from repro_torch.launch.train import train_loop

    out = train_loop(ARCH, steps=3, batch=2, seq=40, device="cpu", log_every=10)
    assert out["steps_run"] == 3 and all(out["finite"])
    assert all(np.isfinite(out["losses"]))
    assert isinstance(out["state"]["params"]["tail"], list)
    assert isinstance(out["state"]["opt"]["m"]["tail"], list)


def test_checkpoint_cross_restores_in_the_reference(tmp_path, pair):
    """The port's checkpoint of the hybrid parameters (every float leaf
    through zfp, ``lossless_small=0``: the plain Huffman decode would take
    most of a minute here) restores in ``repro`` under the same keys,
    ``tail::0::...`` included, to the values the port restores itself."""
    _jm, jparams, _m, params = pair
    with ExecutionEngine(devices=[CPU], backend="torch") as eng:
        mgr = CheckpointManager(tmp_path / "ck", CheckpointPolicy(lossless_small=0), engine=eng)
        manifest = mgr.save(1, params)
        mine, _ = mgr.restore(1)
    theirs, _ = JManager(tmp_path / "ck").restore(1)
    keys = [k for k, _ in api.flatten_with_keys(params, "::")]
    assert sorted(manifest["leaves"]) == sorted(theirs) == sorted(mine) == sorted(keys)
    assert "tail::0::temporal::lam" in theirs
    for k in keys:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]), err_msg=k)
