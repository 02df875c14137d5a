"""The port's vlm family (qwen2-vl-72b: the dense block with M-RoPE over
``embeds`` and ``positions_3d``) against the reference's, on the CPU.

qwen2-vl-72b's smoke cut (4 layers, d_model 64, 4 heads of 16, 4 KV heads,
M-RoPE sections (2, 3, 3), QKV bias, vocab 256) is initialised by the
reference and carried across with ``load_params``; inputs come from numpy
seeds.  The positions mix text tokens (t = h = w, increasing) and an image
block (t fixed, h and w over a grid), so all three sections differ.
Tolerances:
  * ``apply_mrope`` against the reference: within 1e-6 (XLA's float32
    ``cos``/``sin`` against the port's); on t = h = w equal to the port's
    ``apply_rope`` bit for bit (the same angles go through the same
    rotation), and within 1e-6 of the reference's RoPE;
  * attention, loss and decode logits in float32: within 1e-5 of their
    largest magnitude; gradients within 1e-5 of each leaf's largest
    magnitude, the embedding's (unread under ``embeds``) zero in both;
  * bfloat16 compute: the loss within 1e-3 of its value, gradients within
    5e-2 of each leaf's largest magnitude;
  * ``ServingEngine``: the same greedy tokens.
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
from repro.models.layers import apply_mrope as japply_mrope
from repro.models.layers import apply_rope as japply_rope
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import api
from repro_torch.models import attention, build_model, load_params
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.serving import Request, ServingEngine

CPU = torch.device("cpu")
ARCH = "qwen2-vl-72b"


def _pair(**kw):
    jcfg = replace(jget_config(ARCH).smoke(), **kw)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(replace(get_config(ARCH).smoke(), **kw))
    return jmodel, jparams, model, load_params(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _close(got: torch.Tensor, want, rel: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got.detach().float().numpy() - want).max()) <= bound, what


def positions_3d(b: int, s: int, image_at: int = 6, grid: tuple = (3, 4)) -> np.ndarray:
    """(b, s, 3) int32: text tokens t = h = w = their index; an image of
    ``grid`` patches from ``image_at`` on at t = image_at, h and w over the
    grid (offset by image_at); the text after it resumes past the grid."""
    pos = np.repeat(np.arange(s, dtype=np.int32)[:, None], 3, axis=1)
    gh, gw = grid
    n = gh * gw
    t0 = image_at
    pos[t0:t0 + n, 0] = t0
    pos[t0:t0 + n, 1] = t0 + np.arange(n) // gw
    pos[t0:t0 + n, 2] = t0 + np.arange(n) % gw
    pos[t0 + n:] = pos[t0 + n:] - n + max(gh, gw)
    return np.broadcast_to(pos, (b, s, 3)).copy()


def _vlm_batch(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pos = positions_3d(b, s)
    jb = {"embeds": jnp.asarray(emb), "positions_3d": jnp.asarray(pos),
          "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.from_numpy(emb), "positions_3d": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels)}
    return jb, tb


def test_configs_are_the_reference_s():
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_config(ARCH).smoke(), jget_config(ARCH).smoke())):
        assert asdict(ours) == asdict(theirs)
        assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert get_config(ARCH).smoke().mrope_sections == (2, 3, 3)
    assert ARCH not in NOT_PORTED


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_reference_on_distinct_t_h_w(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 30, 4, hd)).astype(np.float32)
    pos = positions_3d(2, 30)
    pos[1] = rng.integers(0, 5000, (30, 3))
    want = np.asarray(japply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max() + 1e-6)
    # the three sections differ: rotating by t alone would be far off
    by_t = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0].copy()), 1e6)
    assert float((by_t - got).abs().max()) > 0.1


def test_mrope_degenerates_to_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 8)).astype(np.int32)
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 10000.0, (2, 3, 3))
    rope = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    assert torch.equal(got, rope)
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gqa_attention_with_mrope_positions_matches_reference(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    x = np.random.default_rng(2).normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    pos = positions_3d(2, 20)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    want = jattn.gqa_attention(jnp.asarray(x), jp, jmodel.cfg, mrope_positions=jnp.asarray(pos))
    got = attention.gqa_attention(torch.from_numpy(x), tp, cfg,
                                  mrope_positions=torch.from_numpy(pos))
    _close(got, want, 1e-5)
    plain = attention.gqa_attention(torch.from_numpy(x), tp, cfg)
    assert float((plain - got).abs().max()) > 1e-3  # M-RoPE was applied


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_with_embeds_and_positions_match_reference(remat):
    jmodel, jparams, model, params = _pair(remat=remat)
    jb, tb = _vlm_batch(model.cfg, 2, 24, seed=3)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert float(met["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    flat = dict(api.flatten_with_keys(grads))
    for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)):
        if k == "embed/table":   # not read under embeds: zero in both
            assert not want.any() and not flat[k].any()
            continue
        _close(flat[k], want, 1e-5, k)
    # the positions reach the loss: text positions throughout give another
    text = {**tb, "positions_3d": torch.from_numpy(
        np.repeat(np.arange(24, dtype=np.int32)[None, :, None], 3, -1).repeat(2, 0))}
    assert abs(float(model.loss(params, text)[0]) - float(loss)) > 1e-6


def test_loss_and_grads_in_bfloat16_stay_close():
    jmodel, jparams, model, params = _pair(dtype="bfloat16")
    jb, tb = _vlm_batch(model.cfg, 4, 32, seed=4)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, _), grads = model.value_and_grad(params, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    flat = dict(api.flatten_with_keys(grads))
    for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)):
        if k != "embed/table":
            _close(flat[k], want, 5e-2, k)


def test_decode_step_logits_match_reference(pair):
    """Decode on tokens keeps plain RoPE at ``cache_len``, as the reference."""
    jmodel, jparams, model, params = pair
    jcache = jmodel.init_cache(3, 12, jnp.float32)
    cache = model.init_cache(3, 12, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    for step in range(8):
        tok = rng.integers(0, 256, 3).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, jnp.int32(step))
        logits, _ = model.decode_step(params, torch.from_numpy(tok), cache, step)
        _close(logits, jlogits, 1e-5)
    for k in ("k", "v"):
        _close(cache[k], jcache[k], 1e-5, k)


def test_serve_tokens_equal_reference(pair):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, 5).astype(np.int32) for _ in range(4)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    ServingEngine(model, params, 2, 64).serve(reqs)
    JServingEngine(jmodel, jparams, 2, 64).serve(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
