"""The port's training side of the dense family against the reference, on
the CPU: the configs, ``Model.loss`` and its gradients, the train step, and
``train_loop`` with its exact checkpoints (the port's counterparts of
``tests/test_train_fault.py``, and the reference resuming a run the port
checkpointed).

Both packages run the smoke cuts (4 layers, d_model 64, vocab 256) on the
reference's parameters, carried across with ``load_params``; inputs come
from numpy seeds.  Tolerances:
  * float32 compute: the loss within 1e-6 of its value, every gradient leaf
    within 1e-5 of its largest magnitude (sums in another order);
  * bfloat16 compute: the loss within 1e-3 of its value, every gradient
    within 5e-2 of its largest magnitude (XLA keeps some elementwise
    chains in float32 between bfloat16 roundings); the embedding's own
    backward bit for bit (rows summed in bfloat16, token by token, as
    XLA's scatter-add does);
  * three train steps: the loss within 1e-5, the parameters within 1e-6
    but where a gradient is float32 rounding noise and Adam's normalised
    step may take either sign: at most 0.1% of a leaf (embedding rows), and
    all of the key bias, whose exact gradient is 0 (softmax ignores a shift
    common to a query's scores), within twice the learning rates' sum;
  * the reference resuming the port's checkpoint: its losses within 1e-4 of
    the port's uninterrupted run (five float32 steps, each within the
    bounds above); the port resuming its own: bit for bit.
"""

import shutil
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.launch.train import train_loop as jtrain_loop
from repro.models import build_model as jbuild
from repro.models.layers import embed as jembed
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import fault as jfault
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import api
from repro_torch.launch.train import make_train_step, train_loop
from repro_torch.models import build_model, load_params
from repro_torch.models.layers import embed
from repro_torch.optim import adamw, schedule

CPU = torch.device("cpu")
STEPS, FAIL_AT = 10, 5


def _batch(vocab: int, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    return jb, tb


def _pair(arch: str, **kw):
    jcfg = replace(jget_config(arch).smoke(), **kw)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(replace(get_config(arch).smoke(), **kw))
    return jmodel, jparams, model, load_params(jax.tree.map(np.asarray, jparams), CPU)


def _assert_grads_close(jgrads, grads, rel: float) -> None:
    flat = dict(api.flatten_with_keys(grads))
    jflat = dict(api.flatten_with_keys(jax.tree.map(np.asarray, jgrads)))
    assert flat.keys() == jflat.keys()
    for k, want in jflat.items():
        got = flat[k]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, k
        bound = rel * float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= bound, k


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen1.5-4b", "minicpm-2b", "deepseek-67b"])
def test_configs_are_the_reference_s(arch):
    assert arch in ARCHS
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_config(arch).smoke(), jget_config(arch).smoke())):
        assert asdict(ours) == asdict(theirs)
        assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert asdict(get_config("seamless-m4t-medium")) == asdict(jget_config("seamless-m4t-medium"))
    assert "seamless-m4t-medium" in ARCHS and "recurrentgemma-9b" in ARCHS


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b"])
def test_loss_and_grads_match_reference_in_float32(arch, remat):
    """minicpm-2b carries μP: scale_emb on the embedding, scale_depth/√L on
    the residuals, d_model/dim_model_base on the head."""
    jmodel, jparams, model, params = _pair(arch, remat=remat)
    jb, tb = _batch(256, 2, 16, seed=1)
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, met), grads = model.value_and_grad(params, tb)
    assert set(met) == {"ce", "aux", "loss"} and float(met["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= 1e-6 * abs(float(jloss))
    _assert_grads_close(jgrads, grads, 1e-5)
    # the caller's parameters are left as they were
    assert not params["embed"]["table"].requires_grad and params["embed"]["table"].grad is None


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b"])
def test_loss_and_grads_in_bfloat16_stay_close(arch):
    jmodel, jparams, model, params = _pair(arch, dtype="bfloat16")
    jb, tb = _batch(256, 4, 32, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    (loss, _), grads = model.value_and_grad(params, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    _assert_grads_close(jgrads, grads, 5e-2)


def test_remat_gives_the_same_loss_and_grads():
    _j, _jp, model, params = _pair("qwen2.5-3b")
    remat = build_model(replace(model.cfg, remat=True))
    _jb, tb = _batch(256, 2, 16, seed=3)
    (l0, _), g0 = build_model(replace(model.cfg, remat=False)).value_and_grad(params, tb)
    (l1, _), g1 = remat.value_and_grad(params, tb)
    assert torch.equal(l0, l1)
    f0, f1 = dict(api.flatten_with_keys(g0)), dict(api.flatten_with_keys(g1))
    assert all(torch.equal(f0[k], f1[k]) for k in f0)


def test_embedding_backward_sums_rows_in_bfloat16_as_the_reference():
    """Tokens repeat 250 times a row: the reference sums their bfloat16
    gradients in bfloat16, token by token; the port's gather-then-cast
    forward has a backward that does the same (bit for bit), where the
    float32 sum it would otherwise take differs by whole units."""
    rng = np.random.default_rng(4)
    table = (rng.normal(size=(16, 64)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, 16, (8, 500)).astype(np.int32)
    cot = rng.normal(size=(8, 500, 64)).astype(np.float32)
    jcot = jnp.asarray(cot).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda t: jembed(jnp.asarray(tokens), {"table": t}, jnp.bfloat16),
                       jnp.asarray(table))
    (want,) = vjp(jcot)
    t = torch.from_numpy(table).requires_grad_(True)
    y = embed(torch.from_numpy(tokens), {"table": t}, torch.bfloat16)
    np.testing.assert_array_equal(y.float().detach().numpy(), np.asarray(out, np.float32))
    tcot = torch.from_numpy(np.array(jcot.astype(jnp.float32))).to(torch.bfloat16)
    (got,) = torch.autograd.grad(y, t, tcot)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    in_float32 = torch.zeros(16, 64).index_put_((torch.from_numpy(tokens).long().reshape(-1),),
                                                tcot.float().reshape(-1, 64), accumulate=True)
    assert float((in_float32 - got).abs().max()) > 0.1


def test_three_train_steps_match_reference_step():
    """The reference's ``train_step`` (value_and_grad, the cosine schedule at
    the optimizer's step, AdamW, the non-finite guard) against the port's
    on the same parameters and batches."""
    jmodel, jparams, model, params = _pair("qwen2.5-3b")
    jcfg = jadamw.AdamWConfig()
    jstate = jadamw.init_state(jparams, jcfg)
    state = adamw.init_state(params, adamw.AdamWConfig())
    step_fn = make_train_step(model, adamw.AdamWConfig(), schedule.cosine, 3e-4, 10)

    @jax.jit
    def jstep(p, s, b):
        (loss, m), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
        lr_t = jschedule.cosine(s["step"], peak_lr=3e-4, warmup=1, total=10)
        new_p, new_s, om = jadamw.apply_updates(p, g, s, lr_t, jcfg)
        new_p, finite = jfault.skip_nonfinite_update(new_p, p, g)
        return new_p, new_s, loss, finite

    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(256, 4, 16, seed=10 + i)
        lr_sum += float(jschedule.cosine(i, peak_lr=3e-4, warmup=1, total=10))
        jparams, jstate, jloss, jfinite = jstep(jparams, jstate, jb)
        metrics = step_fn(params, state, tb)
        assert bool(metrics["finite"]) and bool(jfinite)
        assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
        flat = dict(api.flatten_with_keys(params))
        for k, want in api.flatten_with_keys(jax.tree.map(np.asarray, jparams)):
            diff = np.abs(flat[k].numpy() - want)
            assert diff.max() <= 2 * lr_sum, k
            if k != "layers/attn/wk/b":
                assert (diff > 1e-6).mean() <= 1e-3, k
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_loss_decreases():
    out = train_loop("qwen2.5-3b", steps=25, batch=4, seq=64, log_every=100, device="cpu")
    assert out["steps_run"] == 25 and all(out["finite"])
    assert out["last_loss"] < out["first_loss"]
    assert out["state"]["params"]["embed"]["table"].device == CPU


def test_train_loop_without_a_card_needs_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is that card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop("qwen2.5-3b", steps=1, batch=1, seq=4)


# ---------------------------------------------------------------------------
# failure, restart and resume (one scenario, read by the tests below)
# ---------------------------------------------------------------------------


def _flat_state(out) -> dict:
    return dict(api.flatten_with_keys(out["state"]))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A: 10 steps, no checkpoint.  B: a checkpoint every 5 steps (sync),
    failure injected at step 5.  C: a restart on B's directory.  R: the
    reference restarting on a copy of B's directory."""
    root = tmp_path_factory.mktemp("train")
    kw = dict(steps=STEPS, batch=4, seq=32, log_every=100)
    a = train_loop("qwen2.5-3b", device="cpu", **kw)
    with pytest.raises(RuntimeError, match="injected failure at step 5") as raised:
        train_loop("qwen2.5-3b", device="cpu", ckpt_dir=str(root / "ck"), ckpt_every=5,
                   inject_failure_at=FAIL_AT, sync_ckpt=True, **kw)
    shutil.copytree(root / "ck", root / "ck_ref")
    c = train_loop("qwen2.5-3b", device="cpu", ckpt_dir=str(root / "ck"), ckpt_every=5, **kw)
    r = jtrain_loop("qwen2.5-3b", ckpt_dir=str(root / "ck_ref"), ckpt_every=5, **kw)
    return {"a": a, "c": c, "r": r, "raised": raised, "root": root}


def test_failure_injection_and_restart(resumed):
    c = resumed["c"]
    assert c["steps_run"] == STEPS - FAIL_AT and all(c["finite"])
    assert np.isfinite(c["last_loss"])
    assert c["ckpt_report"]["step"] == STEPS
    assert c["ckpt_report"]["extra"]["data"] == {"step": STEPS, "seed": 0}


def test_checkpoint_restart_resumes_exactly(resumed):
    """Exact (lossless) checkpoints and a deterministic stream: C's losses
    and final parameters, moments and step equal A's bit for bit."""
    a, c = resumed["a"], resumed["c"]
    assert c["losses"] == a["losses"][FAIL_AT:]
    fa, fc = _flat_state(a), _flat_state(c)
    assert fa.keys() == fc.keys()
    for k in fa:
        assert fa[k].dtype == fc[k].dtype and torch.equal(fa[k], fc[k]), k


def test_reference_resumes_the_port_s_checkpoint(resumed):
    """The reference restores the port's exact step-5 checkpoint (leaves and
    ``extra["data"]``) and trains on to step 10 near the port's
    uninterrupted run; its first step reads the tokens of step 5."""
    a, r = resumed["a"], resumed["r"]
    assert r["steps_run"] == STEPS - FAIL_AT
    assert abs(r["first_loss"] - a["losses"][FAIL_AT]) <= 1e-4
    assert abs(r["last_loss"] - a["last_loss"]) <= 1e-4
