"""The placed path and the mesh-only model branches of the port, on the CPU.

Gloo groups run in subprocesses (``tests/_torch_placed_worker.py``), the
reference's mesh code in its own process on four XLA:CPU devices
(``tests/_jax_mesh_worker.py``); everything else runs here against the
reference, at the smoke cuts (float32).  Tolerances:

  * placed vs unplaced steps (qwen1.5-4b's smoke cut, as the reference's
    ``test_mini_dryrun_train_lower_compile``, on a 2 × 2 mesh under
    ``tp``, ``fsdp_dp`` and ``dp_zero1``; two steps): the loss within 1e-6
    relative; every moment m and v, and every parameter, within 1e-5 of
    the leaf's largest |value|.  In the leaves that start at zero (norm
    scales, biases: each element is then Adam's steps alone, about ±lr
    each) an element whose gradient is below 1/20 of the leaf's largest
    (its √v below 1/20 of the largest √v) is held through its moment m
    alone, which follows the gradient linearly: Adam divides a gradient by
    its own size, so a last-bit difference in a near-zero gradient (the
    sums run in another order) can flip its step.  Most of the key bias is
    such, the dims whose RoPE frequency barely turns over the sequence,
    where the bias is a shift common to all of a query's scores;
  * prefill and decode logits, placed vs unplaced, within 1e-5 of their
    largest magnitude (a sum over a sharded dim in another order);
  * against the reference: the MoE routing identical, outputs within 1e-5
    of their largest magnitude, aux losses within 1e-6 relative, gates
    within 4 ulp (``tests/test_torch_moe.py``'s); decode logits and caches
    within 1e-5 of their largest magnitude;
  * restores onto placements and the placed resume: bit for bit.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import CheckpointPolicy as JCheckpointPolicy
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.models import attention, build_model, load_params, moe

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CPU = torch.device("cpu")


def _close(got, want, rel: float, what: str = "") -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound, what


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


def _group(scenarios: str, world: int, n_data: int, d: Path) -> list:
    """Start ``world`` gloo ranks running ``scenarios`` over the
    ``(n_data, world / n_data)`` mesh."""
    d.mkdir(parents=True, exist_ok=True)
    store = d / f"store-{scenarios.replace(',', '-')}"
    return [subprocess.Popen([sys.executable, str(TESTS / "_torch_placed_worker.py"), scenarios,
                              str(r), str(world), str(store), str(d), str(n_data)],
                             env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for r in range(world)]


def _wait(procs: list) -> None:
    for p in procs:
        _out, err = p.communicate(timeout=480)
        assert p.returncode == 0, err.decode()[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of every subprocess: the reference's a2a on four XLA:CPU
    devices; 4 gloo ranks (2 × 2) for the steps and the a2a; 2 gloo ranks
    (1 × 2) for the restores onto placements and the placed resume."""
    d = tmp_path_factory.mktemp("placed")
    # checkpoints of one tree, written unplaced by the port and by the reference
    jparams = jax.jit(jbuild(jget_config("qwen2.5-3b").smoke()).init)(jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, jparams)
    mgr = CheckpointManager(d / "ck_port", CheckpointPolicy(exact=True), backend="torch")
    mgr.save(1, load_params(host, CPU))
    mgr.close()
    JCheckpointManager(d / "ck_ref", JCheckpointPolicy(exact=True)).save(1, jparams)
    ref = subprocess.Popen([sys.executable, str(TESTS / "_jax_mesh_worker.py"), "a2a", str(d)],
                           env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    two = _group("restore,resume", 2, 1, d)
    _wait([ref])
    four = _group("steps,a2a", 4, 2, d)
    _wait(four + two)
    return {"dir": d, "host": host}


def _rank(runs, scenario: str, rank: int = 0):
    return np.load(runs["dir"] / f"{scenario}-{rank}.npz")


# ---------------------------------------------------------------------------
# placed steps on 2 × 2 gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["tp", "fsdp_dp", "dp_zero1"])
def test_placed_train_step_matches_unplaced(policy, runs):
    for rank in range(4):
        got = _rank(runs, "steps", rank)
        losses, ref = got[f"{policy}_losses"], got[f"{policy}_ref_losses"]
        assert (np.abs(losses - ref) <= 1e-6 * np.abs(ref)).all(), (losses, ref)
        zero_start = [k.split("::", 1)[1] for k in got.files
                      if k.startswith(f"{policy}_zero_start::")]
        assert len(zero_start) == 6, zero_start  # 3 norm scales, 3 biases
        for name in "pmv":
            leaves = json.loads(str(got[f"{policy}_{name}_leaves"]))
            for k, (err, top) in leaves.items():
                if name != "p" or k not in zero_start:
                    assert err <= 1e-5 * top, (name, k, err, top)
        for k in zero_start:
            p, p_ref, m, m_ref, v_ref = got[f"{policy}_zero_start::{k}"]
            rms = np.sqrt(v_ref)
            sel = rms >= rms.max() / 20
            assert sel.mean() >= 0.1, (k, sel.mean())
            assert np.abs(p - p_ref)[sel].max() <= 1e-5 * np.abs(p_ref).max(), k
            assert np.abs(m - m_ref).max() <= 1e-5 * np.abs(m_ref).max(), k
    placements = json.loads(str(_rank(runs, "steps")[f"{policy}_placements"]))
    # the moments: tp mirrors the parameters (wq over "model" on its out
    # dim), the other two shard over "model" by the fsdp_dp rule
    want = "(Replicate(), Shard(dim=2))" if policy == "tp" else "(Replicate(), Shard(dim=1))"
    assert placements["layers::attn::wq::w"] == want


def test_placed_prefill_matches_the_forward(runs):
    got = _rank(runs, "steps")
    _close(got["prefill"], got["forward_last"], 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_placed_decode_matches_unplaced(masked, runs):
    """Ten decode steps on a sequence-sharded cache of 8 slots (the last
    two steps at the last slot), placed vs unplaced, with the masked
    update off and on."""
    got = _rank(runs, "steps")
    _close(got[f"decode{int(masked)}"], got[f"decode{int(masked)}_ref"], 1e-5)
    assert float(got[f"cache{int(masked)}_err"]) <= 1e-5
    other = _rank(runs, "steps", 3)
    np.testing.assert_array_equal(other[f"decode{int(masked)}"], got[f"decode{int(masked)}"])


# ---------------------------------------------------------------------------
# the all-to-all MoE dispatch against the reference's
# ---------------------------------------------------------------------------


def test_moe_layer_a2a_matches_reference(runs):
    """The reference's ``moe_layer_a2a`` on a 2 × 2 XLA:CPU mesh and the
    port's on 2 × 2 gloo ranks (E = 4: one expert a rank), on the same
    weights and input; plain and placed; both decline 3 tokens, and the
    port declines with no mesh."""
    want = np.load(runs["dir"] / "a2a_ref.npz")
    for rank in range(4):
        got = _rank(runs, "a2a", rank)
        _close(got["y"], want["y"], 1e-5)
        assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6 * abs(float(want["aux"]))
        _close(got["y_placed"], want["y"], 1e-5)
        assert abs(float(got["aux_placed"]) - float(want["aux"])) <= 1e-6 * abs(
            float(want["aux"]))
        assert bool(got["none_tokens"]) and bool(want["none_tokens"])
        assert bool(got["none_no_mesh"])
    assert str(_rank(runs, "a2a")["wg_placement"]) == "(Replicate(), Shard(dim=0))"


# ---------------------------------------------------------------------------
# restores onto placements, and the placed train_loop's resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ck_port", "ck_ref"])
def test_restore_onto_placements_gives_each_rank_its_slice(writer, runs):
    """A checkpoint written unplaced (by the port, or by the reference)
    restored onto the placements of a (1, 2) mesh: each rank's block is
    the slice of the full leaf at its offset, bit for bit, and the blocks
    of the vocab-sharded embedding differ between the ranks."""
    flat = dict(api.flatten_with_keys(runs["host"], "::"))
    for rank in range(2):
        got = _rank(runs, "restore", rank)
        for k, full in flat.items():
            block, offset = got[f"{writer}::{k}"], got[f"{writer}::{k}::offset"]
            idx = tuple(slice(o, o + n) for o, n in zip(offset, block.shape))
            np.testing.assert_array_equal(block, full[idx], err_msg=k)
    tables = [_rank(runs, "restore", r)[f"{writer}::embed::table"] for r in range(2)]
    assert tables[0].shape[0] * 2 == flat["embed::table"].shape[0]
    assert not np.array_equal(tables[0], tables[1])


def test_placed_train_loop_resumes_bit_for_bit(runs):
    """``train_loop(mesh=)`` on a (1, 2) mesh: run A; run B saving an exact
    checkpoint at step 3 and failing at step 4; run C restoring B's
    checkpoint onto the placements: C's losses and final state are A's bit
    for bit.  A also equals the unplaced run (losses within 1e-6 relative,
    the state within 1e-4 of each leaf's largest |value|; of the key
    bias's value, the elements whose gradient is at least 1/20 of its
    largest, as in the placed steps above)."""
    for rank in range(2):
        got = _rank(runs, "resume", rank)
        assert str(got["b_raised"]) == "injected failure at step 4"
        assert list(got["c_losses"]) == list(got["a_losses"][3:])
        assert bool(got["a_vs_c_bits"])
        a, u = got["a_losses"], got["u_losses"]
        assert (np.abs(a - u) <= 1e-6 * np.abs(u)).all(), (a, u)
        assert float(got["a_vs_u"]) <= 1e-4
        assert str(got["placements"]) == "(Replicate(), Shard(dim=2))"


# ---------------------------------------------------------------------------
# the mesh-only model branches, unplaced, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_mla_decode_past_the_end_matches_reference(masked):
    """MLA decode steps past ``S_max`` = 8 (steps 0-11): with
    ``decode_masked_update`` the reference writes nothing once
    ``cache_len >= S_max``; without it its ``dynamic_update_slice`` lands
    on the last slot.  The port's cache and logits follow either way."""
    cfg = replace(get_config("deepseek-v3-671b").smoke(), decode_masked_update=masked)
    jcfg = replace(jget_config("deepseek-v3-671b").smoke(), decode_masked_update=masked)
    jp = jax.jit(jattn.init_mla, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = load_params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(8).normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    m = cfg.mla
    jcache = {"c_kv": jnp.zeros((3, 8, m.kv_lora_rank)),
              "k_rope": jnp.zeros((3, 8, 1, m.qk_rope_head_dim))}
    cache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    jstep = jax.jit(jattn.mla_decode, static_argnums=2)
    last = None
    for i in range(12):
        jy, jcache = jstep(jnp.asarray(x[:, i:i + 1]), jp, jcfg, jcache, jnp.int32(i))
        y, _ = attention.mla_decode(torch.from_numpy(x[:, i:i + 1].copy()), tp, cfg, cache, i)
        _close(y, jy, 1e-5, f"step {i}")
        for k in cache:
            _close(cache[k], jcache[k], 1e-5, f"step {i} {k}")
        if i == 7:
            last = {k: v[:, 7].clone() for k, v in cache.items()}
    for k in cache:  # the last slot: step 7's latents (masked), step 11's (slice write)
        assert torch.equal(cache[k][:, 7], last[k]) == masked, k


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cache_len", [3, 7, 8, 13])
def test_gqa_masked_update_is_the_slice_write(window, cache_len):
    """The GQA decode's masked write gives the slice write's cache and
    output bit for bit, below, at and past ``S_max`` = 8 (the ring of a
    window of 8 wraps at ``cache_len % 8``; a full cache's write clamps
    nowhere: the reference writes at ``cache_len % S_max`` in both forms),
    and both the reference's within 1e-5."""
    arch = "recurrentgemma-9b" if window else "qwen2.5-3b"
    jcfg = jget_config(arch).smoke()
    jp = jax.jit(jattn.init_gqa, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tp = load_params(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(cache_len + window)
    hd = jcfg.resolved_head_dim
    k0 = rng.normal(size=(2, 8, jcfg.n_kv_heads, hd)).astype(np.float32)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    outs = {}
    for masked in (False, True):
        cfg = replace(get_config(arch).smoke(), decode_masked_update=masked)
        cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(-k0)}
        y, _ = attention.gqa_decode(torch.from_numpy(x), tp, cfg, cache, cache_len, window)
        jy, jcache = jattn.gqa_decode(jnp.asarray(x), jp, replace(jcfg, decode_masked_update=masked),
                                      {"k": jnp.asarray(k0), "v": jnp.asarray(-k0)},
                                      jnp.int32(cache_len), window)
        _close(y, jy, 1e-5)
        for k in cache:
            _close(cache[k], jcache[k], 1e-5, k)
        outs[masked] = (y, cache)
    assert torch.equal(outs[False][0], outs[True][0])
    for k in ("k", "v"):
        assert torch.equal(outs[False][1][k], outs[True][1][k])


def test_kv_replicate_decode_matches_reference():
    """``kv_replicate=2``: the reference's ``init_cache`` (KV heads doubled)
    and its decode steps, logits and cache; the logits are those of the
    unreplicated cache."""
    jcfg = replace(jget_config("qwen2.5-3b").smoke(), kv_replicate=2)
    jmodel = jbuild(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(2))
    params = load_params(jax.tree.map(np.asarray, jparams), CPU)
    model = build_model(replace(get_config("qwen2.5-3b").smoke(), kv_replicate=2))
    plain = build_model(get_config("qwen2.5-3b").smoke())
    jcache = jmodel.init_cache(2, 6, jnp.float32)
    cache = model.init_cache(2, 6, torch.float32, CPU)
    pcache = plain.init_cache(2, 6, torch.float32, CPU)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert cache["k"].shape[3] == 2 * pcache["k"].shape[3]
    jstep = jax.jit(jmodel.decode_step)
    toks = np.random.default_rng(3).integers(0, 256, (5, 2)).astype(np.int32)
    for i, tok in enumerate(toks):
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache, jnp.int32(i))
        logits, _ = model.decode_step(params, torch.from_numpy(tok), cache, i)
        plogits, _ = plain.decode_step(params, torch.from_numpy(tok), pcache, i)
        _close(logits, jlogits, 1e-5)
        _close(logits, plogits.numpy(), 1e-5)
    for k in cache:
        _close(cache[k], jcache[k], 1e-5, k)
        np.testing.assert_array_equal(cache[k][:, :, :, ::2].numpy(), pcache[k].numpy())


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("group", [8, 16, 64])
def test_moe_layer_grouped_matches_reference(arch, group):
    """The group-blocked dispatch with no mesh: each group's routing (top-k
    indices identical, gates within 4 ulp) and the layer's output and aux
    loss, against the reference's ``moe_layer_grouped``; a group as large
    as the batch is the dense dispatch's routing."""
    jcfg = replace(jget_config(arch).smoke(), moe_group_size=group)
    jp = jax.jit(jmoe.init_moe, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    tp = load_params(jax.tree.map(np.asarray, jp), CPU)
    cfg = replace(get_config(arch).smoke(), moe_group_size=group)
    x = np.random.default_rng(group).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    tg = min(group, 64)
    logits = x.reshape(64 // tg, tg, -1) @ np.asarray(jp["router"])
    jprobs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jgates, jidx = jax.lax.top_k(jprobs, cfg.moe.top_k)
    probs, gates, idx = moe._top_k_gating(torch.from_numpy(logits), cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jgates = np.asarray(jgates / jnp.sum(jgates, axis=-1, keepdims=True))
    assert _ulps(gates.numpy(), jgates) <= 4
    jy, jaux = jmoe.moe_layer_grouped(jnp.asarray(x), jp, jcfg)
    y, aux = moe.moe_layer(torch.from_numpy(x), tp, cfg)
    _close(y, jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
