"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's, spec for spec, on the CPU.

Both packages' rules run on abstract meshes of the production shapes,
(16, 16) ``("data","model")`` and (2, 16, 16) ``("pod","data","model")``,
over every config at full width (the reference's trees from
``jax.eval_shape``, the port's on the ``meta`` device: nothing is
allocated), under ``tp`` with ``fsdp`` off and on, ``fsdp_dp``,
``dp_zero1``, and ``moe_group_size=4096`` for the moe configs.  Specs are
compared entry for entry (a one-axis tuple and its axis name are the same
entry); ``sharding_report`` exactly.  The placements that the specs become
are held to JAX's own layout: on 2 × 2 gloo ranks, each rank's block of a
tensor is the slice that ``NamedSharding(...).addressable_devices_indices_map``
gives the device at the same mesh position (four XLA:CPU devices, in a
process of their own).
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
from jax.sharding import AbstractMesh as JAbstractMesh
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as JS
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.runtime import sharding as jshr
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import api
from repro_torch.models import build_model
from repro_torch.runtime import sharding as shr

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
MESHES = {"pod256": ((16, 16), ("data", "model")),
          "pod512": ((2, 16, 16), ("pod", "data", "model"))}


def _policies(cfg) -> list[dict]:
    out = [{"sharding_policy": "tp", "fsdp": False}, {"sharding_policy": "tp", "fsdp": True},
           {"sharding_policy": "fsdp_dp"}, {"sharding_policy": "dp_zero1"}]
    if cfg.family == "moe":
        out.append({"moe_group_size": 4096})
    return out


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def _norm(spec) -> tuple:
    return tuple(_entry(e) for e in spec)


def _jspecs(tree) -> dict:
    """``{key: spec}`` of a tree of the reference's ShapeDtypeStructs or
    NamedShardings, keyed as the port flattens."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in path)
        sharding = getattr(leaf, "sharding", leaf)
        out[key] = _norm(sharding.spec)
    return out


def _pspecs(tree, fn) -> dict:
    return {k: _norm(fn(k.split("/"), x)) for k, x in api.flatten_with_keys(tree, "/")}


@pytest.fixture(scope="module")
def shapes():
    """Both packages' full-width parameter trees, shapes only."""
    out = {}
    for name in ARCHS:
        jmodel = jbuild(JARCHS[name])
        out[name] = (jax.eval_shape(lambda m=jmodel: m.init(jax.random.PRNGKey(0))),
                     build_model(ARCHS[name]).param_shapes())
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_report_are_the_reference_s(arch, shapes):
    jshape, pshape = shapes[arch]
    for mesh_name, (sizes, axes) in MESHES.items():
        jmesh, mesh = JAbstractMesh(sizes, axes), shr.AbstractMesh(sizes, axes)
        for kw in _policies(ARCHS[arch]):
            jcfg, cfg = replace(JARCHS[arch], **kw), replace(ARCHS[arch], **kw)
            want = _jspecs(jshr.param_shardings(jshape, jcfg, jmesh))
            got = _pspecs(pshape, lambda n, x: shr.param_spec(n, x, cfg, mesh))
            assert got == want and len(got) > 5, (mesh_name, kw)
            if kw == {"sharding_policy": "tp", "fsdp": True} and "table" in str(list(got)):
                assert any("model" in spec and "data" in spec for spec in got.values())
            assert shr.sharding_report(pshape, cfg, mesh) == \
                jshr.sharding_report(jshape, jcfg, jmesh), (mesh_name, kw)
            # the optimizer's moments (ZeRO-1: the fsdp_dp rule's)
            jpsds = JS.param_specs(jbuild(jcfg), jmesh)
            jopt = JS.opt_state_specs(jpsds, jmesh, jadamw.AdamWConfig(), jcfg)
            got = _pspecs(pshape, lambda n, x: shr.opt_state_spec(n, x, cfg, mesh))
            for moment in ("m", "v"):
                assert {f"{moment}/{k}": v for k, v in got.items()} == \
                    {k: v for k, v in _jspecs(jopt).items() if k.startswith(moment + "/")}
            assert _jspecs(jopt)["step"] == ()
    # every spec has its DTensor placements: a Shard(d) for each axis dim d names
    mesh = shr.AbstractMesh(*MESHES["pod512"])
    for kw in _policies(ARCHS[arch]):
        cfg = replace(ARCHS[arch], **kw)
        for key, x in api.flatten_with_keys(pshape):
            spec = shr.param_spec(key.split("/"), x, cfg, mesh)
            placements = shr.to_placements(spec, mesh, x.ndim)
            for d, entry in enumerate(spec):
                named = 0 if entry is None else len(entry) if isinstance(entry, tuple) else 1
                assert sum(getattr(p, "dim", None) == d for p in placements) == named, key


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_specs_are_the_reference_s(arch):
    """Decode caches (encdec with its cross K/V, the hybrid's ``h`` and
    ``conv``, MLA's latents; ``kv_replicate=2`` for the GQA caches of the
    dense configs) and train/prefill batches, on both meshes."""
    variants = [{}]
    if ARCHS[arch].family in ("dense", "vlm"):
        variants.append({"kv_replicate": 2})
    for sizes, axes in MESHES.values():
        jmesh, mesh = JAbstractMesh(sizes, axes), shr.AbstractMesh(sizes, axes)
        for kw in variants:
            jcfg, cfg = replace(JARCHS[arch], **kw), replace(ARCHS[arch], **kw)
            for shape_name in ("decode_32k", "long_500k"):
                shape = SHAPES[shape_name]
                want = _jspecs(JS.cache_specs(jbuild(jcfg), JSHAPES[shape_name], jmesh))
                cache = build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                                    torch.bfloat16, device="meta")
                if cfg.family == "encdec":  # the cross K/V, as specs.cache_specs adds them
                    cross = torch.empty((cfg.n_dec_layers, shape.global_batch, shape.seq_len,
                                         cfg.n_kv_heads, cfg.resolved_head_dim), device="meta")
                    cache = dict(cache, cross_k=cross, cross_v=cross)
                got = _pspecs(cache, lambda n, x: shr.cache_spec(n, x, cfg, mesh))
                assert got == want and got, (axes, kw, shape_name)
            for policy in ("tp", "fsdp_dp", "dp_zero1"):
                jp, p = (replace(c, sharding_policy=policy) for c in (jcfg, cfg))
                for shape_name in ("train_4k", "prefill_32k", "long_500k"):
                    jb = JS.batch_specs(jp, JSHAPES[shape_name], jmesh)
                    jbs = jshr.batch_shardings(jax.tree.map(
                        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), jb), jp, jmesh)
                    got = {k: _norm(shr.batch_spec(torch.empty(x.shape, device="meta"), p,
                                                   mesh))
                           for k, x in _jspecs_shapes(jb).items()}
                    assert got == _jspecs(jbs), (axes, policy, shape_name)


def _jspecs_shapes(tree) -> dict:
    return {"/".join(str(getattr(e, "key", "")) for e in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_to_placements_orders_mesh_dims_as_jax_does(tmp_path):
    """Each of four gloo ranks' block on a 2 × 2 ``("data","model")`` mesh is
    the slice that the reference's ``NamedSharding`` gives the device at the
    same mesh position, for specs over one axis, two axes on one dim (the
    tuple, major to minor), and two dims."""
    cases = [[[8, 6], ["data", None]], [[8, 6], [None, "model"]],
             [[8, 6], [["data", "model"], None]], [[4, 8, 2], ["model", "data"]],
             [[6, 8], [None, ["data", "model"]]], [[5, 3], []]]
    (tmp_path / "blocks_in.json").write_text(json.dumps(cases))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    ref = subprocess.run([sys.executable, str(TESTS / "_jax_mesh_worker.py"), "blocks",
                          str(tmp_path)], env=env, cwd=ROOT, capture_output=True, timeout=240)
    assert ref.returncode == 0, ref.stderr.decode()[-2000:]
    procs = [subprocess.Popen([sys.executable, str(TESTS / "_torch_placed_worker.py"), "blocks",
                               str(r), "4", str(tmp_path / "store"), str(tmp_path), "2"],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    for p in procs:
        _out, err = p.communicate(timeout=480)
        assert p.returncode == 0, err.decode()[-2000:]
    want = json.loads((tmp_path / "blocks_ref.json").read_text())
    for r in range(4):
        got = np.load(tmp_path / f"blocks-{r}.npz")
        i, j = (int(c) for c in got["coord"])
        assert (i, j) == divmod(r, 2)
        for case, found, ref_case in zip(cases, json.loads(str(got["blocks"])), want):
            assert found["values_ok"], case
            assert [[o, n] for o, n in zip(found["offset"], found["shape"])] == ref_case[i][j], \
                (case, r)
    # an axis tuple out of the mesh's order has no DTensor form
    with pytest.raises(ValueError, match="order"):
        shr.to_placements(shr.P(("model", "data")), shr.AbstractMesh((2, 2), ("data", "model")))


def test_constrain_activation_dp_is_a_no_op_off_mesh():
    x = torch.ones(4, 3)
    assert shr.constrain_activation_dp(x) is x
    with_mesh = shr.AMBIENT_MESH.set(shr.AbstractMesh((2, 2), ("data", "model")))
    try:
        assert shr.constrain_activation_dp(x) is x  # a plain tensor stays as it is
    finally:
        shr.AMBIENT_MESH.reset(with_mesh)
    jx = jnp.ones((4, 3))
    assert jshr.constrain_activation_dp(jx) is jx
