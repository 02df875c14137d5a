"""One rank of the placed-path tests (``tests/test_torch_placed.py``,
``tests/test_torch_sharding.py``): run as ``python _torch_placed_worker.py
<scenarios> <rank> <world> <store file> <dir> <n_data>``; joins a gloo
group of ``world`` ranks through the file store, makes the
``(n_data, world / n_data)`` ``("data","model")`` mesh on the CPU, runs each
of the comma-separated ``<scenarios>`` (reading its inputs from ``<dir>``)
and saves what it found in ``<dir>/<scenario>-<rank>.npz``."""

import json
import sys
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")
SEQ, BATCH = 16, 4
POLICIES = ("tp", "fsdp_dp", "dp_zero1")


def _flat(tree):
    from repro_torch.core import api

    return dict(api.flatten_with_keys(tree, "::"))


def _whole(x):
    from repro_torch.runtime.sharding import is_placed

    return (x.full_tensor() if is_placed(x) else x).detach().numpy()


def _batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def _place(tree, places):
    from repro_torch.core import api

    where = _flat(places)
    flat = _flat(tree)
    # a copy: a placed block may share the full tensor's memory
    return api.unflatten_like(tree, lambda k: where[k].distribute(flat[k].clone()), "::")


def steps(out: dict, mesh, in_dir: Path) -> None:
    """``make_train_step`` under three policies, ``make_prefill_step`` and
    ``make_decode_step`` (masked update on and off), placed on ``mesh``
    and unplaced, on the same weights and batches."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shr

    opt_cfg = adamw.AdamWConfig()
    for policy in POLICIES:
        cfg = replace(get_config("qwen1.5-4b").smoke(), sharding_policy=policy)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), CPU)
        state = adamw.init_state(params, opt_cfg)
        step = S.make_train_step(model, opt_cfg)
        batches = [_batch(cfg.vocab, 10 + i) for i in range(2)]
        with use_mesh(mesh):
            pp = _place(params, shr.param_shardings(params, cfg, mesh))
            sds = S.opt_state_specs(S.param_specs(model, mesh), mesh, opt_cfg, cfg)
            ps = {"m": _place(state["m"], _placements_of(sds["m"])),
                  "v": _place(state["v"], _placements_of(sds["v"])),
                  "step": shr.replicated(mesh).distribute(state["step"].clone())}
            losses = []
            for b in batches:
                pb = _place(b, shr.batch_shardings(b, cfg, mesh))
                _p, _s, metrics = step(pp, ps, pb)
                losses.append(float(metrics["loss"]))
        ref_losses = [float(step(params, state, b)[2]["loss"]) for b in batches]
        out[f"{policy}_losses"] = np.array(losses)
        out[f"{policy}_ref_losses"] = np.array(ref_losses)
        for name, tree, ref in (("p", pp, params), ("m", ps["m"], state["m"]),
                                ("v", ps["v"], state["v"])):
            got, want = _flat(tree), _flat(ref)
            out[f"{policy}_{name}_leaves"] = np.array(json.dumps({k: [
                float(np.abs(_whole(got[k]) - want[k].numpy()).max()),
                float(want[k].abs().max())] for k in want}))
        # the leaves that start at zero, element by element: the value and
        # the moment m, placed and unplaced, and the unplaced v
        fp, fr, fm, fmr, fvr = (_flat(t) for t in (pp, params, ps["m"], state["m"], state["v"]))
        for k in fr:
            if k.endswith("scale") or k.endswith("::b"):
                out[f"{policy}_zero_start::{k}"] = np.stack([
                    _whole(fp[k]), fr[k].numpy(), _whole(fm[k]), fmr[k].numpy(),
                    fvr[k].numpy()])
        out[f"{policy}_placements"] = np.array(json.dumps(
            {k: str(v.placements) for k, v in _flat(ps["m"]).items()}))

    # prefill and decode under tp, on fresh weights
    cfg = get_config("qwen1.5-4b").smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), CPU)
    b = _batch(cfg.vocab, 20)
    prompt = {"tokens": b["tokens"]}
    with use_mesh(mesh):
        pp = _place(params, shr.param_shardings(params, cfg, mesh))
        pb = _place(prompt, shr.batch_shardings(prompt, cfg, mesh))
        out["prefill"] = _whole(S.make_prefill_step(model)(pp, pb))
    with torch.no_grad():
        from repro_torch.models.layers import rms_norm

        x = model._embed_in(params, prompt)
        h, _ = model._backbone(params, x, prompt)
        out["forward_last"] = model._head(
            params, rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps))[:, -1].numpy()
    for masked in (False, True):
        mcfg = replace(cfg, decode_masked_update=masked)
        mmodel = build_model(mcfg)
        dstep = S.make_decode_step(mmodel)
        shape = ShapeConfig("d", 8, BATCH, "decode")
        cache = mmodel.init_cache(BATCH, shape.seq_len, torch.float32, CPU)
        ref_cache = mmodel.init_cache(BATCH, shape.seq_len, torch.float32, CPU)
        toks = b["tokens"][:, :10]
        got, want = [], []
        with use_mesh(mesh):
            pp = _place(params, shr.param_shardings(params, mcfg, mesh))
            pc = _place(cache, shr.cache_shardings(cache, mcfg, mesh))
            for i in range(toks.shape[1]):  # past S_max: the ring's last slot
                tok = shr.placed(shr.P(shr.dp_axes(mesh)), mesh).distribute(toks[:, i].clone())
                lg, pc = dstep(pp, tok, pc, min(i, shape.seq_len - 1))
                got.append(_whole(lg))
        for i in range(toks.shape[1]):
            lg, ref_cache = mmodel.decode_step(params, toks[:, i].clone(), ref_cache,
                                               min(i, shape.seq_len - 1))
            want.append(lg.numpy())
        out[f"decode{int(masked)}"] = np.stack(got)
        out[f"decode{int(masked)}_ref"] = np.stack(want)
        out[f"cache{int(masked)}_err"] = np.array(max(
            float(np.abs(_whole(pc[k]) - ref_cache[k].numpy()).max()) for k in ref_cache))


def _placements_of(tree):
    from repro_torch.core import api
    from repro_torch.runtime import sharding as shr

    flat = _flat(tree)
    return api.unflatten_like(
        tree, lambda k: shr.Placed(flat[k].device_mesh, tuple(flat[k].placements), shr.P()),
        "::")


def a2a(out: dict, mesh, in_dir: Path) -> None:
    """``moe_layer_a2a`` on the reference's weights and input, plain and
    placed, and where it declines."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as shr

    src = np.load(in_dir / "a2a_in.npz")
    cfg = replace(get_config("deepseek-v3-671b").smoke(), moe_impl="a2a")
    lp = {k: torch.from_numpy(src[k]) for k in ("router", "wg", "wu", "wd")}
    lp["shared"] = {k: torch.from_numpy(src["shared_" + k]) for k in ("wg", "wu", "wd")}
    x = torch.from_numpy(src["x"])
    with use_mesh(mesh):
        y, aux = moe.moe_layer_a2a(x, lp, cfg)
        out["y"], out["aux"] = y.numpy(), aux.numpy()
        out["none_tokens"] = np.array(moe.moe_layer_a2a(x[:, :3], lp, cfg) is None)
        flat = _flat(lp)
        places = {k: shr.placed(shr.param_spec(["moe"] + k.split("::"), v, cfg, mesh), mesh)
                  for k, v in flat.items()}
        from repro_torch.core import api

        plp = api.unflatten_like(lp, lambda k: places[k].distribute(flat[k].clone()), "::")
        px = shr.placed(shr.P(shr.dp_axes(mesh)), mesh).distribute(x.clone())
        y2, aux2 = moe.moe_layer_a2a(px, plp, cfg)
        out["y_placed"], out["aux_placed"] = _whole(y2), _whole(aux2)
        out["wg_placement"] = np.array(str(plp["wg"].placements))
    out["none_no_mesh"] = np.array(moe.moe_layer_a2a(x, lp, cfg) is None)


def blocks(out: dict, mesh, in_dir: Path) -> None:
    """This rank's block (offset and shape) of each ``(shape, spec)`` case."""
    from repro_torch.runtime import sharding as shr

    cases = json.loads((in_dir / "blocks_in.json").read_text())
    got = []
    for shape, spec in cases:
        spec = shr.P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        bshape, offset = shr.local_block(shape, mesh, shr.to_placements(spec, mesh))
        x = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
        local = shr.placed(spec, mesh).distribute(x).to_local()
        got.append({"offset": list(offset), "shape": list(bshape),
                    "values_ok": bool(torch.equal(local, x[tuple(
                        slice(o, o + n) for o, n in zip(offset, bshape))]))})
    out["blocks"] = np.array(json.dumps(got))
    out["coord"] = np.array(mesh.get_coordinate())


def resume(out: dict, mesh, in_dir: Path) -> None:
    """The placed ``train_loop``: run A, run B failing after a checkpoint,
    run C resuming B onto the placements; and the unplaced run."""
    from repro_torch.launch.train import train_loop

    kw = dict(steps=6, batch=4, seq=16, log_every=100, device="cpu")
    a = train_loop("qwen2.5-3b", mesh=mesh, **kw)
    ck = str(in_dir / "ck")
    try:
        train_loop("qwen2.5-3b", mesh=mesh, ckpt_dir=ck, ckpt_every=3, sync_ckpt=True,
                   inject_failure_at=4, **kw)
    except RuntimeError as e:
        out["b_raised"] = np.array(str(e))
    c = train_loop("qwen2.5-3b", mesh=mesh, ckpt_dir=ck, ckpt_every=3, **kw)
    u = train_loop("qwen2.5-3b", **kw)
    out["a_losses"], out["c_losses"] = np.array(a["losses"]), np.array(c["losses"])
    out["u_losses"] = np.array(u["losses"])
    fa, fc, fu = (_flat(r["state"]) for r in (a, c, u))
    out["a_vs_c_bits"] = np.array(all(torch.equal(fa[k].to_local(), fc[k].to_local())
                                      for k in fa))
    # the key bias's value on the elements whose gradient is at least 1/20
    # of the leaf's largest (see tests/test_torch_placed.py), every other
    # leaf whole
    errs = {}
    for k in fu:
        got, want = _whole(fa[k]).astype(np.float64), fu[k].double().numpy()
        if k == "params::layers::attn::wk::b":
            rms = np.sqrt(fu["opt::v::layers::attn::wk::b"].double().numpy())
            sel = rms >= rms.max() / 20
            got, want = got[sel], want[sel]
        errs[k] = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    out["a_vs_u"] = np.array(max(errs.values()))
    out["placements"] = np.array(str(fa["params::layers::mlp::wg"].placements))


def restore(out: dict, mesh, in_dir: Path) -> None:
    """Checkpoints written unplaced by the port and by the reference,
    restored onto placements: each rank's block and offset."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shr

    cfg = get_config("qwen2.5-3b").smoke()
    shapes = build_model(cfg).param_shapes()
    places = shr.param_shardings(shapes, cfg, mesh)
    for name in ("ck_port", "ck_ref"):
        mgr = CheckpointManager(in_dir / name, backend="torch")
        tree, _ = mgr.restore(target=shapes, shardings=places)
        mgr.close()
        for k, v in _flat(tree).items():
            _shape, offset = shr.local_block(v.shape, mesh, v.placements)
            out[f"{name}::{k}"] = v.to_local().numpy()
            out[f"{name}::{k}::offset"] = np.array(offset)


SCENARIOS = {"steps": steps, "a2a": a2a, "blocks": blocks, "resume": resume,
             "restore": restore}


def main() -> None:
    scenarios, rank, world, store, out_dir, n_data = sys.argv[1:7]
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    from repro_torch.launch.mesh import make_mesh

    n_data = int(n_data)
    mesh = make_mesh((n_data, world // n_data), ("data", "model"), "cpu")
    for scenario in scenarios.split(","):
        out: dict = {}
        SCENARIOS[scenario](out, mesh, out_dir)
        np.savez(out_dir / f"{scenario}-{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
