#!/usr/bin/env python3
"""Where a placed training step's host time goes, on one CUDA card.

Runs the training step of qwen2.5-3b at full width (bfloat16 compute,
float32 parameters and AdamW moments from a seed, a batch of 8 x 128
tokens, as ``chip_smoke.py``'s placed phase) through
``launch.specs.make_train_step``, unplaced and placed on a 1 x 1
``("data","model")`` mesh over the card (a world-size-1 NCCL group; every
placement ``Replicate``, the placed leaves sharing the unplaced ones'
memory).  For each it prints, beside the card's name and power limit:

* the step, its loss and gradients (``Model.value_and_grad``) and its
  AdamW update (``adamw.apply_updates_``), each timed alone (host wall,
  synchronised, median of 5 after a warm-up);
* one step under ``torch.profiler`` (CPU and CUDA): the host wall, the
  time the card was busy (the union of its kernels' spans), the kernels
  and the NCCL kernels launched, the ops dispatched on the host, the host
  time inside them, and the ops with the most host time of their own.

    python3 scripts/placed_step_trace.py [--layers N] [--parent PATH/TO/adamw.py]

``--device cpu`` runs the same on the CPU (a gloo group; for a check of
the script at a small ``--layers``, with no card figures).  ``--parent``
also times the placed ``apply_updates_`` of another
``optim/adamw.py`` beside the shipped one, in turns parent, change,
change, parent (loaded as a module of ``repro_torch.optim``, so its
relative imports resolve against this checkout).  Run it from the root of
a checkout, on a machine with an H100.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
ARCH, BATCH, SEQ, RUNS = "qwen2.5-3b", 8, 128, 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def load_parent(path: Path):
    name = "repro_torch.optim.adamw_parent"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "repro_torch.optim"
    sys.modules[name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def median_ms(fn, runs: int = RUNS) -> float:
    fn()
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def traced(fn, top: int = 8) -> dict:
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    # ops called from Python (no host op above them): their spans hold
    # every op they dispatch
    outer = [e for e in host if e.cpu_parent is None and e.name.startswith("aten::")]
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)[:top]
    return {
        "wall_ms": wall_ms, "busy_ms": busy / 1e3, "kernels": len(device),
        "nccl": sum("nccl" in e.name.lower() for e in device),
        "host_ops": sum(e.name.startswith("aten::") for e in host),
        "outer_ops": len(outer),
        "outer_ms": sum(e.cpu_time_total for e in outer) / 1e3,
        "top": [(r.key, r.count, r.self_cpu_time_total / 1e3) for r in rows],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the config's)")
    ap.add_argument("--parent", type=Path, default=None, help="another optim/adamw.py")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("placed_step_trace: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shr

    card = card_line() if args.device == "cuda" else "cpu (no card figures)"
    print(card, flush=True)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    cfg = get_config(ARCH)
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    cfg = replace(cfg, remat=False)  # as train_loop at 8 x 128
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    state = adamw.init_state(params, opt_cfg)
    data = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH), device)
    batch = data.next_batch()
    step = S.make_train_step(model, opt_cfg)

    mesh = make_test_mesh(1, 1, device)
    try:
        places = dict(api.flatten_with_keys(shr.param_shardings(params, cfg, mesh)))

        def placed(tree):
            return api.unflatten_like(tree, lambda k: DTensor.from_local(
                dict(api.flatten_with_keys(tree))[k], mesh, list(places[k].placements),
                run_check=False))

        with use_mesh(mesh):
            rep = shr.replicated(mesh)
            runs = {
                "unplaced": (params, state, batch),
                "placed": (placed(params),
                           {"m": placed(state["m"]), "v": placed(state["v"]),
                            "step": DTensor.from_local(state["step"], mesh,
                                                       list(rep.placements), run_check=False)},
                           {k: DTensor.from_local(v, mesh, list(shr.batch_shardings(
                               batch, cfg, mesh)[k].placements), run_check=False)
                            for k, v in batch.items()}),
            }
            print(f"{ARCH}: {cfg.n_layers} layers, {BATCH} x {SEQ} tokens a step, "
                  f"{len(places)} parameter leaves; mesh {tuple(mesh.mesh.shape)} "
                  f"{mesh.mesh_dim_names}", flush=True)
            for name, (p, s, b) in runs.items():
                grads = {}

                def vg(p=p, b=b):
                    with shr.placed_ops():
                        grads["g"] = model.value_and_grad(p, b)[1]

                def upd(p=p, s=s, mod=adamw):
                    with shr.placed_ops():
                        mod.apply_updates_(p, grads["g"], s, 3e-4, opt_cfg)

                step_ms = median_ms(lambda p=p, s=s, b=b: step(p, s, b))
                vg_ms = median_ms(vg)
                upd_ms = median_ms(upd)  # the same gradients again: the same work
                tr = traced(lambda p=p, s=s, b=b: step(p, s, b))
                print(f"{name}: step {step_ms:.3f} ms (value_and_grad {vg_ms:.3f} ms, "
                      f"apply_updates_ {upd_ms:.3f} ms); traced step: host wall "
                      f"{tr['wall_ms']:.3f} ms, card busy {tr['busy_ms']:.3f} ms, "
                      f"{tr['kernels']} device events ({tr['nccl']} NCCL), {tr['host_ops']} "
                      f"host ops, {tr['outer_ops']} called from Python taking "
                      f"{tr['outer_ms']:.3f} ms of host time", flush=True)
                for key, count, ms in tr["top"]:
                    print(f"  {name} self host time: {key} x{count} {ms:.3f} ms", flush=True)
            if args.parent is not None:
                p, s, b = runs["placed"]
                with shr.placed_ops():
                    g = model.value_and_grad(p, b)[1]
                variants = {"parent": load_parent(args.parent), "change": adamw}
                for turn in ("parent", "change", "change", "parent"):

                    def one(mod=variants[turn]):
                        with shr.placed_ops():
                            mod.apply_updates_(p, g, s, 3e-4, opt_cfg)

                    source = args.parent if turn == "parent" else "the shipped optim/adamw.py"
                    print(f"placed apply_updates_, {turn} ({source}): {median_ms(one):.3f} ms",
                          flush=True)
    finally:
        dist.destroy_process_group()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
