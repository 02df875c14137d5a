"""Training launcher: --arch config → train loop with HPDR features
(counterpart of ``repro.launch.train``).

The path: data stream → train step (loss and backward, the schedule's
learning rate, AdamW in place with the non-finite guard) → straggler
watchdog → HPDR-compressed checkpoints (exact by default) → auto-restore
on restart.

Without ``mesh`` every tensor lives on ``device`` (default: the card;
without one, ``device="cpu"`` must be asked for).  With ``mesh`` (a
DeviceMesh over the ranks, e.g. ``launch.mesh.make_test_mesh``), as the
reference does on its test mesh: the parameters and both moments are
placed by ``runtime.sharding.param_shardings``, the optimizer's step
replicated, each batch ``Shard(0)`` over the data axes; the step runs on
DTensors (``launch.specs``), and a restart restores onto the same
placements.  The step runs eagerly (no ``torch.compile``).  Parameters
come from ``Model.init`` with a ``torch.Generator`` seeded 0 on that
device: the reference's init scheme, the port's own random stream; placed,
every rank makes them and keeps its block.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --ckpt-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --full --steps 6
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from ..checkpoint import CheckpointManager, CheckpointPolicy
from ..configs import get_config
from ..data import DataConfig, SyntheticLMStream
from ..models import build_model
from ..optim import adamw, schedule
from ..runtime import fault
from ..runtime import sharding as shr


def resolve_device(device=None) -> torch.device:
    """``device``, or the current card when it is None; without a card the
    CPU must be named (training never falls back to it quietly)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("train_loop runs on the CUDA card and none is available; pass "
                           "device='cpu' to train on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_train_step(model, opt_cfg: adamw.AdamWConfig, sched_fn, lr: float, steps: int):
    """The reference's ``train_step``: loss and backward, ``lr_t`` from the
    schedule at the optimizer's step, AdamW with the non-finite guard.
    Updates ``params`` and ``opt_state`` in place and returns the metrics
    (``ce``, ``aux``, ``loss``, ``grad_norm``, ``finite``; tensors on the
    device)."""

    def train_step(params, opt_state, batch_) -> dict:
        with shr.placed_ops():
            (_loss, metrics), grads = model.value_and_grad(params, batch_)
            step = opt_state["step"]
            lr_t = sched_fn(step.to_local() if shr.is_placed(step) else step, peak_lr=lr,
                            warmup=max(steps // 10, 1), total=steps)
            metrics.update(adamw.apply_updates_(params, grads, opt_state, lr_t, opt_cfg))
        return {k: shr.whole(v) for k, v in metrics.items()}

    return train_step


def train_loop(
    arch: str,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    smoke: bool = True,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    lr: float = 3e-4,
    sched: str = "cosine",
    log_every: int = 10,
    exact_ckpt: bool = True,
    inject_failure_at: int | None = None,
    sync_ckpt: bool = False,
    device=None,
    mesh=None,
) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from the newest
    checkpoint in ``ckpt_dir``), on ``device`` or placed over ``mesh``.
    Returns the reference's dict (``first_loss``, ``last_loss``,
    ``steps_run``, ``stragglers``, ``ckpt_report``) and, for its callers'
    checks, ``losses``, ``finite`` and ``step_s`` of every step run and the
    final ``state`` (``{"params", "opt"}``, on the device or placed)."""
    if mesh is not None and device is None:
        device = "cpu" if mesh.device_type == "cpu" else None
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = replace(cfg, remat=False) if seq * batch <= 16384 else cfg
    model = build_model(cfg)

    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    places = None
    if mesh is not None:  # onto the mesh, as the reference's device_put
        p_sh = shr.param_shardings(model.param_shapes(), cfg, mesh)
        places = {"params": p_sh,
                  "opt": {"m": p_sh, "v": p_sh, "step": shr.replicated(mesh)}}
        params, opt_state = _placed(places, {"params": params, "opt": opt_state}).values()

    sched_fn = schedule.SCHEDULES[sched]
    data = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
                             device, mesh)
    train_step = make_train_step(model, opt_cfg, sched_fn, lr, steps)

    mgr = None
    start_step = 0
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, CheckpointPolicy(exact=exact_ckpt),
                                backend="torch" if device.type == "cpu" else None)
        latest = mgr.latest_step()
        if latest is not None:
            # the target gives each leaf's dtype and device; the initial
            # state goes before the restored one is made (at qwen2.5-3b both
            # would take 74 GB)
            target = adamw.map_tree(lambda t: torch.empty(0, dtype=t.dtype, device=device),
                                    {"params": params, "opt": opt_state})
            del params, opt_state
            tree, manifest = mgr.restore(latest, target=target, shardings=places)
            params, opt_state = tree["params"], tree["opt"]
            data.load_state_dict(manifest["extra"]["data"])
            start_step = latest
            print(f"[restore] resumed from step {latest} "
                  f"(ratio {manifest['ratio']:.2f}x)")

    watchdog = fault.StragglerWatchdog()
    losses, finite, step_s = [], [], []
    try:
        for step in range(start_step, steps):
            if inject_failure_at is not None and step == inject_failure_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch_ = data.next_batch()
            metrics = train_step(params, opt_state, batch_)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = watchdog.observe(dt)
            losses.append(loss)
            finite.append(bool(metrics["finite"]))
            step_s.append(dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss:.4f} {dt*1e3:7.1f} ms"
                      + (" [straggler]" if slow else ""))
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                save = mgr.save if sync_ckpt else mgr.save_async
                save(step + 1, {"params": params, "opt": opt_state},
                     extra={"data": data.state_dict()})
        if mgr:
            mgr.wait()
    finally:
        if mgr:
            mgr.close()
    return {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "stragglers": watchdog.flagged,
        "ckpt_report": mgr.last_report if mgr else None,
        "losses": losses,
        "finite": finite,
        "step_s": step_s,
        "state": {"params": params, "opt": opt_state},
    }


def _placed(places: dict, tree: dict) -> dict:
    """``tree``'s leaves placed by the same-shaped ``places``."""
    from ..core import api

    where = dict(api.flatten_with_keys(places))
    flat = dict(api.flatten_with_keys(tree))
    return api.unflatten_like(tree, lambda k: where[k].distribute(flat[k]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=list(schedule.SCHEDULES))
    args = ap.parse_args()
    out = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        lr=args.lr, sched=args.schedule,
    )
    out.pop("state")
    print(out)


if __name__ == "__main__":
    main()
