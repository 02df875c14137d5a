#!/usr/bin/env python3
"""What the subnormal flush costs AdamW's in-place step on one CUDA card.

The port's ``optim/adamw.py`` flushes subnormal products and sums to zero,
as XLA does on the reference's CPU.  This script times the training step of
qwen2.5-3b at full width and depth (36 layers, 3.09B float32 parameters
from a seed, bfloat16 compute, float32 moments, a batch of 8 x 128 tokens,
as ``chip_smoke.py``'s training phase runs it) with the shipped optimizer
and with an earlier ``adamw.py`` given by path, in turns
``parent, change, change, parent`` on the same parameters:

    python3 scripts/adamw_flush_ablation.py --parent PATH/TO/OLD/adamw.py

Run it from the root of a checkout, on a machine with an H100; the older
file is loaded as a module of ``repro_torch.optim`` so its relative imports
resolve against this checkout.  For each turn it prints, beside the card's
name and power limit: the whole step (``value_and_grad`` and
``apply_updates_``; host wall, synchronised, median of 5 after a warm-up
step) with its peak ``max_memory_allocated``, and ``apply_updates_``
alone (CUDA events, median of 5); first, ``value_and_grad``'s own peak.
"""

from __future__ import annotations

import argparse
import importlib.util
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path, help="an earlier optim/adamw.py")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("adamw_flush_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedule

    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"parent": load_parent(args.parent), "change": adamw}
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    cfg_opt = adamw.AdamWConfig()
    state = adamw.init_state(params, cfg_opt)
    data = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH), device)
    batch = data.next_batch()

    def step(opt):
        (_loss, _m), grads = model.value_and_grad(params, batch)
        lr = schedule.cosine(state["step"], peak_lr=3e-4, warmup=1, total=100)
        opt.apply_updates_(params, grads, state, lr, cfg_opt)

    def update_ms(opt) -> float:
        (_loss, _m), grads = model.value_and_grad(params, batch)
        times = []
        for _ in range(RUNS):
            g = adamw.map_tree(torch.clone, grads)  # apply_updates_ consumes its gradients
            lr = schedule.cosine(state["step"], peak_lr=3e-4, warmup=1, total=100)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            opt.apply_updates_(params, g, state, lr, cfg_opt)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
            del g
        return statistics.median(times)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.value_and_grad(params, batch)
    print(f"[{card}] value_and_grad alone: peak {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    for name in ("parent", "change", "change", "parent"):
        opt = variants[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(opt)
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            step(opt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        upd = update_ms(opt)
        print(f"[{card}] {name}: train step (value_and_grad + apply_updates_, {BATCH} x {SEQ} "
              f"tokens) median {statistics.median(times):.3f} ms of {[round(t, 3) for t in times]}"
              f", peak {peak} bytes; apply_updates_ alone (events, on a copy of the gradients) "
              f"median {upd:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
