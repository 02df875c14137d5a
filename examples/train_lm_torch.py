"""End-to-end training driver on the PyTorch/CUDA port: LM training with
HPDR-compressed checkpoints.

The default preset trains qwen2.5-3b's smoke cut (about 0.16M parameters)
for 200 steps; ``--preset 100m`` selects a resize of it of about 67M
parameters (the reference calls the presets ~10M and ~100M; a few hundred
steps on a real accelerator; pass --steps to trim).  On the card unless
``--device cpu``:

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 2
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.launch import train as T
from repro_torch.runtime.roofline import device_label

# the reference's result keys (the port's train_loop adds per-step lists
# and the final state for its callers' checks)
RESULT_KEYS = ("first_loss", "last_loss", "steps_run", "stragglers")


def main(argv=None) -> dict:
    """Parse ``argv`` (the reference's flags, plus ``--device``), train, and
    return what is printed: the result, the checkpoint report and whether
    every step's loss was finite."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["small", "100m"], default="small")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "hpdr_train_ckpt_torch"))
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None, help="cpu trains on the CPU")
    args = ap.parse_args(argv)
    device = T.resolve_device(args.device)

    if args.preset == "small":
        out = T.train_loop(
            args.arch, steps=args.steps, batch=8, seq=128, smoke=True,
            ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 1),
            sched="wsd", device=device,
        )
    else:
        # about 67M params (the reference's "~100M"): d_model 512, 12 layers,
        # vocab 32k (smoke-based resize)
        cfg = get_config(args.arch).smoke()
        cfg = dataclasses.replace(
            cfg, d_model=512, n_layers=12, n_heads=8, n_kv_heads=8,
            head_dim=64, d_ff=2048, vocab=32000,
        )
        orig = T.get_config
        T.get_config = lambda name: cfg  # inject the resized config
        try:
            out = T.train_loop(
                args.arch, steps=args.steps, batch=8, seq=256, smoke=False,
                ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 1),
                device=device,
            )
        finally:
            T.get_config = orig
    result = {k: out[k] for k in RESULT_KEYS}
    print("\nresult:", result)
    r = out.get("ckpt_report")
    if r:
        print(f"checkpoint: {r['raw_bytes']/1e6:.1f}MB → "
              f"{r['compressed_bytes']/1e6:.1f}MB (ratio {r['ratio']:.2f}x) "
              f"in {r['save_s']:.1f}s on {device_label(device)}")
    n_params = sum(t.numel() for _key, t in api.flatten_with_keys(out["state"]["params"]))
    return {"result": result, "ckpt_report": r, "finite": all(out["finite"]),
            "losses": out["losses"], "step_s": out["step_s"], "n_params": n_params,
            "device": str(device)}


if __name__ == "__main__":
    main()
