"""The paper's scenario as a framework feature, on the PyTorch/CUDA port:
reduction-accelerated I/O.

Writes a model checkpoint through all three HPDR pipelines, measures ratio
and throughput on the device it runs on (the card unless ``--device cpu``),
and projects the multi-node I/O acceleration with the paper's
filesystem model (Figs. 15/17/18).  The projection's constants are the
paper's Frontier figures, not this card's.

    PYTHONPATH=src python examples/compressed_checkpoint_io_torch.py
"""

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.configs import get_config
from repro_torch.core import adapters, api
from repro_torch.core import engine as engine_mod
from repro_torch.models import build_model
from repro_torch.runtime.roofline import device_label

POLICIES = (
    ("lossless (huffman-bytes)", CheckpointPolicy(exact=True)),
    ("zfp rate-28 (~1e-6 rel)", CheckpointPolicy(float_method="zfp", zfp_rate=28, lossless_small=1)),
    ("zfp rate-16 (transport)", CheckpointPolicy(float_method="zfp", zfp_rate=16, lossless_small=1)),
    ("mgard eb 1e-4", CheckpointPolicy(float_method="mgard", mgard_eb=1e-4, lossless_small=1)),
)

# the paper's Frontier setting: 1024 nodes x 4 GPUs, 7.5 GB a GPU, Lustre at
# 9.4 TB/s, 11.8 GB/s of reduction throughput a GPU at 96% efficiency
NODES_GPUS = 4096
BYTES_PER_GPU = 7.5e9
FS_BPS = 9.4e12
REDUCE_BPS = 11.8e9
EFFICIENCY = 0.96


def leaves(tree) -> list[torch.Tensor]:
    return [x for _key, x in api.flatten_with_keys(tree)]


def projection() -> list[dict]:
    """The paper's weak-scaling write projection (Frontier's constants)."""
    rows = []
    for ratio in ("4.0x (mgard 1e-2)", "2.6x (zfp r12)"):
        r = float(ratio.split("x")[0])
        raw = BYTES_PER_GPU * NODES_GPUS
        t_raw = raw / FS_BPS
        t_comp = raw / r / FS_BPS + raw / (NODES_GPUS * REDUCE_BPS * EFFICIENCY)
        rows.append({"ratio": ratio, "write_accel": t_raw / t_comp})
    return rows


def main(device=None, params=None) -> dict:
    """Save and restore qwen1.5-4b's smoke cut under four policies, then
    print the projection; on the card unless ``device="cpu"``.  ``params``
    replaces the weights drawn from seed 0.  Returns what it prints."""
    cpu = device is not None and torch.device(device).type == "cpu"
    device = torch.device("cpu") if cpu else adapters.device_for(adapters.AUTO)
    eng = engine_mod.ExecutionEngine(devices=[device], backend=adapters.TORCH) if cpu else None
    label = device_label(device)
    cfg = get_config("qwen1.5-4b").smoke()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
    nbytes = sum(x.numel() * x.element_size() for x in leaves(params))
    print(f"model: {nbytes/1e6:.1f} MB of parameters\n")

    rows = []
    for name, policy in POLICIES:
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, policy, engine=eng)
            t0 = time.perf_counter()
            rep = mgr.save(0, {"params": params})
            dt = time.perf_counter() - t0
            restored, _ = mgr.restore(0, target={"params": params})
            mgr.close()
            err = max(
                float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
                for a, b in zip(leaves(restored), leaves({"params": params}))
            )
            print(f"{name:28s} ratio={rep['ratio']:5.2f}x  "
                  f"{nbytes/dt/1e6:6.1f} MB/s ({label})  max_abs_err={err:.2e}")
            rows.append({"policy": name, "ratio": rep["ratio"], "save_s": dt,
                         "mb_per_s": nbytes / dt / 1e6, "max_abs_err": err,
                         "manifest": rep})

    # multi-node projection (paper's weak-scaling I/O model)
    proj = projection()
    print("\nI/O projection @ Frontier (1024 nodes × 4 GPUs, Lustre 9.4 TB/s; "
          "the paper's figures, not measured here):")
    for p in proj:
        print(f"  ratio {p['ratio']:18s} write accel = {p['write_accel']:.1f}x")
    if eng is not None:
        eng.close()
    return {"nbytes": nbytes, "device": label, "policies": rows, "projection": proj}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu writes from the CPU")
    main(ap.parse_args().device)
