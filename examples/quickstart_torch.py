"""Quickstart: compress/decompress a scientific field with all three pipelines,
on the PyTorch/CUDA port (``repro_torch``).

Demonstrates the plan-based API: a ``ReductionSpec`` is built per setting,
its ``ReductionPlan`` (bound kernels + workspace) is CMM-cached, and
re-encoding with the same spec is a pure cache hit.  Runs on the card
(``device="cpu"`` runs the plain versions on the CPU):

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 16
"""

import argparse

import numpy as np
import torch

from repro_torch.core import adapters, api
from repro_torch.core.context import GLOBAL_CMM

METHODS = (
    ("mgard", {"error_bound": 1e-2}, "error-bounded lossy (rel 1e-2)"),
    ("mgard", {"error_bound": 1e-4, "dict_size": 65536}, "error-bounded lossy (rel 1e-4)"),
    ("zfp", {"rate": 8}, "fixed-rate 8 bits/value"),
    ("zfp", {"rate": 16}, "fixed-rate 16 bits/value"),
    ("huffman-bytes", {}, "lossless byte-entropy (LZ-class)"),
)


def smooth_field(n: int) -> np.ndarray:
    """The synthetic smooth 3-D field (NYX-density stand-in), from seed 0."""
    g = np.linspace(0, 8 * np.pi, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    rng = np.random.default_rng(0)
    return np.exp(
        np.sin(x) * np.cos(y) * np.sin(z) + 0.05 * rng.normal(size=x.shape)
    ).astype(np.float32)


def main(n: int = 64, device=None) -> dict:
    """Run the five methods on the ``n``^3 field, then a re-encode that hits
    the CMM; on the card unless ``device="cpu"``.  Returns what it prints."""
    backend = adapters.TORCH if device is not None and torch.device(device).type == "cpu" \
        else adapters.AUTO
    device = adapters.device_for(backend)
    data = smooth_field(n)
    x = torch.from_numpy(data).to(device)
    print(f"input: {data.shape} float32, {data.nbytes/1e6:.1f} MB on {device}\n")

    rows = []
    for method, kw, note in METHODS:
        spec = api.make_spec(x, method, backend=backend, **kw)   # hashable CMM key
        comp = api.encode(spec, x)                                # plan built once, cached
        blob = comp.to_bytes()  # portable v2 stream (what the checkpointer writes)
        out = api.decompress(api.Compressed.from_bytes(blob), backend=backend).cpu().numpy()
        err = float(np.abs(out - data).max())
        rel = err / float(data.max() - data.min())
        print(f"{method:14s} {note:32s} ratio={comp.ratio():6.2f}x  "
              f"stream={len(blob)/1e6:6.2f}MB  max_rel_err={rel:.2e}")
        rows.append({"method": method, "params": dict(kw), "note": note,
                     "ratio": comp.ratio(), "stream_bytes": len(blob), "max_rel_err": rel})

    # second encode with an identical spec: a pure plan-cache hit
    hits_before = GLOBAL_CMM.hit_count
    spec = api.make_spec(x, "zfp", rate=16, backend=backend)
    api.encode(spec, x)
    hits = GLOBAL_CMM.hit_count - hits_before
    print(f"\nre-encode with cached plan: +{hits} CMM hit(s)")
    stats = GLOBAL_CMM.stats()
    print("CMM context cache:", stats)
    return {"shape": data.shape, "device": str(device), "methods": rows,
            "reencode_hits": hits, "cmm": stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--device", default=None, help="cpu runs the plain versions")
    args = ap.parse_args()
    main(args.n, args.device)
