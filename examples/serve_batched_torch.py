"""Batched serving on the PyTorch/CUDA port: continuous-batching engine +
KV-cache parking.  On the card unless ``--device cpu``:

    PYTHONPATH=src python examples/serve_batched_torch.py
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import engine as engine_mod
from repro_torch.core import adapters
from repro_torch.models import build_model
from repro_torch.serving.engine import (
    Request,
    ServingEngine,
    compress_kv_cache,
    decompress_kv_cache,
)


def main(device=None, params=None) -> dict:
    """Serve five requests on qwen2.5-3b's smoke cut, park the cache at zfp
    rate 12 and resume from it; on the card unless ``device="cpu"``.
    ``params`` replaces the weights drawn from seed 0 (same tree, on
    ``device``).  Returns what it prints."""
    cpu = device is not None and torch.device(device).type == "cpu"
    device = torch.device("cpu") if cpu else adapters.device_for(adapters.AUTO)
    # parking runs on an engine of the serving device (the default one wants a card)
    eng = engine_mod.ExecutionEngine(devices=[device], backend=adapters.TORCH) if cpu else None
    cfg = get_config("qwen2.5-3b").smoke()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
    engine = ServingEngine(model, params, batch_size=2, max_len=64)

    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                max_new_tokens=8)
        for i in range(5)
    ]
    stats = engine.serve(requests)
    print("serve stats:", stats)
    for r in requests[:3]:
        print(f"  req {r.uid}: prompt={list(r.prompt)} -> {r.out_tokens}")

    # park the session: ZFP-X fixed-rate compression of the KV cache
    comp, cstats = compress_kv_cache(engine.cache, rate=12, engine=eng)
    print(f"\nKV cache parked: {cstats['raw']/1e6:.2f}MB → "
          f"{cstats['compressed']/1e6:.2f}MB ({cstats['ratio']:.1f}x)")
    restored = decompress_kv_cache(comp, engine.cache, engine=eng)
    engine.cache = restored
    print("session resumed from compressed cache.")
    if eng is not None:
        eng.close()
    return {"serve": stats, "tokens": {r.uid: list(r.out_tokens) for r in requests},
            "parked": cstats, "comp": comp, "cache": restored, "device": str(device)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu serves on the CPU")
    main(ap.parse_args().device)
