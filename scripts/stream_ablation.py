#!/usr/bin/env python3
"""Where the chunk-pipelined stream and the checkpoint writer spend their
time on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 scripts/stream_ablation.py

It builds the kernels (into ``build/``, as ``chip_smoke.py`` does) and
prints, each line beside the card's name and power limit:

  1. the staging of one 32 MiB chunk of the 512^3 field from pageable host
     memory, in parts: the memcpy into a page-locked buffer (at 1, 2, 4 and
     the default number of threads), the DMA to the card, and
     ``PinnedStager.stage`` with its wait (host wall, synchronised, median
     of 20);
  2. the ZFP stream of that field (16 chunks, rate 16) at windows 1, 2 and
     3, in turns ``wait``, ``nowait``, ``nowait``, ``wait`` (host wall,
     synchronised, median of 5), with each run's lane seconds.  ``wait`` is
     the shipped pipeline: the main thread waits on each chunk's staging
     copy before it hands the chunk to the compute lane.  ``nowait`` hands
     on an event whose host wait does nothing, so the main thread goes on
     to the next chunk's memcpy while the DMA runs and only the compute
     lane's stream waits on the copy (its h2d span then covers the memcpy
     alone).  Both must write the same bytes;
  3. ``cProfile`` of one ``CheckpointManager.save`` and one ``restore`` of
     ``chip_smoke.py``'s qwen2.5-3b tree (embedding and 4 layers, 2.48 GB
     on the card), each after a warm-up save and restore: the functions
     with the most time of their own (the profile's overhead included).
"""

from __future__ import annotations

import cProfile
import io
import pstats
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
CHUNK_PLANES = 32
WINDOWS = (1, 2, 3)
PROFILE_LINES = 12


def host_ms(fn, runs: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def staging_parts(cs, pl, host, device, card: str) -> None:
    import torch

    chunk = host[:CHUNK_PLANES]
    nbytes = chunk.numel() * chunk.element_size()
    pinned = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
    dev = torch.empty(chunk.shape, dtype=chunk.dtype, device=device)
    stager = pl.PinnedStager(device, 1)
    threads = torch.get_num_threads()
    parts = {}
    for n in sorted({1, 2, 4, threads}):
        torch.set_num_threads(n)
        parts[f"memcpy to page-locked, {n} threads"] = host_ms(lambda: pinned.copy_(chunk))
    torch.set_num_threads(threads)
    parts["DMA page-locked -> card"] = host_ms(lambda: dev.copy_(pinned, non_blocking=True))
    parts["PinnedStager.stage + wait"] = host_ms(lambda: stager.stage(chunk, 0)[1].synchronize())
    cs.log(f"[{card}] staging of one {nbytes}-byte chunk (host wall, synchronised, median of "
           "20): " + ", ".join(f"{k} {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s)"
                               for k, v in parts.items()))


def stream_turns(cs, api, pl, host, card: str) -> None:
    import torch

    class NoWaitEvent(torch.cuda.Event):
        """An event whose host wait returns at once: streams still wait on it."""

        def synchronize(self) -> None:
            pass

    class NoWaitStager(pl.PinnedStager):
        def stage(self, chunk, slot):
            out, ready = super().stage(chunk, slot)
            if ready is None:
                return out, ready
            lazy = NoWaitEvent()
            lazy.record(self.stream if not chunk.is_cuda
                        else torch.cuda.current_stream(out.device))
            return out, lazy

    shipped = pl.PinnedStager
    chunk = CHUNK_PLANES * host.shape[1] * host.shape[2]
    want = None
    for variant in ("wait", "nowait", "nowait", "wait"):
        pl.PinnedStager = shipped if variant == "wait" else NoWaitStager
        try:
            for w in WINDOWS:
                stream = api.CompressorStream("zfp", rate=16, mode="fixed", c_fixed_elems=chunk,
                                              window=w)
                last = {}
                ms = cs.median_wall_ms(lambda: last.__setitem__("r", stream.compress(host)),
                                       runs=5, warmup=1)
                res = last["r"]
                raw = api.CompressorStream.to_bytes(res)
                want = want or raw
                if raw != want:
                    raise SystemExit(f"{variant} window {w}: the stream's bytes differ")
                cs.log(f"[{card}] zfp stream {tuple(host.shape)}, {len(res.chunks)} chunks, "
                       f"{variant} window {w}: {ms:.4f} ms (host wall, median of 5); last run "
                       "lanes " + ", ".join(f"{k} {v * 1e3:.3f} ms"
                                            for k, v in res.lane_seconds().items())
                       + f", overlap_efficiency {res.overlap_efficiency():.4f}")
        finally:
            pl.PinnedStager = shipped


def checkpoint_profile(cs, api, device, card: str) -> None:
    import torch

    from repro_torch.checkpoint import CheckpointManager

    tree = cs.qwen_tree(device)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(Path(tmp) / "ckpt")
        mgr.save(1, tree)
        mgr.restore(1)
        for what, fn in (("save", lambda: mgr.save(2, tree)), ("restore", lambda: mgr.restore(2))):
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            fn()
            torch.cuda.synchronize()
            prof.disable()
            wall = time.perf_counter() - t0
            out = io.StringIO()
            stats = pstats.Stats(prof, stream=out)
            stats.sort_stats("tottime").print_stats(PROFILE_LINES)
            cs.log(f"[{card}] CheckpointManager.{what} of the qwen2.5-3b tree: {wall:.3f} s "
                   f"under cProfile; the {PROFILE_LINES} functions with the most time of their "
                   "own:")
            lines = out.getvalue().splitlines()
            start = next(i for i, line in enumerate(lines) if line.lstrip().startswith("ncalls"))
            for line in lines[start:]:
                if line.strip():
                    cs.log("    " + line.strip())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(SRC))
    import chip_smoke as cs
    from repro_torch.core import api
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import _build
    from repro_torch.runtime import calibrate

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_line()
    cs.log(card)
    _build.build()
    with tempfile.TemporaryDirectory() as cal:
        calibrate.set_calibration_dir(cal)
        host = cs.main_field(cs.FIELD_EDGE, device).cpu()
        staging_parts(cs, pl, host, device, card)
        stream_turns(cs, api, pl, host, card)
        checkpoint_profile(cs, api, device, card)
        calibrate.set_calibration_dir(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
