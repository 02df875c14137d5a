#!/usr/bin/env python3
"""Ablations of the histogram kernel on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 scripts/histogram_ablation.py

It builds, into ``build/histogram_ablation/``, the shipped source
``src/repro_torch/kernels/histogram/csrc/histogram.cu`` and variants of it
made by replacing text here (the sources in the repository stay as they
are):

  * ``loads``: the shipped loads and loop, each key only compared with a
    value no key holds (the never-taken branch keeps the load): what
    reading the keys alone takes.  Its output is wrong by design and is not
    checked;
  * ``unroll1`` / ``unroll8``: one / eight 16-byte loads in flight per
    thread instead of four;
  * ``threads256`` / ``threads512``: CTAs of 256 / 512 threads instead of
    1024 (as many CTAs an SM as fit);
  * ``window16k`` / ``window28k``: a shared window of 16,384 / 28,672 bins
    (3 / 2 CTAs an SM) instead of 58,112 (one), for alphabets wider than
    the window; keys past it count in global memory;
  * ``global``: no shared window, every key counted with an atomic in
    global memory (L2);
  * ``replicas``: ``scripts/histogram_ablation/replicas.cu``, the first
    design of the redesign, kept for the comparison: R copies of the
    histogram a CTA interleaved across lanes (bin b of copy r is word
    b * R + r; lane l adds into copy l % R; R = 32 for 256 bins, 4 for
    4096), so that lanes hitting one bin hit different words;
  * ``parent``: ``scripts/histogram_ablation/parent.cu``, a copy of the
    kernel the redesign replaced (per-warp sub-histograms, a
    ``__ballot_sync`` and a ``__match_any_sync`` per key, one load in
    flight), kept here so that no git history is needed;
  * ``parent_plain``: the parent with a plain shared ``atomicAdd`` per key
    (no ballot, no match).

Every variant but ``loads`` must equal ``torch.bincount`` on the three key
sets of the main path, which ``chip_smoke.py`` builds the same way: the
bytes of a 4096x4096 N(0, 0.02^2) float32 leaf (2^26 keys, 256 bins), the
discrete-Laplace keys of the ``huffman`` cell (2^26 keys, 4096 bins) and the
MGARD cell's 513^3 keys (135,005,697 keys, 4096 bins); and on one set off
the main path, 2^26 skewed keys over 65,536 bins, the widest alphabet
``leaf_policy`` gives ``huffman``, which counts in global memory.  Each
variant is timed on each set in turns (the variants in order, then in
reverse), in device time from ``torch.profiler`` (median of 10 launches;
the zeroing memset is not included), and printed beside the bound (4 B a
key read once and 4 B a bin written once, at 3.35 TB/s), ``torch.bincount``
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

RUNS = 10
HBM_BYTES_PER_S = 3.35e12
SHIPPED = ROOT / "src/repro_torch/kernels/histogram/csrc/histogram.cu"
PARENT = ROOT / "scripts/histogram_ablation/parent.cu"
REPLICAS = ROOT / "scripts/histogram_ablation/replicas.cu"
KERNEL_NAMES = ("hist_shared", "hist_global")
WIDE_BINS = 1 << 16  # the widest alphabet leaf_policy gives huffman: global memory

COUNT = """  const unsigned k = static_cast<unsigned>(key);
  if (k < b.shared) atomicAdd(b.hist + k, 1);
  else if (k < b.all) atomicAdd(b.out + k, 1);
"""
PARENT_MATCH = """  const unsigned active = __ballot_sync(kFull, ok);
  if (ok) {
    const unsigned peers = __match_any_sync(active, key);
    if (lane == __ffs(peers) - 1) atomicAdd(hist + key, __popc(peers));
  }
"""


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:60]!r}")
    return src.replace(old, new)


def variants() -> dict[str, str]:
    src = SHIPPED.read_text()
    parent = PARENT.read_text()
    unroll = "constexpr int kUnroll = 4;"
    threads = "constexpr int kThreads = 1024;"
    window = "constexpr int kSharedBins = kSharedMax / 4;"
    return {
        "shipped": src,
        "loads": replace_once(src, COUNT, "  if (key == 0x7654321) atomicAdd(b.hist, 1);\n"),
        "unroll1": replace_once(src, unroll, "constexpr int kUnroll = 1;"),
        "unroll8": replace_once(src, unroll, "constexpr int kUnroll = 8;"),
        "threads256": replace_once(src, threads, "constexpr int kThreads = 256;"),
        "threads512": replace_once(src, threads, "constexpr int kThreads = 512;"),
        "window16k": replace_once(src, window, "constexpr int kSharedBins = 16384;"),
        "window28k": replace_once(src, window, "constexpr int kSharedBins = 28672;"),
        "global": replace_once(src, window, "constexpr int kSharedBins = 0;"),
        "replicas": REPLICAS.read_text(),
        "parent": parent,
        "parent_plain": replace_once(parent, PARENT_MATCH, "  if (ok) atomicAdd(hist + key, 1);\n"),
    }


def build(sources: dict[str, str]) -> dict[str, Path]:
    from repro_torch.kernels import _build

    out_dir = _build.build_dir() / "histogram_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        regs = [line.split(":", 1)[1].strip() for line in report.splitlines()
                if "registers" in line]
        print(f"built {name}: ptxas {regs}", flush=True)
        libs[name] = lib
    return libs


def key_sets(device) -> dict[str, tuple["torch.Tensor", int]]:
    """The three key sets of the main path, as chip_smoke.py makes them."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import api, mgard

    g = torch.Generator(device=device).manual_seed(cs.SEED + 2)
    leaf = torch.randn(cs.HUFF_LEAF_SHAPE, generator=g, device=device) * 0.02
    field = cs.main_field(cs.MGARD_EDGE, device)
    c = api.compress(field, "mgard")
    plan = api.get_plan(api.make_spec(field, "mgard"))
    coeffs = mgard.decompose(field, tuple(field.shape), plan.workspace["thomas"]).reshape(-1)
    bins = torch.from_numpy(c.arrays["bins"].astype("float32")).to(device)
    dict_size = int(c.meta["dict_size"])
    mgard_keys = mgard._quantize_stage_impl(coeffs, plan.workspace["lmap"].reshape(-1), bins,
                                            (coeffs.numel(),), dict_size, "cuda")[1]
    return {
        "bytes leaf": (cs.policy_keys(leaf, "huffman-bytes"), 256),
        "Laplace keys": (cs.laplace_keys(cs.HUFF_KEYS_SHAPE, device).reshape(-1), cs.DICT_SIZE),
        "MGARD 513^3 keys": (mgard_keys.reshape(-1).contiguous(), dict_size),
        f"{WIDE_BINS}-key alphabet": (cs.skewed_keys(WIDE_BINS, 1 << 26, device, cs.SEED + 13),
                                      WIDE_BINS),
    }


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("histogram_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.histogram import kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {name: ctypes.CDLL(str(path)) for name, path in build(variants()).items()}
    for lib in libs.values():
        fn = lib.histogram_count
        fn.argtypes = kernel._SIGNATURES["histogram_count"]
        fn.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, keys, out, nb):
        rc = lib.histogram_count(keys.data_ptr(), keys.numel(), out.data_ptr(), nb, stream)
        if rc:
            raise RuntimeError(f"histogram launch failed: CUDA error {rc}")

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a profiling session now and then loses an event
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(RUNS):
                    fn()
                torch.cuda.synchronize()
            times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and any(k in e.name for k in KERNEL_NAMES)]
            if len(times) == RUNS:
                return statistics.median(times)
        raise RuntimeError(f"{len(times)} histogram kernel events, expected {RUNS}")

    def call_device_ms(fn) -> float:
        """Device time of all the kernels one call of ``fn`` launches, summed
        (median over RUNS calls): for the library call, whose kernels are
        not ours."""
        fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(RUNS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            per_call.append(sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA))
        return statistics.median(per_call)

    sets = key_sets(dev)
    order = list(libs)
    for what, (keys, nb) in sets.items():
        info = kernel.launch_info(nb)
        want = torch.bincount(keys, minlength=nb).to(torch.int32)
        outs = {name: torch.empty(nb, dtype=torch.int32, device=dev) for name in libs}
        for name, lib in libs.items():
            run(lib, keys, outs[name], nb)
        torch.cuda.synchronize()
        for name in libs:
            if name != "loads" and not torch.equal(outs[name], want):
                raise RuntimeError(f"{what}: variant {name} differs from torch.bincount")
        times: dict[str, list] = {name: [] for name in libs}
        for name in order + order[::-1]:
            lib, out = libs[name], outs[name]
            times[name].append(device_ms(lambda: run(lib, keys, out, nb)))
        bincount = call_device_ms(lambda: torch.bincount(keys, minlength=nb))
        bound = (4 * keys.numel() + 4 * nb) / HBM_BYTES_PER_S * 1e3
        print(f"[{card}] {what}: {keys.numel()} keys, {nb} bins; shipped launch {info}; "
              f"bound {bound:.4f} ms; torch.bincount {bincount:.4f} ms of device time",
              flush=True)
        for name in order:
            t = times[name]
            print(f"[{card}] {what}, {name}: " + "; ".join(f"{v:.4f}" for v in t)
                  + f" ms of device time (the best {bound / min(t):.1%} of the bound)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
