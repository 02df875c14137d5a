#!/usr/bin/env python3
"""Ablations of the pack_stream kernel on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 scripts/pack_ablation.py

It builds, into ``build/pack_ablation/``, the shipped source
``src/repro_torch/kernels/huffman_encode/csrc/huffman_encode.cu`` and
variants of it made by replacing text here (the sources in the repository
stay as they are):

  * ``threads512``: packing CTAs of 512 threads (tiles of 8,192 symbols)
    with no minimum of CTAs an SM: the compiler then takes ~91 registers a
    thread and an SM holds one CTA, whose loads, scan, packing and stores
    run one after another;
  * ``threads512_min2``: the same at two CTAs an SM (64 registers, spills);
  * ``min3``: the shipped 256 threads at three CTAs an SM (no spills);
  * ``codes_late``: each round's codes loaded after the scan, next to their
    use, instead of with the lengths before it.

Every variant must give the plain version's words and chunk offsets
(``ref.pack_stream``) on two code sets: the Laplace keys of a 513^3 field
(135,005,697 symbols, MGARD's scale) coded by their Huffman codebook, and
2^26 random codes of 0 to 32 bits.  Then each is timed in turns (CUDA
events around 10 calls, 4 turns, alternating the order) and once under
``torch.profiler`` for each of its three kernels' device time.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import huffman  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.huffman_encode import ref as er  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/huffman_encode/csrc/huffman_encode.cu"
OUT = ROOT / "build" / "pack_ablation"
BOUNDS = "__global__ void __launch_bounds__(kPackThreads, 4)\npack_words("
THREADS = ("constexpr int kPackThreads = 256;", "constexpr int kPackThreads = 512;")
LOAD = "    code[r] = load4<uint32_t, uint4>(codes, first + r * kPackRoundSyms, n, vec);\n"
USE = "    const uint32_t c[4] = {code[r].x,"
VARIANTS = {  # name: (text replacements, symbols a tile)
    "shipped": ([], 4096),
    "threads512": ([THREADS, (BOUNDS, BOUNDS.replace(", 4)", ")"))], 8192),
    "threads512_min2": ([THREADS, (BOUNDS, BOUNDS.replace(", 4)", ", 2)"))], 8192),
    "min3": ([(BOUNDS, BOUNDS.replace(", 4)", ", 3)"))], 4096),
    "codes_late": ([(LOAD, ""), (USE, LOAD + USE)], 4096),
}


def build() -> dict:
    """Each variant's ``huffman_pack_stream`` entry point and tile."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, (edits, _tile) in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{report}")
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "pack_words" in line:
                print(f"{name} pack_words: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).huffman_pack_stream
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, i64, i64, i64, i32, p, p, p, p]
        fn.restype = i32
        entries[name] = (fn, VARIANTS[name][1])
    return entries


def pack(entry, codes, lens, num_words: int, chunk: int):
    fn, tile = entry
    n, dev = lens.numel(), lens.device
    words = torch.empty(num_words, dtype=torch.int32, device=dev)
    offsets = torch.empty(-(-n // chunk), dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * -(-n // tile) + 1, dtype=torch.int64, device=dev)
    rc = fn(codes.data_ptr(), lens.data_ptr(), n, num_words, chunk, tile, words.data_ptr(),
            offsets.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return words, offsets


def code_sets(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.rand(135_005_697, generator=g, device=dev) - 0.5
    keys = (2048 - 2.0 * torch.sign(u) * torch.log1p(-2 * u.abs())).round().clamp(0, 4095)
    keys = keys.to(torch.int32)
    del u
    book = huffman.build_codebook(torch.bincount(keys, minlength=4096).cpu().numpy())
    laplace = er.encode_lookup(keys, *huffman.codebook_tables(book, dev))
    n = 1 << 26
    lens = torch.randint(0, 33, (n,), generator=g, device=dev, dtype=torch.int32)
    codes = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    return {"Laplace keys of a 513^3 field": laplace, "2^26 codes of 0-32 bits": (codes, lens)}


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    entries = build()
    chunk = 4096
    for what, (codes, lens) in code_sets(dev).items():
        num_words = -(-int(lens.to(torch.int64).sum()) // 32)
        want = er.pack_stream(codes, lens, num_words, chunk)
        bound = (8 * lens.numel() + 4 * num_words) / 3.35e12 * 1e3
        print(f"-- {what}: {lens.numel()} symbols, {num_words} words, bound {bound:.4f} ms")
        for name, entry in entries.items():
            got = pack(entry, codes, lens, num_words, chunk)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{name} differs from the plain version on {what}")
        times = {name: [] for name in entries}
        for turn in range(4):
            for name in (list(entries) if turn % 2 == 0 else list(entries)[::-1]):
                for _ in range(2):
                    pack(entries[name], codes, lens, num_words, chunk)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    pack(entries[name], codes, lens, num_words, chunk)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        for name, entry in entries.items():
            for _ in range(3):  # a profiling session now and then records no device event
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    pack(entry, codes, lens, num_words, chunk)
                    torch.cuda.synchronize()
                ops = sorted((e for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA
                              and "pack_" in e.name), key=lambda e: e.time_range.start)
                if len(ops) == 3:
                    break
            device = ", ".join(f"{e.name.split('pack_')[1].split('(')[0]} "
                               f"{e.time_range.elapsed_us() / 1e3:.4f}" for e in ops)
            print(f"{name:16s} {statistics.median(times[name]):.4f} ms a call (events; turns "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}); device ms: {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
