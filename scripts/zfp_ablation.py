#!/usr/bin/env python3
"""Ablations of the ZFP field kernels on one CUDA card.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 scripts/zfp_ablation.py

It builds ``src/repro_torch/kernels/zfp_block/csrc/zfp_block.cu`` as it is
and three variants of it, made by replacing text of the source here (the
source in the repository stays as it is):

  * ``store16``: encode writes its payload with 16-byte stores (four words
    of one row a thread) from the word-major stage, instead of 4-byte ones;
  * ``bulk``: encode copies its payload into a row-major shared stage and
    writes it with one ``cp.async.bulk`` shared->global copy a tile;
  * ``copies``: both kernels keep their copies, stages and barriers but
    skip the block chain (encode stores the input bits as payload words,
    decode the payload words as values): what the data movement alone
    takes.  Its output is wrong by design and is not checked.

``store16`` and ``bulk`` must equal the shipped kernel bit for bit.  Each
variant is timed on the 512^3 field and on the (16384, 32, 32) leaf view at
rate 16, in turns (shipped, store16, bulk, copies, then the reverse order),
in device time from ``torch.profiler`` (median of 10 launches), and printed
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RATE = 16
RUNS = 10
SHAPES = {"512^3": (512, 512, 512), "leaf view": (16384, 32, 32)}

STEP7 = """    // 7. coalesced store of the tile's payload rows (contiguous)
    uint32_t* pt = payload + tl.first * wpb;
    const int nw = tl.n * wpb;
    for (int i = k, qq = q0, rr = r0; i < nw; i += T) {
      pt[i] = s_col[rr * ld + qq];
      qq += dq;
      rr += dr;
      if (rr >= wpb) { rr -= wpb; ++qq; }
    }
"""

STORE16 = """    uint32_t* pt = payload + tl.first * wpb;
    const int nw = tl.n * wpb;
    if ((wpb & 3) == 0 && ((tl.first * wpb) & 3) == 0) {
      const int dq4 = 4 * T / wpb, dr4 = 4 * T % wpb;
      for (int i = 4 * k, qq = 4 * k / wpb, rr = 4 * k % wpb; i < nw; i += 4 * T) {
        uint4 w4;
        w4.x = s_col[rr * ld + qq];
        w4.y = s_col[(rr + 1) * ld + qq];
        w4.z = s_col[(rr + 2) * ld + qq];
        w4.w = s_col[(rr + 3) * ld + qq];
        *reinterpret_cast<uint4*>(pt + i) = w4;
        qq += dq4;
        rr += dr4;
        if (rr >= wpb) { rr -= wpb; ++qq; }
      }
    } else {
      for (int i = k, qq = q0, rr = r0; i < nw; i += T) {
        pt[i] = s_col[rr * ld + qq];
        qq += dq;
        rr += dr;
        if (rr >= wpb) { rr -= wpb; ++qq; }
      }
    }
"""

BULK = """    uint32_t* pt = payload + tl.first * wpb;
    const int nw = tl.n * wpb;
    uint32_t* s_raw = reinterpret_cast<uint32_t*>(smem + L.raw);
    const bool whole = ((tl.first * wpb) & 3) == 0 && (nw & 3) == 0;
    for (int i = k, qq = q0, rr = r0; i < nw; i += T) {
      if (whole) {
        s_raw[i] = s_col[rr * ld + qq];
      } else {
        pt[i] = s_col[rr * ld + qq];
      }
      qq += dq;
      rr += dr;
      if (rr >= wpb) { rr -= wpb; ++qq; }
    }
    if (whole) {
      fence_proxy_async();
      __syncthreads();
      if (k == 0) {
        bulk_store(pt, s_raw, 4u * nw);
        bulk_commit();
      }
    }
"""

ENC_CHAIN_START = "    if (live) {\n      // 2. block exponent"
ENC_CHAIN_END = "    __syncthreads();\n\n    // 7."
ENC_COPIES = """    if (live) {
      emax_out[tl.first + k] = static_cast<int>(v[0]);
#pragma unroll
      for (int w = 0; w < 32; ++w) {
        if (w < wpb) s_col[w * ld + k] = v[w % BS];
      }
    }
"""
DEC_CHAIN_START = "      // 2. bitplanes back to negabinary coefficients"
DEC_CHAIN_END = "      lift_block<D, true>(q);\n"
DEC_COPIES = """#pragma unroll
      for (int i = 0; i < BS; ++i) q[i] = static_cast<int>(s_col[(i % wpb) * ld + k]);
"""


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old[:60]!r}")
    return src.replace(old, new)


def replace_span(src: str, start: str, end: str, new: str, keep_end: bool) -> str:
    i = src.index(start)
    j = src.index(end, i) + (0 if keep_end else len(end))
    return src[:i] + new + src[j:]


def variants(src: str) -> dict[str, str]:
    bulk = replace_once(src, STEP7, BULK)
    bulk = replace_once(bulk, "struct EncLayout {\n  uint32_t stage, col, total;",
                        "struct EncLayout {\n  uint32_t stage, col, raw, total;")
    bulk = replace_once(
        bulk,
        "  l.total = l.col + round_up((T + 1) * wpb * 4, 128);\n  return l;\n}\n\nstruct DecLayout",
        "  l.raw = l.col + round_up((T + 1) * wpb * 4, 128);\n"
        "  l.total = l.raw + round_up(T * wpb * 4, 128);\n  return l;\n}\n\nstruct DecLayout")
    # the payload stage is free again once the last tile's bulk store read it
    bulk = replace_once(bulk, "    __syncthreads();\n\n    uint32_t* pt",
                        "    if (k == 0) bulk_wait_read_all();\n    __syncthreads();\n\n"
                        "    uint32_t* pt")
    bulk = replace_once(bulk, "      if (k == 0) {\n        bulk_store(pt, s_raw, 4u * nw);\n"
                              "        bulk_commit();\n      }\n    }\n  }\n}\n",
                        "      if (k == 0) {\n        bulk_store(pt, s_raw, 4u * nw);\n"
                        "        bulk_commit();\n      }\n    }\n  }\n"
                        "  if (k == 0) bulk_wait_all();\n}\n")
    copies = replace_span(src, ENC_CHAIN_START, ENC_CHAIN_END, ENC_COPIES, keep_end=True)
    copies = replace_span(copies, DEC_CHAIN_START, DEC_CHAIN_END, DEC_COPIES, keep_end=False)
    return {"shipped": src, "store16": replace_once(src, STEP7, STORE16), "bulk": bulk,
            "copies": copies}


def build(sources: dict[str, str]) -> dict[str, Path]:
    from repro_torch.kernels import _build

    out_dir = _build.build_dir() / "zfp_ablation"
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("zfp_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import zfp as core_zfp
    from repro_torch.kernels.zfp_block import kernel, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (ROOT / "src/repro_torch/kernels/zfp_block/csrc/zfp_block.cu").read_text()
    libs = {name: ctypes.CDLL(str(path)) for name, path in build(variants(src)).items()}
    for lib in libs.values():
        for fn, argtypes in kernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    tables = ref.default_tables(3, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wpb = core_zfp.words_per_block(64, RATE)

    def encode(lib, x, payload, emax):
        rc = lib.zfp_field_compress(x.data_ptr(), payload.data_ptr(), emax.data_ptr(),
                                    tables["enc_scale"].data_ptr(), *x.shape, 0, 3, RATE, 0,
                                    stream)
        if rc:
            raise RuntimeError(f"encode launch failed: CUDA error {rc}")

    def decode(lib, payload, emax, out):
        rc = lib.zfp_field_decompress(payload.data_ptr(), emax.data_ptr(), out.data_ptr(),
                                      tables["dec_scale"].data_ptr(), *out.shape, 0, 3, RATE,
                                      stream)
        if rc:
            raise RuntimeError(f"decode launch failed: CUDA error {rc}")

    def device_ms(fn, name: str) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(RUNS):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(times) != RUNS:
            raise RuntimeError(f"{len(times)} {name} events, expected {RUNS}")
        return statistics.median(times)

    g = torch.Generator(device=dev).manual_seed(0)
    order = ["shipped", "store16", "bulk", "copies"]
    for view, shape in SHAPES.items():
        x = torch.randn(shape, generator=g, device=dev)
        n = x.numel() // 64
        moved = 4 * (x.numel() + n * wpb + n)
        bound = moved / 3.35e12 * 1e3
        bufs = {name: (torch.empty((n, wpb), dtype=torch.int32, device=dev),
                       torch.empty(n, dtype=torch.int32, device=dev),
                       torch.empty(shape, dtype=torch.float32, device=dev)) for name in libs}
        for name, lib in libs.items():
            p, e, out = bufs[name]
            encode(lib, x, p, e)
            decode(lib, p, e, out)
        torch.cuda.synchronize()
        want_p, want_e = bufs["shipped"][0], bufs["shipped"][1]
        for name in ("store16", "bulk"):
            p, e, out = bufs[name]
            if not (torch.equal(p, want_p) and torch.equal(e, want_e)
                    and torch.equal(out.view(torch.int32), bufs["shipped"][2].view(torch.int32))):
                raise RuntimeError(f"{view}: variant {name} differs from the shipped kernel")
        times: dict[str, list] = {name: [] for name in libs}
        for name in order + order[::-1]:
            lib = libs[name]
            p, e, out = bufs[name]
            times[name].append((device_ms(lambda: encode(lib, x, p, e), "zfp_encode_kernel"),
                                device_ms(lambda: decode(lib, p, e, out), "zfp_decode_kernel")))
        for name in order:
            enc = "; ".join(f"{t[0]:.4f}" for t in times[name])
            dec = "; ".join(f"{t[1]:.4f}" for t in times[name])
            print(f"[{card}] zfp {view} {shape} rate {RATE}, {name}: encode {enc} ms, "
                  f"decode {dec} ms of device time (bound {bound:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
