#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HPDR on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

It builds the kernels from the sources in the checkout (into ``build/``),
then runs five phases and exits non-zero if any fails:

  1. the card's name and power limit (``nvidia-smi``);
  2. every kernel against its plain PyTorch version on the card: dims 1-4,
     rates {1, 7, 16, 32}, odd shapes, special blocks (all zero, subnormal,
     absmax below 2^-98, near FLT_MAX, inf, NaN) — payload and emax
     byte-identical, decoded values bit-identical (tolerance 0);
  3. the main path at a real size: ``api.compress``/``decompress`` of a
     512^3 float32 field (the size of SDRBench's Nyx fields, 512 MiB) at
     rate 16 and ``compress_leaf``/``decompress_leaf`` of a 4096x4096
     float32 tensor, on the ``cuda`` backend.  Checks the ratio, the round
     trip error (max |error| <= 5e-3 of the value range; about 8e-4 is
     typical at rate 16), the kernels' results against the plain versions
     (run in chunks of 2^16 blocks; tolerance 0), and that the launch
     counters, zeroed just before, are above 0;
  4. the container bytes round trip on the card: ``to_bytes`` ->
     ``from_bytes`` -> decode, bit-identical;
  5. timings with CUDA events after warm-up, median of 10 runs: kernel ms,
     the plain versions' ms, the torch pad/block-view ms, end-to-end ms,
     GB/s, and the least time the card could take (bytes at 3.35 TB/s,
     operations at 67 T/s), each printed with the card's name and power
     limit.

The last two lines are one JSON object per kernel (``{"kernels": [...]}``)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
FIELD_EDGE = 512
LEAF_SHAPE = (4096, 4096)
RATE = 16
ERR_TOL = 5e-3          # max |error| / value range on the main path at rate 16
TIMED_RUNS = 10
PLAIN_CHUNK = 1 << 16   # blocks per plain-version call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
OPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores

CHECK_SHAPES = [(1001,), (33, 47), (33, 47, 65), (5, 6, 7, 9)]
CHECK_RATES = (1, 7, 16, 32)

KERNELS = {
    "compress_blocks": "src/repro/kernels/zfp_block/kernel.py:78",
    "decompress_blocks": "src/repro/kernels/zfp_block/kernel.py:114",
}
KERNEL_SOURCE = "src/repro_torch/kernels/zfp_block/csrc/zfp_block.cu"


class PhaseError(RuntimeError):
    """A phase found the port wrong."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b.to(a.device)))


def max_abs_err(a, b) -> float:
    """Largest |a - b| (0.0 where the bit patterns agree, inf if only one
    side is NaN or the shapes differ)."""
    import torch

    if a.shape != b.shape:
        return math.inf
    b = b.to(a.device)
    if same_bits(a, b):
        return 0.0
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    both_nan = torch.isnan(a64) & torch.isnan(b64)
    diff = torch.where(both_nan, torch.zeros_like(a64), (a64 - b64).abs())
    return float(diff.nan_to_num(math.inf).max())


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def median_wall_ms(fn, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    """Median host wall time of ``fn`` in ms, each run ending synchronised."""
    import torch

    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# inputs, made on the device from the seed
# ---------------------------------------------------------------------------


def special_blocks(dims: int, device) -> "torch.Tensor":
    """Eight 4^d blocks: zero, subnormal, < 2^-98, ~FLT_MAX, inf, NaN,
    normal mixed with subnormal, -inf."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + dims)
    bs = 4 ** dims
    tiny = torch.finfo(torch.float32).tiny
    x = torch.randn((8, bs), generator=g, device=device)
    x[0] = 0.0
    x[1] = (torch.rand(bs, generator=g, device=device) * 2 - 1) * tiny * 0.5
    x[2] *= 2.0 ** -100
    x[3] = (torch.rand(bs, generator=g, device=device) * 2 - 1) * 3.4e38
    x[4, 0] = math.inf
    x[5, 1] = math.nan
    x[6, ::2] = tiny * 0.25
    x[7] = -math.inf
    return x


def odd_field(shape: tuple, device) -> "torch.Tensor":
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + len(shape))
    scales = torch.exp2(torch.randint(-30, 30, shape, generator=g, device=device).float())
    return torch.randn(shape, generator=g, device=device) * scales


def main_field(edge: int, device) -> "torch.Tensor":
    """A smooth 3-D field plus 1% noise: sin(x)·cos(y)·sin(z) on [0, 4π]^3."""
    import torch

    ax = torch.linspace(0, 4 * math.pi, edge, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    f = torch.sin(ax)[:, None, None] * torch.cos(ax)[None, :, None] * torch.sin(ax)[None, None, :]
    return f + 0.01 * torch.randn((edge,) * 3, generator=g, device=device)


def blocks_of(x, dims: int):
    from repro_torch.core.abstractions import pad_to_blocks
    from repro_torch.core.machine import block_view

    blocks, _ = block_view(pad_to_blocks(x, (4,) * dims), (4,) * dims)
    return blocks.reshape(blocks.shape[0], -1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(device) -> None:
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from repro_torch.kernels.zfp_block import kernel, ref

    checked = 0
    for shape in CHECK_SHAPES:
        dims = len(shape)
        blocks = torch.cat([blocks_of(odd_field(shape, device), dims),
                            special_blocks(dims, device)])
        for rate in CHECK_RATES:
            p, e = kernel.compress_blocks(blocks, rate, dims)
            d = kernel.decompress_blocks(p, e, rate, dims)
            torch.cuda.synchronize()
            rp, re_ = ref.compress_blocks(blocks, rate, dims)
            rd = ref.decompress_blocks(rp, re_, rate, dims)
            cp, ce = ref.compress_blocks(blocks.cpu(), rate, dims)
            for what, got, want in (
                ("payload", p, rp), ("emax", e, re_), ("decoded", d, rd),
                ("payload vs CPU plain", p, cp), ("emax vs CPU plain", e, ce),
            ):
                if not same_bits(got, want):
                    raise PhaseError(
                        f"zfp_block {what} differs from the plain version: "
                        f"shape {shape}, rate {rate}, max |err| {max_abs_err(got, want)}"
                    )
            checked += 1
    log(f"phase 2 ok: kernels == plain versions on the card for {checked} "
        f"(shape, rate) cases, special blocks included (tolerance 0)")


def plain_compress(blocks, dims: int, tables: dict):
    from repro_torch.kernels.zfp_block import ref

    return ref.compress_blocks(blocks, RATE, dims, perm=tables["perm"],
                               scale=tables["enc_scale"], chunk=PLAIN_CHUNK)


def plain_decompress(payload, emax, dims: int, tables: dict):
    from repro_torch.kernels.zfp_block import ref

    return ref.decompress_blocks(payload, emax, RATE, dims, perm=tables["perm"],
                                 scale=tables["dec_scale"], chunk=PLAIN_CHUNK)


def check_container(name: str, c, x, out, dims: int, tables: dict) -> dict:
    """Ratio, error, and the kernels' sections/output against the plain versions."""
    import torch

    from repro_torch.core.machine import unblock_view

    bs = 4 ** dims
    expect_ratio = bs * 4 / ((RATE * bs // 32) * 4 + 4)
    if abs(c.ratio() - expect_ratio) > 1e-9:
        raise PhaseError(f"{name}: ratio {c.ratio()} != {expect_ratio}")
    if tuple(out.shape) != tuple(x.shape) or out.dtype != torch.float32:
        raise PhaseError(f"{name}: decoded {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        raise PhaseError(f"{name}: decoded values are not all finite")
    vrange = float(x.max() - x.min())
    err = float((out - x).abs().max()) / vrange
    if err > ERR_TOL:
        raise PhaseError(f"{name}: max |error| {err:.3e} of the range > {ERR_TOL}")
    blocks = blocks_of(x, dims)
    payload = torch.from_numpy(c.arrays["payload"].view("int32")).to(x.device)
    emax = torch.from_numpy(c.arrays["emax"]).to(x.device)
    rp, re_ = plain_compress(blocks, dims, tables)
    rd = plain_decompress(rp, re_, dims, tables)
    counts = tuple(n // 4 for n in x.shape)
    rd_full = unblock_view(rd.reshape((-1,) + (4,) * dims), counts, (4,) * dims)
    errs = {"payload": max_abs_err(payload, rp), "emax": max_abs_err(emax, re_),
            "decoded": max_abs_err(out, rd_full)}
    if any(v != 0.0 for v in errs.values()):
        raise PhaseError(f"{name}: kernel results differ from the plain versions {errs}")
    log(f"phase 3 ok: {name}: ratio {c.ratio():.6f}, max |error| {err:.3e} of the "
        f"range (<= {ERR_TOL}), payload/emax/decoded == plain versions (tolerance 0)")
    return {"compress_blocks": max(errs["payload"], errs["emax"]),
            "decompress_blocks": errs["decoded"], "blocks": blocks,
            "payload": payload, "emax": emax}


def phase_main_path(device, api, kernel):
    """Phase 3: the main path at full size, with the launch counters."""
    import torch

    field = main_field(FIELD_EDGE, device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    leaf = torch.randn(LEAF_SHAPE, generator=g, device=device)
    torch.cuda.synchronize()

    kernel.reset_launches()
    c = api.compress(field, "zfp", rate=RATE)
    out = api.decompress(c)
    cl = api.compress_leaf(leaf, "zfp", rate=RATE)
    leaf_out = api.decompress_leaf(cl)
    torch.cuda.synchronize()
    launches = dict(kernel.launches)
    log(f"phase 3 launches on the main path: {launches}")
    if any(n <= 0 for n in launches.values()):
        raise PhaseError(f"a kernel of the main path never launched: {launches}")
    if out.device != device or leaf_out.device != device:
        raise PhaseError("decode did not return a tensor on the card")

    tables = api.get_plan(api.make_spec(field, "zfp", rate=RATE)).workspace
    main = check_container(f"zfp {FIELD_EDGE}^3 field", c, field, out, 3, tables)
    leaf_blocked = api.as_blocked_3d(leaf)
    check_container(f"compress_leaf {LEAF_SHAPE}", cl, leaf_blocked,
                    leaf_out.reshape(leaf_blocked.shape), 3, tables)
    return field, c, out, main, launches, tables


def phase_bytes_round_trip(api, c, out) -> None:
    from repro_torch.core.container import Compressed

    raw = c.to_bytes()
    again = api.decode(Compressed.from_bytes(raw))
    if not same_bits(again, out):
        raise PhaseError("decode of to_bytes/from_bytes differs from the direct decode")
    log(f"phase 4 ok: {len(raw)} container bytes -> from_bytes -> decode on the "
        "card is bit-identical")


def phase_timings(api, kernel, field, c, main, tables, card: str) -> list[dict]:
    """Phase 5: device times at the main path's shapes."""
    import torch

    from repro_torch.core.abstractions import pad_to_blocks
    from repro_torch.core.machine import block_view, unblock_view

    dims = 3
    blocks, payload, emax = main["blocks"], main["payload"], main["emax"]
    perm, enc, dec = tables["perm"], tables["enc_scale"], tables["dec_scale"]
    n_values = blocks.numel()
    counts = tuple(n // 4 for n in field.shape)

    ms = {
        "compress_blocks": median_ms(
            lambda: kernel.compress_blocks(blocks, RATE, dims, perm=perm, scale=enc)),
        "decompress_blocks": median_ms(
            lambda: kernel.decompress_blocks(payload, emax, RATE, dims, perm=perm, scale=dec)),
    }
    plain_ms = {
        "compress_blocks": median_ms(lambda: plain_compress(blocks, dims, tables)),
        "decompress_blocks": median_ms(lambda: plain_decompress(payload, emax, dims, tables)),
    }
    view_ms = median_ms(lambda: block_view(pad_to_blocks(field, (4,) * dims), (4,) * dims))
    decoded = kernel.decompress_blocks(payload, emax, RATE, dims, perm=perm, scale=dec)
    unview_ms = median_ms(lambda: unblock_view(
        decoded.reshape((-1,) + (4,) * dims), counts, (4,) * dims).contiguous())
    e2e_compress = median_wall_ms(lambda: api.compress(field, "zfp", rate=RATE))
    e2e_decompress = median_wall_ms(lambda: api.decompress(c))

    moved = 4 * (blocks.numel() + payload.numel() + emax.numel())
    ops = n_values * (4 * dims + 7 + 2 * RATE)
    bound_bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    log(f"phase 5 [{card}] zfp {FIELD_EDGE}^3 rate {RATE}: {n_values} values, "
        f"{moved} bytes moved per direction, {ops} integer operations per direction")
    for name in KERNELS:
        log(f"phase 5 [{card}] {name}: kernel {ms[name]:.4f} ms "
            f"({moved / ms[name] / 1e6:.1f} GB/s), plain version {plain_ms[name]:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; bytes {bound_bytes_ms:.4f} ms, "
            f"operations {bound_ops_ms:.4f} ms), {bound_ms / ms[name]:.1%} of the bound")
    log(f"phase 5 [{card}] torch pad+block_view {view_ms:.4f} ms, "
        f"unblock_view {unview_ms:.4f} ms")
    spec = api.make_spec(field, "zfp", rate=RATE)
    _, enc_stages, enc_moved = api.encode_profiled(spec, field)
    _, dec_stages, dec_moved = api.decode_profiled(c)
    log(f"phase 5 [{card}] one profiled call: encode stages {enc_stages} s, "
        f"transfers {enc_moved.as_dict()}; decode stages {dec_stages} s, "
        f"transfers {dec_moved.as_dict()}")
    log(f"phase 5 [{card}] end to end (host wall, synchronised): api.compress "
        f"{e2e_compress:.4f} ms ({4 * n_values / e2e_compress / 1e6:.1f} GB/s of input), "
        f"api.decompress {e2e_decompress:.4f} ms "
        f"({4 * n_values / e2e_decompress / 1e6:.1f} GB/s of output)")
    return [
        {"name": f"zfp_block.{name}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNELS[name], "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        for name in KERNELS
    ]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's kernels "
              "need a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.zfp_block import kernel

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    log(card)  # phase 1
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".so.log").read_text().splitlines():
            if "registers" in line:
                log(f"  {line.strip()}")

    phase_kernels_vs_plain(device)
    field, c, out, main_res, launches, tables = phase_main_path(device, api, kernel)
    phase_bytes_round_trip(api, c, out)
    kernels = phase_timings(api, kernel, field, c, main_res, tables, card)
    for k in kernels:
        short = k["name"].split(".", 1)[1]
        k["launches"] = launches[short]
        k["max_abs_err"] = main_res[short]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
