#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HPDR on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

It builds the kernels from the sources in the checkout (into ``build/``, one
nvcc per source, all at once), then runs five phases and exits non-zero if
any fails:

  1. the card's name and power limit (``nvidia-smi``);
  2. every kernel against its plain PyTorch version on the card, tolerance
     0.  ZFP, block form: dims 1-4, rates {1, 7, 16, 32}, odd shapes,
     special blocks (all zero, subnormal, absmax below 2^-98, near FLT_MAX,
     inf, NaN); field form (``compress_field``/``decompress_field`` against
     block_view + the plain block versions): the odd shapes padded, per d a
     field with one block along the last axis, one whose last-axis block
     count is no multiple of the kernel's tile, a single block, the special
     blocks along the last axis and as the block form's field, and the main
     path's 512^3 field and (16384, 32, 32) leaf view.
     Huffman: alphabets of 1, 2, 256, 4096 and 65536 keys, a near-uniform
     300-key alphabet whose codes all fit decode_chunks' 13-bit lookup
     table, and a Fibonacci-frequency alphabet whose codes reach 32 bits
     (and escape the table), key counts that are no multiple of a block
     (1, 1001, 100003), an empty stream, chunk sizes 256, 4096 and 1001 (no
     multiple of 4 or of the kernel's 32-symbol stage) (the whole decoded
     ``(chunks, chunk_size)`` output, padding included); the histogram
     also under contention (one value throughout, two alternating values,
     sorted runs, the bytes of N(0, 0.02^2) floats), at its shared window
     of 58,112 bins, one past it and with every key past it, each from all
     four alignments of the first key.  MGARD: quantize and dequantize at ±0,
     ±inf, NaN, ±2^31 and just inside, exact ties, subnormal values and a
     subnormal bin, and random values of ragged lengths (aligned and not);
     lerp_coefficients at odd row lengths 3 to 4097 and ragged batches;
     solve_mass at n in {2, ..., 4097, 60001} (60001: too long for a tile
     of one system in shared memory) and h in {2, 4, 512}, and solve_columns
     on (P, n, Q) views with Q = 1, 7 and >= 32 and batches of 1, 31, 33 and
     1001;
  3. the main paths at a real size, on the ``cuda`` backend, each driven
     with every launch counter set to 0 just before and read just after:
     ZFP — ``api.compress``/``decompress`` of a 512^3 float32 field (the
     size of SDRBench's Nyx fields, 512 MiB) at rate 16 and
     ``compress_leaf``/``decompress_leaf`` of a 4096x4096 float32 tensor;
     checks the ratio, the round trip error (max |error| <= 5e-3 of the
     value range; about 8e-4 is typical at rate 16), the kernels'
     results against the plain versions (tolerance 0), both containers
     against the ``torch`` backend's bytes, and that the ``cuda`` path
     called no ``block_view`` / ``unblock_view``.  Huffman —
     ``compress_leaf``/``decompress_leaf`` of a 4096x4096 float32 weight
     tensor with ``huffman-bytes`` (an exact checkpoint leaf: 2^26 byte
     keys) and of a (512, 512, 256) int32 key array with ``huffman``
     (2^26 discrete-Laplace keys around 2048 in MGARD's 4096-key
     alphabet); checks the exact round trip, the container bytes against
     those the ``torch`` backend (the plain versions, on the CPU) writes,
     and each kernel against its plain version at these shapes.  MGARD —
     ``api.compress``/``decompress`` of the 512^3 field with the codec's
     defaults (relative bound 1e-2, 4096 keys; padded to 513^3) and the
     ``lerp_coefficients`` stencil through its own entry point (no codec
     calls it) on the grid's rows; checks the launch counts (one quantize,
     dequantize, histogram, lookup and decode, 27 solves a direction), max
     |error| <= the effective bound, each kernel against its plain version
     at these shapes (the entropy kernels on this run's 513^3 keys and
     container, the plain decode included; solve_mass on the three axis
     views of every level), the ``cuda`` and ``torch`` backends' containers of a
     129^3 field byte for byte, and ``compress_leaf`` of a 4096x4096 weight
     leaf within its bound.  Dtypes — a 256^3 float16 field through
     ``zfp`` (bytes and decode against the ``torch`` backend's) and uint16
     and bfloat16 fields through ``mgard`` (within the bound), each call
     counted.  Progressive — the MGARD field through
     ``api.compress(field, "mgard-progressive")`` (3 tiers, ratio 8),
     ``progressive.refactor`` at the same bound, ``ProgressiveStream.write``
     to a segment file, ``ProgressiveReader.retrieve(tiers=1)`` then
     ``refine`` to tiers 2 and 3, and ``api.decompress``, each call counted
     (exactly the kernels the call should launch, and how often); every
     tier within its bound, ``refine`` bit-identical to a direct retrieve,
     the reader's file reads equal to the trailer and directory plus
     ``nbytes_upto(k)``, the kernels against their plain versions on tier
     0's inputs, and the ``cuda`` and ``torch`` backends' containers of a
     129^3 field byte for byte.  Pytree — ``compress_pytree`` /
     ``decompress_pytree`` of qwen2.5-3b's embedding and first 4 layers
     (about 620M float32 parameters, N(0, 0.02^2)) under
     ``default_select``: ZFP buckets stacked into one launch each, every
     container and decoded leaf against ``compress_leaf`` /
     ``decompress_leaf`` on the card, the stacked kernels against their
     plain versions on one bucket, layer 0 against the ``torch`` backend's
     bytes; then a select sending the norms to ``huffman-bytes`` and the
     ``wo`` matrices to ``mgard-progressive`` (the per-leaf futures path),
     each call counted.  Stream — the 512^3 field from pageable host
     memory through ``CompressorStream("zfp", rate=16, mode="fixed",
     c_fixed_elems=8 << 20)`` (16 chunks of 32 planes, staged through
     page-locked slot buffers and a copy stream) at windows 1, 2 and 3:
     ``to_bytes`` identical, every chunk equal to the one-shot
     ``api.compress`` of its rows, chunk 0 to the ``torch`` backend's bytes,
     the decode to the chunk-wise ``api.decompress``, at most ``window``
     chunks in flight, exactly 16 ``compress_blocks`` a run and no other
     kernel; 128 chunks at windows 1 and 3 with the same bytes (a chunk
     computed before its staging copy completed would differ);
     ``to_file``/``from_file`` reading chunk 0 with one segment pread; the
     4096x4096 weight leaf through ``huffman-bytes`` (4 chunks) and the
     513^3 MGARD field (nine (57, 513, 513) chunks, within each chunk's
     bound) at window 2, each launch counted; and ``chunk_size="auto",
     window="auto"`` from a cold calibration in a temporary directory, whose
     plan must be ``calibrated`` and whose second run must run no sweep.
     Checkpoint — ``CheckpointManager.save`` of the pytree's qwen2.5-3b
     tree with the default policy (zfp rate 28; 21 leaves streamed, 8
     one-shot zfp, 20 ``huffman-bytes``: the routing checked), ``restore``
     flat and with ``target`` (exact leaves bit-identical, zfp leaves equal
     to the one-shot decode of the same chunks), ``save_async`` + ``wait``,
     ``restore(leaves=[...])`` reading only those segments, and a
     ``mgard-progressive`` policy on the four ``wo`` leaves whose
     ``restore(max_error=<tier-2 bound>)`` reads fewer bytes than the full
     restore; each call's launches exact.  Serving — qwen2.5-3b
     (hf:Qwen/Qwen2.5-3B) at full width and depth, 36 layers, about 3.09B
     float32 parameters made on the card from the seed (the reference's
     init scheme), through ``ServingEngine(batch_size=4, max_len=8192)``
     with a float32 cache and bfloat16 compute: 8 requests of 32 prompt
     tokens and 16 new tokens (the refill path), twice on two engines (the
     same tokens, every token in the vocabulary, no kernel launched), and
     one decode step on the card against the CPU path on a depth-2 cut
     (float32 within 1e-4 and bfloat16 within 2^-5 of 1 + max |logit|);
     then ``ReductionService`` on the card: ``park_kv`` of the served cache
     (k, v (36, 4, 8192, 2, 128), 2.4 GB; containers == ``compress_kv_cache``'s)
     and of 4 long-context sessions of 2 tenants (k, v (36, 1, 8192, 2, 128)
     N(0, 1) from the seed, 0.6 GB each) under the default 256 MiB budget
     (>= 3 spills), ``fetch_kv`` (== the parked bytes, >= 1 load from a
     spill), ``restore_kv`` (within 0.05 of the largest |value| at rate 12;
     both ZFP kernels == plain on a session's own pages) and ``release_kv``
     of each; ``park_async`` with the cache written in place at once (the
     parked bytes are the cache's before); 4 client threads compressing one
     layer each under the default policy (every container ==
     ``compress_leaf``'s, >= 1 coalesced bucket) and ``wk``/``wv`` through
     ``huffman-bytes`` (the entropy kernels == plain), decompressed back;
     ``compress_stream`` of the 512^3 field (== a direct stream), two
     overlapping ``decompress_stream`` requests in one dispatch cycle (>= 1
     coalesce hit), ``quicklook(tiers=1)`` of the progressive segment file,
     ``overload="reject"``; and the wire: a ``ReductionServer`` on a unix
     socket and on 127.0.0.1 driven by ``ReductionClient`` (ping, stats,
     compress / decompress of a layer, park_kv / fetch_kv / release_kv of a
     0.6 GB session, compress_stream of the 512^3 field in a 512 MiB
     frame, quicklook; bytes == in process; a bad-magic frame answered with
     a protocol error, then a fresh connection served); each call counted;
  4. the container bytes round trip on the card (one ZFP, one Huffman, one
     MGARD and one progressive container, and the pytree's containers):
     ``to_bytes`` -> ``from_bytes`` -> decode, bit-identical;
  5. timings with CUDA events after warm-up, median of 10 runs (one run for
     the plain Huffman decode, a Python loop over the chunk's symbols that
     takes seconds; phase 3 ran it once already): kernel
     ms, the plain versions' ms, the PyTorch library call's ms where one
     computes the same function (ZFP: both kernels at 512^3 and at the
     leaf view in events and ``torch.profiler`` device time, the block
     form, each kernel's ``-Xptxas -v`` line and shared memory; for
     solve_mass the dense
     ``torch.linalg.solve``, for lerp a stride-2 ``conv1d`` without TF32:
     yardsticks the port never calls), the plain ``pack_stream`` and the
     host codebook build, the histogram (beside ``torch.bincount``) and
     decode_chunks on all three key sets, in device time too, every MGARD
     solve of one direction level by level (with ``torch.profiler``'s device
     times beside the events for both kernels), one profiled
     call's stage times, end-to-end ms (median of 10 host-wall runs, of 5
     where 10 would take over 20 s) and the least time the card could take
     (bytes at 3.35 TB/s, operations at 67 T/s); host wall times
     (synchronised, median of 5) of ``refactor`` and its tier-0 stages, each
     ``retrieve``/``refine`` tier, ``compress_pytree`` and
     ``decompress_pytree`` beside serial ``compress_leaf`` /
     ``decompress_leaf`` over the same leaves; the stream at windows 1-3
     and auto beside the one-shot ``api.compress`` of the same host field
     (median of 5) with its lane seconds, overlap efficiency and staging
     rates, and page-locked copy rates (events); the checkpoint's save and
     restore wall times, bytes written and filesystem, apart from a plain
     write of as many bytes there (the machine's disk, not the card);
     serving: decode tokens/s and one decode step (median of 10), park_kv,
     fetch_kv resident and spilled and restore_kv of a 0.6 GB session
     (median and p99 of 10), 4 concurrent compress requests against their
     serial sum (median of 5), in process against over the unix and TCP
     sockets (one layer; one session on the unix socket; median of 3,
     loopback GB/s), and the service's waits and dispatch cycles; each
     printed with the card's name and power limit.

The last two lines are one JSON object per kernel (``{"kernels": [...]}``;
the Huffman kernels' times are those of the ``huffman-bytes`` leaf; a
kernel's launches are summed over every counted main-path call (the ZFP,
Huffman, MGARD, progressive, pytree, stream, checkpoint and serving
paths; a line before gives the last five paths' calls' own), its error
the largest of them) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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

HUFF_LEAF_SHAPE = (4096, 4096)      # float32 weights: 2^26 byte keys
HUFF_KEYS_SHAPE = (512, 512, 256)   # int32 keys: 2^26 keys
DICT_SIZE = 4096                    # MGARD's default dict_size
LAPLACE_SCALE = 16.0                # the keys' discrete-Laplace scale
CHECK_ALPHABETS = (1, 2, 256, 4096, 65536)
CHECK_COUNTS = (1, 1001, 100_003)
CHECK_CHUNKS = (256, 4096, 1001)
LUT_ALPHABET = 300                  # near-uniform keys: codes of 8-9 bits

HIST_SHARED_BINS = 227 * 1024 // 4  # the bins the histogram counts in shared memory
WIDE_BINS = 1 << 16                 # the widest alphabet leaf_policy gives huffman
DTYPE_EDGE = 256                    # the non-float32 fields of phase 3

MGARD_EDGE = 512                    # main_field(512), edge-padded to 513^3
MGARD_CMP_EDGE = 129                # the cuda vs torch backends' byte comparison
CHECK_LERP_N = (3, 5, 17, 129, 513, 4097)
CHECK_LERP_B = (1, 7, 1001)
CHECK_TRIDIAG_N = (2, 3, 5, 17, 129, 257, 513, 1025, 2049, 4097, 60001)
CHECK_TRIDIAG_VIEW_N = (17, 257, 2049)
CHECK_TRIDIAG_BATCH = (1, 31, 33, 1001)
CHECK_TRIDIAG_H = (2.0, 4.0, 512.0)
PROG_TIERS = 3                      # mgard-progressive's defaults: 3 tiers, ratio 8
PROG_RATIO = 8.0
QWEN = {"vocab": 151936, "d_model": 2048, "kv_dim": 256, "d_ff": 11008}  # hf:Qwen/Qwen2.5-3B
QWEN_LAYERS = 4                     # the embedding and the first 4 of its 36 layers
NEW_TIMED_RUNS = 5                  # medians of the progressive, pytree and stream timings
STREAM_CHUNK = 8 << 20              # elements: 32 planes of the 512^3 field, 16 chunks
STREAM_WINDOWS = (1, 2, 3)
RACE_CHUNK = 1 << 20                # 4 planes: 128 chunks, the staging copy's event check
HUFF_STREAM_CHUNK = 4 << 20         # 1024 rows of the 4096x4096 weight leaf: 4 chunks
MGARD_STREAM_ROWS = 57              # 513 = 9 x 57: nine (57, 513, 513) chunks
CKPT_ROUTING = (21, 8, 20)          # leaves streamed / one-shot zfp / huffman-bytes
SERVE_BATCH = 4                     # ServingEngine slots
SERVE_MAX_LEN = 8192                # cache positions a slot
SERVE_REQUESTS = 8                  # two waves of requests: the refill path runs
SERVE_PROMPT = 32
SERVE_NEW = 16
SERVE_CHECK_LAYERS = 2              # the depth cut of the card vs CPU decode step
# card vs CPU decode step: max |logit difference| <= tol x (1 + max |logit|)
SERVE_CHECK_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
KV_SESSIONS = 4                     # long-context sessions parked, of KV_TENANTS tenants
KV_TENANTS = 2
KV_SESSION_SHAPE = (36, 1, 8192, 2, 128)   # qwen2.5-3b's k (or v) of one 8192-token session
KV_ERR_TOL = 0.05                   # zfp rate 12: ~0.022 of max |value| on N(0, 1) pages
KV_TIMED_RUNS = 10
SERVICE_CLIENTS = 4
WIRE_TIMED_RUNS = 3
MGARD_KERNELS = {  # name: (TPU kernel it replaces, CUDA source)
    "quantize_map.quantize": ("src/repro/kernels/quantize_map/kernel.py:37",
                              "src/repro_torch/kernels/quantize_map/csrc/quantize_map.cu"),
    "quantize_map.dequantize": ("src/repro/kernels/quantize_map/kernel.py:68",
                                "src/repro_torch/kernels/quantize_map/csrc/quantize_map.cu"),
    "tridiag.solve_mass": ("src/repro/kernels/tridiag/kernel.py:48",
                           "src/repro_torch/kernels/tridiag/csrc/tridiag.cu"),
    "mgard_lerp.lerp_coefficients": ("src/repro/kernels/mgard_lerp/kernel.py:30",
                                     "src/repro_torch/kernels/mgard_lerp/csrc/mgard_lerp.cu"),
}

KERNELS = {
    "compress_blocks": "src/repro/kernels/zfp_block/kernel.py:78",
    "decompress_blocks": "src/repro/kernels/zfp_block/kernel.py:114",
}
KERNEL_SOURCE = "src/repro_torch/kernels/zfp_block/csrc/zfp_block.cu"
HUFF_KERNELS = {  # name: (TPU kernel it replaces, CUDA source)
    "histogram.histogram": ("src/repro/kernels/histogram/kernel.py:39",
                            "src/repro_torch/kernels/histogram/csrc/histogram.cu"),
    "huffman_encode.encode_lookup": (
        "src/repro/kernels/huffman_encode/kernel.py:31",
        "src/repro_torch/kernels/huffman_encode/csrc/huffman_encode.cu"),
    "huffman_decode.decode_chunks": (
        "src/repro/kernels/huffman_decode/kernel.py:58",
        "src/repro_torch/kernels/huffman_decode/csrc/huffman_decode.cu"),
}


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


def int_err(a, b) -> float:
    """Largest |a - b| of two integer tensors (inf if the shapes differ)."""
    import torch

    if a.shape != b.shape:
        return math.inf
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(a.device, torch.int64)).abs().max())


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


def kernel_device_ms(fn, names: tuple[str, ...] | None) -> list[float]:
    """Device time in ms of each launch of a kernel whose name holds one of
    ``names`` (``None``: of every kernel and memset) during one call of
    ``fn``, in launch order, from ``torch.profiler`` (CUPTI); unlike events
    around a call, it leaves out the time the host takes to enqueue the
    launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiling session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and (names is None or any(n in e.name for n in names))]
        if kernels:
            break
    kernels.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in kernels]


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
    phase_zfp_field_vs_plain(device)


def zfp_field_cases(device) -> list[tuple[str, "torch.Tensor", tuple]]:
    """Padded fields for the field form of the ZFP kernels, with their rates:
    the CHECK_SHAPES fields padded as compress_field pads them; per d, one
    block along the last axis, a last-axis block count that is no multiple
    of the kernel's tile, a single block, the special blocks along the last
    axis and as the block form's field; the main path's two views."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.abstractions import pad_to_blocks
    from repro_torch.core.machine import unblock_view
    from repro_torch.kernels.zfp_block import kernel

    cases = [(f"{shape} padded", pad_to_blocks(odd_field(shape, device), (4,) * len(shape)),
              CHECK_RATES) for shape in CHECK_SHAPES]
    for dims in (1, 2, 3, 4):
        tile = kernel.tile_blocks(dims)
        block = (4,) * dims
        special = special_blocks(dims, device).reshape((8,) + block)
        cases += [
            (f"d {dims}, one block along the last axis",
             odd_field((12,) * (dims - 1) + (4,), device), CHECK_RATES),
            (f"d {dims}, {2 * tile + 5} blocks along the last axis (tile {tile})",
             odd_field((8,) * (dims - 1) + (4 * (2 * tile + 5),), device), CHECK_RATES),
            (f"d {dims}, a single block", odd_field(block, device), CHECK_RATES),
            (f"d {dims}, special blocks along the last axis",
             unblock_view(special, (1,) * (dims - 1) + (8,), block), CHECK_RATES),
            (f"d {dims}, special blocks as the block form's field",
             special.reshape((32,) + (4,) * (dims - 1)), CHECK_RATES),
        ]
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    leaf = torch.randn(LEAF_SHAPE, generator=g, device=device)
    cases += [(f"main path {FIELD_EDGE}^3", main_field(FIELD_EDGE, device), (RATE,)),
              (f"main path leaf view {LEAF_SHAPE} -> (n, 32, 32)", api.as_blocked_3d(leaf),
               (RATE,))]
    return [(what, x.contiguous(), rates) for what, x, rates in cases]


def phase_zfp_field_vs_plain(device) -> None:
    """Phase 2: the field form of the ZFP kernels against its plain version
    (block_view + the plain block encode, and back), tolerance 0."""
    import torch

    from repro_torch.kernels.zfp_block import kernel, ref

    checked = 0
    cases = zfp_field_cases(device)
    for what, x, rates in cases:
        dims, shape = x.ndim, tuple(x.shape)
        for rate in rates:
            p, e = kernel.compress_field(x, rate, dims)
            d = kernel.decompress_field(p, e, rate, dims, shape)
            torch.cuda.synchronize()
            rp, re_ = ref.compress_field(x, rate, dims, chunk=PLAIN_CHUNK)
            rd = ref.decompress_field(rp, re_, rate, dims, shape, chunk=PLAIN_CHUNK)
            for name, got, want in (("payload", p, rp), ("emax", e, re_), ("decoded", d, rd)):
                if not same_bits(got, want.contiguous()):
                    raise PhaseError(
                        f"zfp field form {name} differs from the plain version: {what}, "
                        f"shape {shape}, rate {rate}, max |err| {max_abs_err(got, want)}")
            checked += 1
    log(f"phase 2 ok: zfp compress_field/decompress_field == plain versions on the card for "
        f"{checked} (field, rate) cases over {len(cases)} fields: {[w for w, _, _ in cases]} "
        "(tolerance 0)")


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------


def kernel_modules() -> dict:
    from repro_torch.kernels.histogram import kernel as hist
    from repro_torch.kernels.huffman_decode import kernel as dec
    from repro_torch.kernels.huffman_encode import kernel as enc
    from repro_torch.kernels.mgard_lerp import kernel as lerp
    from repro_torch.kernels.quantize_map import kernel as quant
    from repro_torch.kernels.tridiag import kernel as tri
    from repro_torch.kernels.zfp_block import kernel as zfp

    return {"zfp_block": zfp, "histogram": hist, "huffman_encode": enc, "huffman_decode": dec,
            "quantize_map": quant, "tridiag": tri, "mgard_lerp": lerp}


def reset_counts() -> None:
    for mod in kernel_modules().values():
        mod.reset_launches()


def read_counts() -> dict[str, int]:
    return {f"{pkg}.{name}": n for pkg, mod in kernel_modules().items()
            for name, n in mod.launches.items()}


def skewed_keys(num_bins: int, n: int, device, seed: int) -> "torch.Tensor":
    """Skewed int32 keys in [0, num_bins), every key present when n allows."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=g, device=device)
    keys = (u ** 4 * num_bins).to(torch.int32).clamp_(max=num_bins - 1)
    m = min(n, num_bins)
    keys[:m] = torch.arange(m, dtype=torch.int32, device=device)
    return keys[torch.randperm(n, generator=g, device=device)].contiguous()


def laplace_keys(shape: tuple, device) -> "torch.Tensor":
    """Discrete-Laplace int32 keys around DICT_SIZE / 2, clipped into the
    alphabet, with its two ends present (the alphabet spans DICT_SIZE)."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    u = torch.rand(shape, generator=g, device=device) - 0.5
    x = DICT_SIZE // 2 - LAPLACE_SCALE * torch.sign(u) * torch.log1p(-2 * u.abs())
    keys = x.round().clamp(0, DICT_SIZE - 1).to(torch.int32)
    keys.view(-1)[0] = 0
    keys.view(-1)[-1] = DICT_SIZE - 1
    return keys


def fibonacci_freq(n: int = 40):
    import numpy as np

    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    return np.array(fib, np.int64)


def plain_stream(keys, book, chunk_size: int):
    """Words, chunk offsets and padded decode tables of ``keys`` under
    ``book``, built with the plain versions where the keys lie."""
    import torch

    from repro_torch.core import bitstream as bs
    from repro_torch.core import huffman
    from repro_torch.kernels.huffman_encode import ref as enc_ref

    device = keys.device
    codes_t, lens_t = huffman.codebook_tables(book, device)
    codes, lens = enc_ref.encode_lookup(keys, codes_t, lens_t)
    num_words = max(1, bs.words_needed(int(lens.to(torch.int64).sum())))
    if keys.numel():
        words, offsets = enc_ref.pack_stream(codes, lens, num_words, chunk_size)
    else:
        words = torch.zeros(num_words, dtype=torch.int32, device=device)
        offsets = torch.zeros(0, dtype=torch.int32, device=device)
    tables = huffman.padded_tables(huffman.decode_tables(book.lengths, device))
    return words, offsets, tables


def check_decode(what: str, keys, words, offsets, tables, chunk_size: int) -> float:
    """decode_chunks kernel == plain version on the whole output; the keys
    come back."""
    import torch

    from repro_torch.kernels.huffman_decode import kernel as dec_kernel
    from repro_torch.kernels.huffman_decode import ref as dec_ref

    max_len = int(tables[0].shape[0]) - 1
    got = dec_kernel.decode_chunks(words, offsets, *tables, chunk_size, max_len)
    torch.cuda.synchronize()
    err = int_err(got, dec_ref.decode_chunks(words, offsets, *tables, chunk_size, max_len))
    if err or not torch.equal(got.reshape(-1)[: keys.numel()], keys):
        raise PhaseError(f"decode_chunks differs from its plain version or the keys: {what}, "
                         f"chunk {chunk_size}, max |err| {err}")
    return err


def phase_huffman_kernels_vs_plain(device) -> None:
    """Phase 2, Huffman: histogram, encode_lookup and decode_chunks against
    their plain versions on the card (tolerance 0)."""
    import torch

    from repro_torch.core import huffman
    from repro_torch.kernels.histogram import kernel as hist_kernel
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.huffman_decode import ref as dec_ref
    from repro_torch.kernels.huffman_encode import kernel as enc_kernel
    from repro_torch.kernels.huffman_encode import ref as enc_ref

    checked = 0
    cases = [(nb, n, None) for nb in CHECK_ALPHABETS for n in CHECK_COUNTS]
    cases.append((40, CHECK_COUNTS[-1], fibonacci_freq()))
    for nb, n, freq in cases:
        what = f"{nb} keys, {n} symbols" + (", Fibonacci frequencies" if freq is not None else "")
        keys = skewed_keys(nb, n, device, SEED + nb + n)
        probe = keys.clone()
        probe[::97] = -3        # out of range: counted nowhere, clamped by the gather
        probe[1::101] = nb
        hk = hist_kernel.histogram(probe, nb)
        book = huffman.build_codebook(
            hist_ref.histogram(keys, nb).cpu().numpy() if freq is None else freq)
        if freq is not None and book.max_len != 32:
            raise PhaseError(f"the Fibonacci alphabet's codes reach {book.max_len} bits, not 32")
        if nb >= 4096 and n == CHECK_COUNTS[-1] and book.max_len <= dec_ref.LUT_BITS:
            raise PhaseError(f"{what}: codes of {book.max_len} bits never escape the table")
        ek = enc_kernel.encode_lookup(probe, *huffman.codebook_tables(book, device))
        torch.cuda.synchronize()
        ep = enc_ref.encode_lookup(probe, *huffman.codebook_tables(book, device))
        errs = {"histogram": int_err(hk, hist_ref.histogram(probe, nb)),
                "codes": int_err(ek[0], ep[0]), "lengths": int_err(ek[1], ep[1])}
        if any(errs.values()):
            raise PhaseError(f"Huffman kernels differ from their plain versions: {what}: {errs}")
        if n == CHECK_COUNTS[-1]:
            for chunk in CHECK_CHUNKS:
                check_decode(what, keys, *plain_stream(keys, book, chunk), chunk)
        checked += 1
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    keys = torch.randint(0, LUT_ALPHABET, (CHECK_COUNTS[-1],), generator=g, device=device,
                         dtype=torch.int32)
    book = huffman.build_codebook(hist_ref.histogram(keys, LUT_ALPHABET).cpu().numpy())
    if book.max_len > dec_ref.LUT_BITS:
        raise PhaseError(f"the near-uniform alphabet's codes reach {book.max_len} bits")
    for chunk in CHECK_CHUNKS:
        check_decode(f"{LUT_ALPHABET} near-uniform keys", keys, *plain_stream(keys, book, chunk),
                     chunk)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    if int_err(hist_kernel.histogram(empty, 7), torch.zeros(7, dtype=torch.int32)):
        raise PhaseError("histogram of an empty stream is not all zero")
    book = huffman.build_codebook(torch.zeros(4, dtype=torch.int64).numpy())
    for chunk in CHECK_CHUNKS:
        check_decode("empty stream", empty, *plain_stream(empty, book, chunk), chunk)
    for nb in (HIST_SHARED_BINS, HIST_SHARED_BINS + 1, WIDE_BINS):
        if hist_kernel.launch_info(nb)["smem_bytes"] != 4 * HIST_SHARED_BINS:
            raise PhaseError(f"histogram of {nb} bins: {hist_kernel.launch_info(nb)}, "
                             f"expected a shared window of {HIST_SHARED_BINS} bins")
    contention = histogram_contention_cases(device)
    for what, keys, nb in contention:
        for start in range(4):  # every alignment of the first key
            k = keys[start:]
            got = hist_kernel.histogram(k, nb)
            torch.cuda.synchronize()
            if int_err(got, hist_ref.histogram(k, nb)):
                raise PhaseError(f"histogram differs from its plain version: {what}, "
                                 f"first key {start}")
    log(f"phase 2 ok: histogram == plain version on the card under contention and at its "
        f"limits ({', '.join(w for w, _, _ in contention)}), each from all four alignments")
    log(f"phase 2 ok: histogram, encode_lookup == plain versions on the card for {checked} "
        f"(alphabet, count) cases, out-of-range keys included; decode_chunks == plain "
        f"version (whole output) at chunks {CHECK_CHUNKS}, codes within the "
        f"{dec_ref.LUT_BITS}-bit table only, escaping it, up to 32 bits, empty stream "
        "(tolerance 0)")


def histogram_contention_cases(device) -> list[tuple[str, "torch.Tensor", int]]:
    """Key streams that stress the histogram: one value throughout (more
    than 2^16 of it a CTA, past any 16-bit counter), two
    alternating values, sorted keys (long runs), the bytes of N(0, 0.02^2)
    float32 values (a few exponent bytes), alphabets at the shared window's
    width and one past it, and a 2^16-key alphabet whose keys all lie past
    the window (counted in global memory), a quarter of them one value."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    i32 = dict(dtype=torch.int32, device=device)
    w = torch.randn(1 << 20, generator=g, device=device) * 0.02
    past = torch.randint(HIST_SHARED_BINS, WIDE_BINS, (1 << 22,), generator=g, **i32)
    past[::4] = WIDE_BINS - 1
    return [
        ("one value", torch.full((1 << 25,), 7, **i32), 256),
        ("one value, 4096 bins", torch.zeros(3_000_001, **i32), 4096),
        ("two alternating", torch.tensor([3, 200], **i32).repeat(1 << 20), 256),
        ("sorted runs", torch.sort(skewed_keys(4096, 1 << 21, device, SEED + 10)).values, 4096),
        ("float bytes", w.view(torch.uint8).to(torch.int32), 256),
        (f"{HIST_SHARED_BINS} bins", skewed_keys(HIST_SHARED_BINS, 1_000_003, device,
                                                 SEED + 11), HIST_SHARED_BINS),
        (f"{HIST_SHARED_BINS + 1} bins", skewed_keys(HIST_SHARED_BINS + 1, 1_000_003, device,
                                                     SEED + 12), HIST_SHARED_BINS + 1),
        ("keys past the shared window", past, WIDE_BINS),
    ]


def policy_keys(x, method: str):
    """The int32 key stream the codec's first stage makes of ``x``."""
    import torch

    from repro_torch.core.codecs.huffman_codec import byte_view

    if method == "huffman-bytes":
        return byte_view(x).reshape(-1).to(torch.int32)
    return x.reshape(-1).to(torch.int32)


def check_entropy_kernels(name: str, keys, nb: int, c, device) -> dict:
    """histogram, encode_lookup and decode_chunks against their plain versions
    on one main-path run's keys (alphabet ``nb``) and container ``c``, whose
    codebook must be the one these keys give (tolerance 0)."""
    import numpy as np
    import torch

    from repro_torch.core import huffman
    from repro_torch.kernels.histogram import kernel as hist_kernel
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.huffman_encode import kernel as enc_kernel
    from repro_torch.kernels.huffman_encode import ref as enc_ref

    chunk = int(c.meta["chunk_size"])
    freq = hist_kernel.histogram(keys, nb)
    book = huffman.build_codebook(freq.cpu().numpy())
    if not np.array_equal(np.asarray(book.lengths, np.int64),
                          np.asarray(c.arrays["length_table"], np.int64)):
        raise PhaseError(f"{name}: the keys' codebook is not the container's length table")
    codes_t, lens_t = huffman.codebook_tables(book, device)
    codes, lens = enc_kernel.encode_lookup(keys, codes_t, lens_t)
    pc, pl = enc_ref.encode_lookup(keys, codes_t, lens_t)
    words = torch.from_numpy(c.arrays["words"].view("int32")).to(device)
    offsets = torch.from_numpy(c.arrays["chunk_offsets"]).to(device)
    tables = huffman.padded_tables(huffman.decode_tables(c.arrays["length_table"], device))
    errs = {
        "histogram.histogram": int_err(freq, hist_ref.histogram(keys, nb)),
        "huffman_encode.encode_lookup": max(int_err(codes, pc), int_err(lens, pl)),
        "huffman_decode.decode_chunks": check_decode(name, keys, words, offsets, tables, chunk),
    }
    if any(errs.values()):
        raise PhaseError(f"{name}: kernels differ from their plain versions: {errs}")
    return {"errs": errs, "chunk": chunk, "book": book, "freq": freq, "codes_t": codes_t,
            "lens_t": lens_t, "codes": codes, "lens": lens, "words": words,
            "offsets": offsets, "tables": tables}


def run_huffman_path(name: str, x, method: str, api, device) -> dict:
    """One Huffman main-path run (counters zeroed just before, read just
    after), then its checks: round trip, bytes against the plain versions,
    each kernel against its plain version at this run's shapes."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    c = api.compress_leaf(x, method)
    out = api.decompress_leaf(c)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"phase 3 launches on the Huffman main path ({name}): {counts}")
    for k in HUFF_KERNELS:
        if counts[k] <= 0:
            raise PhaseError(f"{name}: kernel {k} never launched on the main path: {counts}")
    if out.device != device or out.dtype != x.dtype or tuple(out.shape) != tuple(x.shape):
        raise PhaseError(f"{name}: decoded {out.device} {out.dtype} {tuple(out.shape)}")
    same = torch.equal(out.view(torch.int32), x.view(torch.int32))
    if not same:
        raise PhaseError(f"{name}: the round trip is not exact")
    t0 = time.perf_counter()
    plain = api.compress_leaf(x.cpu(), method, backend="torch")
    plain_s = time.perf_counter() - t0
    if plain.to_bytes() != c.to_bytes():
        raise PhaseError(f"{name}: container bytes differ from the torch backend's")

    keys = policy_keys(x, method)
    nb = int(c.meta["num_keys"]) if c.method == "huffman" else 256
    ent = check_entropy_kernels(name, keys, nb, c, device)
    ratio = x.numel() * x.element_size() / c.nbytes()
    log(f"phase 3 ok: {name} ({method}): {keys.numel()} keys, alphabet {nb}, "
        f"{c.meta['total_bits'] / keys.numel():.4f} bits/key, longest code {ent['book'].max_len}, "
        f"ratio {ratio:.6f}; exact round trip; bytes == torch backend's (its CPU encode took "
        f"{plain_s:.1f} s); kernels == plain versions (tolerance 0)")
    return {"name": name, "x": x, "method": method, "c": c, "out": out, "counts": counts,
            "keys": keys, "num_bins": nb, **ent}


def phase_huffman_main_path(device, api) -> list[dict]:
    """Phase 3, Huffman: the checkpoint leaf and the MGARD-like key array."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    leaf = torch.randn(HUFF_LEAF_SHAPE, generator=g, device=device) * 0.02
    keys = laplace_keys(HUFF_KEYS_SHAPE, device)
    return [
        run_huffman_path(f"{HUFF_LEAF_SHAPE} float32 weights", leaf, "huffman-bytes", api, device),
        run_huffman_path(f"{HUFF_KEYS_SHAPE} int32 keys", keys, "huffman", api, device),
    ]


def phase_huffman_timings(api, run: dict, card: str) -> list[dict]:
    """Phase 5, Huffman: one main-path run's kernels, plain versions,
    library calls, pack_stream, codebook and end to end."""
    import torch

    from repro_torch.core import huffman
    from repro_torch.kernels.histogram import kernel as hist_kernel
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.huffman_decode import kernel as dec_kernel
    from repro_torch.kernels.huffman_decode import ref as dec_ref
    from repro_torch.kernels.huffman_encode import kernel as enc_kernel
    from repro_torch.kernels.huffman_encode import ref as enc_ref

    keys, nb, chunk = run["keys"], run["num_bins"], run["chunk"]
    codes_t, lens_t, codes, lens = run["codes_t"], run["lens_t"], run["codes"], run["lens"]
    words, offsets, tables = run["words"], run["offsets"], run["tables"]
    c, x, method = run["c"], run["x"], run["method"]
    n = keys.numel()
    n_chunks = offsets.numel()
    max_len = int(tables[0].shape[0]) - 1
    num_words = words.numel()
    bits_per_key = c.meta["total_bits"] / n

    ms = {
        "histogram.histogram": median_ms(lambda: hist_kernel.histogram(keys, nb)),
        "huffman_encode.encode_lookup": median_ms(
            lambda: enc_kernel.encode_lookup(keys, codes_t, lens_t)),
        "huffman_decode.decode_chunks": median_ms(
            lambda: dec_kernel.decode_chunks(words, offsets, *tables, chunk, max_len)),
    }
    plain_ms = {
        "histogram.histogram": median_ms(lambda: hist_ref.histogram(keys, nb)),
        "huffman_encode.encode_lookup": median_ms(
            lambda: enc_ref.encode_lookup(keys, codes_t, lens_t)),
        "huffman_decode.decode_chunks": median_ms(
            lambda: dec_ref.decode_chunks(words, offsets, *tables, chunk, max_len),
            runs=1, warmup=0),
    }
    library_ms = {
        "histogram.histogram": median_ms(lambda: torch.bincount(keys, minlength=nb)),
        "huffman_encode.encode_lookup": median_ms(lambda: (codes_t[keys], lens_t[keys])),
        "huffman_decode.decode_chunks": None,
    }
    pack_ms = median_ms(lambda: enc_ref.pack_stream(codes, lens, num_words, chunk))
    freq_np = run["freq"].cpu().numpy()
    codebook_ms = median_wall_ms(lambda: huffman.build_codebook(freq_np))
    e2e_compress = median_wall_ms(lambda: api.compress_leaf(x, method))
    e2e_decompress = median_wall_ms(lambda: api.decompress_leaf(c))

    moved = {  # each input read once, each output written once
        "histogram.histogram": 4 * n + 4 * nb,
        "huffman_encode.encode_lookup": 12 * n + 8 * nb,
        "huffman_decode.decode_chunks": decode_bytes(run),
    }
    ops = {  # integer operations on this run's data
        "histogram.histogram": 4 * n,             # range check, match, popcount, add
        "huffman_encode.encode_lookup": 4 * n,    # clamp, two probes, store
        "huffman_decode.decode_chunks": int(n_chunks * chunk * (14 + 4 * bits_per_key)),
    }
    out = []
    for name, (replaces, source) in HUFF_KERNELS.items():
        b_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        o_ms = ops[name] / OPS_PER_S * 1e3
        bound_ms = max(b_ms, o_ms)
        lib = library_ms[name]
        log(f"phase 5 [{card}] {run['name']} {name}: kernel {ms[name]:.4f} ms "
            f"({moved[name] / ms[name] / 1e6:.1f} GB/s), plain version {plain_ms[name]:.4f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms "
            f"(bytes {b_ms:.4f} ms, operations {o_ms:.4f} ms), "
            f"{bound_ms / ms[name]:.1%} of the bound")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                    "bound_by": "bytes" if b_ms >= o_ms else "operations", "library_ms": lib})
    histogram_timings(run["name"], keys, nb, card, ms["histogram.histogram"],
                      library_ms["histogram.histogram"])
    decode_timings(run, card, ms["huffman_decode.decode_chunks"])
    xp, policy_method, _ = api.leaf_policy(x, method)
    _, enc_stages, enc_moved = api.encode_profiled(api.make_spec(xp, policy_method), xp)
    _, dec_stages, dec_moved = api.decode_profiled(c)
    log(f"phase 5 [{card}] {run['name']}: plain pack_stream {pack_ms:.4f} ms, host codebook "
        f"build {codebook_ms:.4f} ms (wall, alphabet {nb})")
    log(f"phase 5 [{card}] {run['name']} one profiled call: encode stages {enc_stages} s, "
        f"transfers {enc_moved.as_dict()}; decode stages {dec_stages} s, "
        f"transfers {dec_moved.as_dict()}")
    nbytes = x.numel() * x.element_size()
    log(f"phase 5 [{card}] {run['name']} end to end (host wall, synchronised): "
        f"compress_leaf {e2e_compress:.4f} ms ({nbytes / e2e_compress / 1e6:.1f} GB/s of input), "
        f"decompress_leaf {e2e_decompress:.4f} ms ({nbytes / e2e_decompress / 1e6:.1f} GB/s "
        "of output)")
    return out


def histogram_timings(name: str, keys, nb: int, card: str, ms: float | None = None,
                      lib_ms: float | None = None) -> None:
    """Phase 5: the histogram on one main-path key set, in events around a
    call and in device time (median of TIMED_RUNS launches), beside its
    bound and torch.bincount (events, and the device time of all its
    kernels a call: it reduces the keys' maximum first)."""
    import torch

    from repro_torch.kernels.histogram import kernel as hist_kernel

    def ours():
        return hist_kernel.histogram(keys, nb)

    def library():
        return torch.bincount(keys, minlength=nb)

    ms = median_ms(ours) if ms is None else ms
    lib_ms = median_ms(library) if lib_ms is None else lib_ms
    dev = kernel_device_ms(lambda: [ours() for _ in range(TIMED_RUNS)], ("hist_shared",))
    lib_dev = sum(kernel_device_ms(lambda: [library() for _ in range(TIMED_RUNS)], None))
    bound_ms = (4 * keys.numel() + 4 * nb) / HBM_BYTES_PER_S * 1e3
    dev_ms = statistics.median(dev) if len(dev) == TIMED_RUNS else None
    log(f"phase 5 [{card}] {name} histogram.histogram: {keys.numel()} keys, {nb} bins, launch "
        f"{hist_kernel.launch_info(nb)}; {ms:.4f} ms in events, device "
        + (f"{dev_ms:.4f} ms (torch.profiler), {bound_ms / dev_ms:.1%} of the bound"
           if dev_ms else "not measured")
        + f" {bound_ms:.4f} ms (bytes); torch.bincount {lib_ms:.4f} ms in events, "
        f"{lib_dev / TIMED_RUNS:.4f} ms of device time")


def decode_bytes(run: dict) -> int:
    """decode_chunks' bytes: the output written once, the words, the chunk
    offsets and the tables read once."""
    table_bytes = 4 * sum(int(t.numel()) for t in run["tables"])
    n_chunks = run["offsets"].numel()
    return 4 * n_chunks * run["chunk"] + 4 * run["words"].numel() + 4 * n_chunks + table_bytes


def decode_timings(run: dict, card: str, ms: float | None = None) -> None:
    """Phase 5: decode_chunks on one main-path run's keys, in events around
    a call and on the device, beside its bound."""
    from repro_torch.kernels.huffman_decode import kernel as dec_kernel

    words, offsets, tables, chunk = run["words"], run["offsets"], run["tables"], run["chunk"]
    max_len = int(tables[0].shape[0]) - 1
    if ms is None:
        ms = median_ms(lambda: dec_kernel.decode_chunks(words, offsets, *tables, chunk, max_len))
    device = kernel_device_ms(lambda: dec_kernel.decode_chunks(words, offsets, *tables, chunk,
                                                               max_len), ("decode_kernel",))
    bound_ms = decode_bytes(run) / HBM_BYTES_PER_S * 1e3
    log(f"phase 5 [{card}] {run['name']} huffman_decode.decode_chunks: {offsets.numel()} "
        f"chunks of {chunk}, longest code {max_len} bits; {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes), {bound_ms / ms:.1%} of the bound; device time "
        + (f"{device[0]:.4f} ms (torch.profiler), {bound_ms / device[0]:.1%} of the bound"
           if len(device) == 1 else "not measured"))


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

    with count_block_views() as views:
        reset_counts()
        c = api.compress(field, "zfp", rate=RATE)
        out = api.decompress(c)
        cl = api.compress_leaf(leaf, "zfp", rate=RATE)
        leaf_out = api.decompress_leaf(cl)
        torch.cuda.synchronize()
        counts = read_counts()
    launches = dict(kernel.launches)
    log(f"phase 3 launches on the ZFP main path: {counts}")
    if any(n <= 0 for n in launches.values()):
        raise PhaseError(f"a kernel of the main path never launched: {launches}")
    if any(views.values()):
        raise PhaseError(f"the cuda ZFP path called the layout copies: {views}")
    log(f"phase 3 ok: the cuda ZFP path called block_view / unblock_view {views}")
    if out.device != device or leaf_out.device != device:
        raise PhaseError("decode did not return a tensor on the card")

    tables = api.get_plan(api.make_spec(field, "zfp", rate=RATE)).workspace
    main = check_container(f"zfp {FIELD_EDGE}^3 field", c, field, out, 3, tables)
    leaf_blocked = api.as_blocked_3d(leaf)
    leaf_res = check_container(f"compress_leaf {LEAF_SHAPE}", cl, leaf_blocked,
                               leaf_out.reshape(leaf_blocked.shape), 3, tables)
    for name, got, x in ((f"zfp {FIELD_EDGE}^3", c, field), (f"zfp leaf {LEAF_SHAPE}", cl, leaf)):
        t0 = time.perf_counter()
        plain = (api.compress(x.cpu(), "zfp", rate=RATE, backend="torch") if x is field
                 else api.compress_leaf(x.cpu(), "zfp", rate=RATE, backend="torch"))
        if plain.to_bytes() != got.to_bytes():
            raise PhaseError(f"{name}: container bytes differ from the torch backend's")
        log(f"phase 3 ok: {name}: container bytes == torch backend's (its CPU encode took "
            f"{time.perf_counter() - t0:.1f} s)")
    main["leaf"], main["leaf_payload"], main["leaf_emax"] = (
        leaf_blocked, leaf_res["payload"], leaf_res["emax"])
    return field, c, out, main, launches, tables


@contextlib.contextmanager
def count_block_views():
    """Count calls of ``machine.block_view`` / ``unblock_view`` (wherever the
    port imported them) while the block runs."""
    from repro_torch.core import machine

    calls = {"block_view": 0, "unblock_view": 0}
    originals = {name: getattr(machine, name) for name in calls}

    def spy(name):
        def counted(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return counted

    patched = [(mod, name) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith("repro_torch")
               for name in calls if getattr(mod, name, None) is originals[name]]
    for mod, name in patched:
        setattr(mod, name, spy(name))
    try:
        yield calls
    finally:
        for mod, name in patched:
            setattr(mod, name, originals[name])


@contextlib.contextmanager
def held_to_plain():
    """While the block runs, every call of the decode side's kernel wrappers
    (``decode_chunks``, ``dequantize``, ``solve_columns``), wherever the port
    holds them (module attributes, the adapters' registry), also runs the
    plain version on the same inputs; yields kernel name -> [calls, largest
    |kernel - plain|].  The plain runs launch nothing that is counted."""
    import threading

    from repro_torch.core import adapters
    from repro_torch.kernels.huffman_decode import kernel as dk
    from repro_torch.kernels.huffman_decode import ref as dr
    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr

    pairs = {"huffman_decode.decode_chunks": (dk.decode_chunks, dr.decode_chunks),
             "quantize_map.dequantize": (qk.dequantize, qr.dequantize),
             "tridiag.solve_mass": (tk.solve_columns, tr.sweep_columns)}
    seen = {name: [0, 0.0] for name in pairs}
    lock = threading.Lock()

    def spy(name, kernel_fn, plain_fn):
        def run(*args, **kwargs):
            out = kernel_fn(*args, **kwargs)
            want = plain_fn(*args, **kwargs)
            err = max_abs_err(out, want) if out.is_floating_point() else int_err(out, want)
            with lock:
                seen[name][0] += 1
                seen[name][1] = max(seen[name][1], err)
            return out
        return run

    spies = {id(k): spy(name, k, plain) for name, (k, plain) in pairs.items()}
    kernels = {id(k): k for k, _plain in pairs.values()}
    patched = [(mod, k.__name__, k) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith("repro_torch")
               for k in kernels.values() if getattr(mod, k.__name__, None) is k]
    registered = [(op, fn) for op, fn in adapters._REGISTRY.items() if id(fn) in kernels]
    for mod, attr, k in patched:
        setattr(mod, attr, spies[id(k)])
    for op, fn in registered:
        adapters._REGISTRY[op] = spies[id(fn)]
    try:
        yield seen
    finally:
        for mod, attr, k in patched:
            setattr(mod, attr, k)
        for op, fn in registered:
            adapters._REGISTRY[op] = fn


def phase_bytes_round_trip(api, c, out, leaf: bool = False):
    from repro_torch.core.container import Compressed

    raw = c.to_bytes()
    parsed = Compressed.from_bytes(raw)
    again = api.decompress_leaf(parsed) if leaf else api.decode(parsed)
    if not same_bits(again, out):
        raise PhaseError("decode of to_bytes/from_bytes differs from the direct decode")
    log(f"phase 4 ok: {c.method}: {len(raw)} container bytes -> from_bytes -> decode on "
        "the card is bit-identical")
    return again


def ptxas_lines(lib_name: str, kernels: tuple[str, ...]) -> list[str]:
    """nvcc's -Xptxas -v report (registers, stack, spills) of each kernel
    of a built library whose mangled name holds one of ``kernels``."""
    from repro_torch.kernels import _build

    out, current = [], None
    for line in _build.library_path(lib_name).with_suffix(".so.log").read_text().splitlines():
        if "Compiling entry function" in line:
            current = next((f"{k}<{line.split(k + 'ILi')[1][0]}>" for k in kernels
                            if k + "ILi" in line), None)
        elif current and ("stack frame" in line or "registers" in line):
            out.append(f"{current}: {line.replace('ptxas info    :', '').strip()}")
    return out


def zfp_view_timings(kernel, x, payload, emax, tables, card: str, name: str) -> dict:
    """Phase 5: both ZFP kernels on one main-path view, field form, in
    events around a call and in device time, beside the view's bound."""
    dims, shape = x.ndim, tuple(x.shape)
    perm, enc, dec = tables["perm"], tables["enc_scale"], tables["dec_scale"]
    calls = {
        "compress_blocks": (lambda: kernel.compress_field(x, RATE, dims, perm=perm, scale=enc),
                            "zfp_encode_kernel"),
        "decompress_blocks": (lambda: kernel.decompress_field(payload, emax, RATE, dims, shape,
                                                              perm=perm, scale=dec),
                              "zfp_decode_kernel"),
    }
    moved = 4 * (x.numel() + payload.numel() + emax.numel())
    ops = x.numel() * (4 * dims + 7 + 2 * RATE)
    b_ms, o_ms = moved / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    res = {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    for k, (fn, kname) in calls.items():
        ms = median_ms(fn)
        dev = kernel_device_ms(fn, (kname,))
        dev_ms = dev[0] if len(dev) == 1 else None
        res[k] = {"ms": ms, "device_ms": dev_ms}
        log(f"phase 5 [{card}] zfp {name} {k} (field form, {kname}): {ms:.4f} ms in events "
            f"({moved / ms / 1e6:.1f} GB/s), device "
            + (f"{dev_ms:.4f} ms (torch.profiler), {res['bound_ms'] / dev_ms:.1%}"
               if dev_ms else "not measured")
            + f" of the bound {res['bound_ms']:.4f} ms ({res['bound_by']}; bytes {b_ms:.4f} ms, "
            f"operations {o_ms:.4f} ms); events {res['bound_ms'] / ms:.1%}")
    return res


def phase_timings(api, kernel, field, c, main, tables, card: str) -> list[dict]:
    """Phase 5: device times at the main path's shapes."""
    from repro_torch.kernels.zfp_block import ref

    dims = 3
    blocks, payload, emax = main["blocks"], main["payload"], main["emax"]
    perm, enc, dec = tables["perm"], tables["enc_scale"], tables["dec_scale"]
    n_values = field.numel()

    for line in ptxas_lines("zfp_block", ("zfp_encode_kernel", "zfp_decode_kernel")):
        log(f"phase 5 [{card}] ptxas -v {line}")
    for decode in (False, True):
        info = kernel.launch_info(dims, RATE, decode)
        log(f"phase 5 [{card}] zfp {'decode' if decode else 'encode'} kernel, d {dims}, rate "
            f"{RATE}: {info['smem_bytes']} bytes of dynamic shared memory, "
            f"{info['ctas_per_sm']} CTAs per SM of {kernel.tile_blocks(dims)} threads")
    main_t = zfp_view_timings(kernel, field, payload, emax, tables, card, f"{FIELD_EDGE}^3")
    zfp_view_timings(kernel, main["leaf"], main["leaf_payload"], main["leaf_emax"], tables,
                     card, f"leaf view {tuple(main['leaf'].shape)}")
    plain_ms = {
        "compress_blocks": median_ms(lambda: ref.compress_field(
            field, RATE, dims, perm=perm, scale=enc, chunk=PLAIN_CHUNK)),
        "decompress_blocks": median_ms(lambda: ref.decompress_field(
            payload, emax, RATE, dims, tuple(field.shape), perm=perm, scale=dec,
            chunk=PLAIN_CHUNK)),
    }
    block_ms = {
        "compress_blocks": median_ms(
            lambda: kernel.compress_blocks(blocks, RATE, dims, perm=perm, scale=enc)),
        "decompress_blocks": median_ms(
            lambda: kernel.decompress_blocks(payload, emax, RATE, dims, perm=perm, scale=dec)),
    }
    for name in KERNELS:
        log(f"phase 5 [{card}] zfp {FIELD_EDGE}^3 {name}: plain version (field form) "
            f"{plain_ms[name]:.4f} ms; the kernel on the (N, 64) block form "
            f"{block_ms[name]:.4f} ms")
    e2e_compress = median_wall_ms(lambda: api.compress(field, "zfp", rate=RATE))
    e2e_decompress = median_wall_ms(lambda: api.decompress(c))
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
         "replaces": KERNELS[name], "ms": main_t[name]["ms"], "plain_ms": plain_ms[name],
         "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"], "library_ms": None}
        for name in KERNELS
    ]


# ---------------------------------------------------------------------------
# MGARD
# ---------------------------------------------------------------------------


def quant_special(device):
    """The special cases of quantize: ±0, ±inf, NaN, ±2^31 and just inside,
    exact ties x/bin = k + ½, subnormal values, and a subnormal bin."""
    import torch

    tiny = torch.finfo(torch.float32).tiny
    x = torch.tensor([
        0.0, -0.0, math.inf, -math.inf, math.nan, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 128,
        -(2.0 ** 31) + 128, 2.0 ** 32, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 1e30, -1e30,
        tiny * 0.25, -tiny * 0.25, tiny, 1e-40, 0.375, 0.125, -0.375,
        5.0, tiny * 0.25, 0.0, -1.0, 1e-39,
    ], dtype=torch.float32, device=device)
    levels = torch.tensor([0] * 22 + [1] * 3 + [2] * 5, dtype=torch.int32, device=device)
    bins = torch.tensor([1.0, 0.25, tiny * 0.5], dtype=torch.float32, device=device)
    return x, levels, bins


def quant_random(n: int, device, seed: int):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, generator=g, device=device) * 10.0 ** (
        torch.rand(n, generator=g, device=device) * 6 - 3)
    levels = torch.randint(0, 6, (n,), generator=g, device=device, dtype=torch.int32)
    bins = 10.0 ** -(torch.rand(6, generator=g, device=device) * 3 + 1)
    return x, levels, bins


def check_quantize(what: str, x, levels, bins) -> None:
    """quantize and dequantize kernels == plain versions on the card and on
    the CPU, bit for bit."""
    import torch

    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr

    u = qk.quantize(x, levels, bins)
    g = torch.Generator(device=x.device).manual_seed(x.numel())
    keys = torch.randint(-(2 ** 31), 2 ** 31 - 1, (x.numel(),), generator=g, device=x.device,
                         dtype=torch.int32)
    keys[: min(6, keys.numel())] = torch.tensor([0, 1, 2, -1, -2, 7], dtype=torch.int32,
                                                device=x.device)[: min(6, keys.numel())]
    d = qk.dequantize(keys, levels, bins)
    torch.cuda.synchronize()
    errs = {
        "quantize": int_err(u, qr.quantize(x, levels, bins)),
        "quantize vs CPU plain": int_err(u, qr.quantize(x.cpu(), levels.cpu(), bins.cpu())),
        "dequantize": max_abs_err(d, qr.dequantize(keys, levels, bins)),
        "dequantize vs CPU plain": max_abs_err(
            d, qr.dequantize(keys.cpu(), levels.cpu(), bins.cpu())),
    }
    if not same_bits(d, qr.dequantize(keys, levels, bins)) or any(errs.values()):
        raise PhaseError(f"quantize_map differs from its plain version: {what}: {errs}")


def phase_mgard_kernels_vs_plain(device) -> None:
    """Phase 2, MGARD: quantize, dequantize, lerp_coefficients and
    solve_mass against their plain versions on the card (tolerance 0)."""
    import torch

    from repro_torch.kernels.mgard_lerp import kernel as lk
    from repro_torch.kernels.mgard_lerp import ref as lr
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr

    check_quantize("special values", *quant_special(device))
    for n in CHECK_COUNTS:
        x, levels, bins = quant_random(n, device, SEED + n)
        check_quantize(f"{n} random values", x, levels, bins)
        if n > 1:  # misaligned: the kernels' scalar path
            check_quantize(f"{n - 1} random values, misaligned", x[1:], levels[1:], bins)
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    for n in CHECK_LERP_N:
        for b in CHECK_LERP_B:
            rows = torch.randn((b, n), generator=g, device=device)
            got = lk.lerp_coefficients(rows)
            torch.cuda.synchronize()
            if not same_bits(got, lr.lerp_coefficients(rows).contiguous()):
                raise PhaseError(f"lerp_coefficients differs from its plain version: ({b}, {n})")
    for n in CHECK_TRIDIAG_N:
        for h in CHECK_TRIDIAG_H:
            rhs = torch.randn((1000 + n % 7, n), generator=g, device=device)
            got = tk.solve_mass(rhs, h)
            torch.cuda.synchronize()
            want = tr.solve_mass(rhs, h).contiguous()
            if not same_bits(got, want):
                raise PhaseError(f"solve_mass differs from the plain sweep: n {n}, h {h}, "
                                 f"max |err| {max_abs_err(got, want)}")
    views = [view for n in CHECK_TRIDIAG_VIEW_N for b in CHECK_TRIDIAG_BATCH
             for view in ((b, n, 1), (b, n, 7), (1, n, b))]
    for view in views:
        check_solve(torch.randn(view, generator=g, device=device), 4.0, f"view {view}")
    log(f"phase 2 ok: quantize, dequantize == plain versions on the card and the CPU (special "
        f"values, a subnormal bin, {CHECK_COUNTS} random values, misaligned); "
        f"lerp_coefficients at n {CHECK_LERP_N} x B {CHECK_LERP_B}; solve_mass at n "
        f"{CHECK_TRIDIAG_N} x h {CHECK_TRIDIAG_H}; solve_columns on {len(views)} (P, n, Q) "
        f"views, n {CHECK_TRIDIAG_VIEW_N}, batches {CHECK_TRIDIAG_BATCH}, Q = 1, 7 and the "
        "batch (tolerance 0)")


def check_solve(v, h: float, what: str, coeffs=None) -> None:
    """solve_columns kernel == the plain sweep on one (P, n, Q) view."""
    import torch

    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr

    got = tk.solve_columns(v, h, coeffs)
    torch.cuda.synchronize()
    want = tr.sweep_columns(v, h, coeffs)
    if not same_bits(got, want) or not got.is_contiguous():
        raise PhaseError(f"solve_columns differs from the plain sweep: {what}, h {h}, "
                         f"max |err| {max_abs_err(got, want)}")


def level_views(thomas) -> list[tuple]:
    """``(n, h, [three (P, n, Q) views])`` of every level of a cubic grid's
    decomposition, finest first: the solves of axes 0, 1 and 2."""
    return [(n, h, [(1, n, n * n), (n, n, n), (n * n, n, 1)])
            for (n, h) in sorted(thomas, reverse=True)]


def check_mgard_result(name: str, c, x, out) -> float:
    """Shape, device, finiteness and max |x - out| <= the effective bound."""
    import torch

    if out.device != x.device or tuple(out.shape) != tuple(x.shape) or out.dtype != x.dtype:
        raise PhaseError(f"{name}: decoded {out.device} {out.dtype} {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise PhaseError(f"{name}: decoded values are not all finite")
    err = float((out.to(torch.float32) - x.to(torch.float32)).abs().max())
    eb = float(c.meta["error_bound"])
    if not err <= eb:
        raise PhaseError(f"{name}: max |error| {err:.6e} > the bound {eb:.6e}")
    return err


def phase_mgard_main_path(device, api) -> dict:
    """Phase 3, MGARD: the 512^3 field through api.compress/decompress (and
    the stencil through its own entry point), counted; then each kernel
    against its plain version at these shapes, the cuda and torch backends'
    bytes on a 129^3 field, and compress_leaf of a 4096x4096 weight leaf."""
    import torch

    from repro_torch.core import mgard
    from repro_torch.kernels.mgard_lerp import ops as lerp_ops
    from repro_torch.kernels.mgard_lerp import ref as lr
    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr

    field = main_field(MGARD_EDGE, device)
    padded_field = mgard.pad_to_dyadic(field)
    edge = padded_field.shape[0]
    rows = padded_field.reshape(-1, edge)        # the level-0 rows of the grid
    torch.cuda.synchronize()
    reset_counts()
    c = api.compress(field, "mgard")
    out = api.decompress(c)
    mc = lerp_ops.lerp_coefficients(rows)        # the stencil's own entry point
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"phase 3 launches on the MGARD main path (one compress, one decompress, one "
        f"lerp_coefficients): {counts}")
    solves = 3 * mgard.total_levels(tuple(padded_field.shape))  # per direction
    want = {"quantize_map.quantize": 1, "quantize_map.dequantize": 1,
            "histogram.histogram": 1, "huffman_encode.encode_lookup": 1,
            "huffman_decode.decode_chunks": 1, "tridiag.solve_mass": 2 * solves,
            "mgard_lerp.lerp_coefficients": 1}
    if any(counts[k] != v for k, v in want.items()):
        raise PhaseError(f"MGARD main path launches {counts}, expected {want}")
    err = check_mgard_result(f"mgard {MGARD_EDGE}^3", c, field, out)
    vrange = float(field.max() - field.min())

    plan = api.get_plan(api.make_spec(field, "mgard"))
    lmap = plan.workspace["lmap"].reshape(-1)
    bins = torch.from_numpy(c.arrays["bins"].astype("float32")).to(device)
    coeffs = mgard.decompose(field, tuple(field.shape), plan.workspace["thomas"]).reshape(-1)
    keys = qk.quantize(coeffs, lmap, bins)
    back = qk.dequantize(keys, lmap, bins)
    coarse = padded_field[::2, ::2, ::2].reshape(-1, edge // 2 + 1).t().contiguous()
    thomas = plan.workspace["thomas"][(coarse.shape[0], 2.0)]
    solved = tk.solve_columns(coarse, 2.0, thomas)
    torch.cuda.synchronize()
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    plan_thomas = plan.workspace["thomas"]
    for n_l, h_l, views in level_views(plan_thomas):
        for view in views:
            check_solve(torch.randn(view, generator=g, device=device), h_l,
                        f"level n {n_l}, view {view}", plan_thomas[(n_l, h_l)])
    errs = {
        "quantize_map.quantize": int_err(keys, qr.quantize(coeffs, lmap, bins)),
        "quantize_map.dequantize": max_abs_err(back, qr.dequantize(keys, lmap, bins)),
        "tridiag.solve_mass": max_abs_err(solved, tr.sweep_columns(coarse, 2.0, thomas)),
        "mgard_lerp.lerp_coefficients": max_abs_err(mc, lr.lerp_coefficients(rows)),
    }
    if any(errs.values()):
        raise PhaseError(f"MGARD kernels differ from their plain versions: {errs}")
    dict_size = int(c.meta["dict_size"])
    entropy_keys = mgard._quantize_stage_impl(
        coeffs, lmap, bins, (coeffs.numel(),), dict_size,
        "cuda" if device.type == "cuda" else "torch")[1]
    ent = check_entropy_kernels(f"mgard {MGARD_EDGE}^3", entropy_keys, dict_size, c, device)
    errs.update(ent["errs"])
    log(f"phase 3 ok: mgard {MGARD_EDGE}^3 (padded {tuple(padded_field.shape)}): ratio "
        f"{c.ratio():.6f}, bound {c.meta['error_bound']:.6e} ({c.meta['error_bound'] / vrange:.3g}"
        f" of the range), max |error| {err:.6e}, {c.arrays['outlier_idx'].size} outliers, "
        f"{solves} solve_mass launches per direction; quantize, dequantize, solve_mass "
        f"{tuple(coarse.shape)} h 2 and on the three axis views of all "
        f"{len(level_views(plan_thomas))} levels, lerp_coefficients {tuple(rows.shape)}, and histogram, "
        f"encode_lookup, decode_chunks on this run's {entropy_keys.numel()} keys (alphabet "
        f"{dict_size}, {len(c.arrays['chunk_offsets'])} chunks, codebook == the container's) "
        "== plain versions (tolerance 0)")

    small = main_field(MGARD_CMP_EDGE, device)
    t0 = time.perf_counter()
    plain = api.compress(small.cpu(), "mgard", backend="torch")
    plain_s = time.perf_counter() - t0
    cuda_c = api.compress(small, "mgard")
    for key in sorted(set(plain.arrays) | set(cuda_c.arrays)):
        a, b = plain.arrays.get(key), cuda_c.arrays.get(key)
        if a is None or b is None or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise PhaseError(f"mgard {MGARD_CMP_EDGE}^3: section {key!r} differs between the "
                             "cuda and torch backends")
    if plain.meta != cuda_c.meta or plain.to_bytes() != cuda_c.to_bytes():
        raise PhaseError(f"mgard {MGARD_CMP_EDGE}^3: container meta differs between backends")
    small_out = api.decompress(cuda_c)
    if not same_bits(small_out, api.decompress(plain, backend="torch")):
        raise PhaseError(f"mgard {MGARD_CMP_EDGE}^3: cuda and torch decodes differ")
    check_mgard_result(f"mgard {MGARD_CMP_EDGE}^3", cuda_c, small, small_out)
    log(f"phase 3 ok: mgard {MGARD_CMP_EDGE}^3: the cuda and torch backends' containers are "
        f"byte-identical section for section ({len(plain.to_bytes())} bytes; the CPU encode "
        f"took {plain_s:.1f} s) and decode to the same bits")

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    leaf = torch.randn(HUFF_LEAF_SHAPE, generator=g, device=device) * 0.02
    cl = api.compress_leaf(leaf, "mgard")
    leaf_err = check_mgard_result(f"compress_leaf {HUFF_LEAF_SHAPE} mgard", cl, leaf,
                                  api.decompress_leaf(cl))
    log(f"phase 3 ok: compress_leaf {HUFF_LEAF_SHAPE} float32 weights with mgard: ratio "
        f"{cl.ratio():.6f}, max |error| {leaf_err:.6e} <= bound {cl.meta['error_bound']:.6e}")
    return {"name": f"mgard {MGARD_EDGE}^3", "field": field, "c": c, "out": out,
            "counts": counts, "errs": errs, "plan": plan, "coeffs": coeffs, "keys": keys,
            "entropy_keys": entropy_keys, "dict_size": dict_size,
            "lmap": lmap, "bins": bins, "rows": rows, "coarse": coarse, "thomas": thomas,
            **{k: ent[k] for k in ("words", "offsets", "tables", "chunk")}}


def phase_dtypes(device, api) -> None:
    """Phase 3, data other than float32 on the cuda backend, each call
    counted: a 256^3 float16 field through zfp (container bytes against the
    torch backend's, decode against its decode), and uint16 and bfloat16
    fields through mgard (within the bound, in the data's dtype)."""
    import torch

    field = main_field(DTYPE_EDGE, device)
    lo, hi = float(field.min()), float(field.max())
    cases = [
        ("zfp", field.to(torch.float16),
         ("zfp_block.compress_blocks", "zfp_block.decompress_blocks")),
        ("mgard", ((field - lo) / (hi - lo) * 60000).round().to(torch.int32).to(torch.uint16),
         ("quantize_map.quantize", "histogram.histogram", "huffman_decode.decode_chunks")),
        ("mgard", field.to(torch.bfloat16),
         ("quantize_map.quantize", "histogram.histogram", "huffman_decode.decode_chunks")),
    ]
    for method, x, kernels in cases:
        name = f"{method} {tuple(x.shape)} {x.dtype}"
        torch.cuda.synchronize()
        reset_counts()
        c = api.compress(x, method, rate=RATE) if method == "zfp" else api.compress(x, method)
        out = api.decompress(c)
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts[k] <= 0 for k in kernels):
            raise PhaseError(f"{name}: a kernel never launched: {counts}")
        if out.device != device or out.dtype != x.dtype or out.shape != x.shape:
            raise PhaseError(f"{name}: decoded {out.device} {out.dtype} {tuple(out.shape)}")
        if c.meta["dtype"] != api.dtype_name(x):
            raise PhaseError(f"{name}: the container records {c.meta['dtype']}")
        err = float((out.to(torch.float64) - x.to(torch.float64)).abs().max())
        if method == "zfp":
            vrange = float(x.max().float() - x.min().float())
            if not err / vrange <= ERR_TOL:
                raise PhaseError(f"{name}: max |error| {err / vrange:.3e} of the range")
            t0 = time.perf_counter()
            plain = api.compress(x.cpu(), "zfp", rate=RATE, backend="torch")
            if plain.to_bytes() != c.to_bytes():
                raise PhaseError(f"{name}: container bytes differ from the torch backend's")
            if not same_bits(out.view(torch.int16), api.decompress(plain, backend="torch")
                             .view(torch.int16)):
                raise PhaseError(f"{name}: cuda and torch decodes differ")
            check = (f"max |error| {err / vrange:.3e} of the range; bytes == torch backend's "
                     f"(its CPU encode took {time.perf_counter() - t0:.1f} s), decodes equal")
        else:
            eb = float(c.meta["error_bound"])
            # a bfloat16 output holds 8 bits: its rounding adds to the bound
            slack = float(x.abs().max().float()) * 2.0 ** -8 if x.is_floating_point() else 0.0
            if not err <= eb + slack:
                raise PhaseError(f"{name}: max |error| {err:.6e} > the bound {eb:.6e} + {slack}")
            check = f"max |error| {err:.6e} <= bound {eb:.6e} (+ {slack:.3e} output rounding)"
        log(f"phase 3 ok: {name} on cuda: ratio {c.ratio():.6f}, {check}; launches {counts}")


def library_yardsticks(rows, coarse) -> dict:
    """One PyTorch call computing each MGARD stencil's or solve's function on
    the same inputs, timed as a yardstick (the port never calls them):
    lerp as a stride-2 conv1d with weights (-0.5, 1, -0.5), cuDNN's TF32
    off; the level-0 solve as torch.linalg.solve of the dense mass matrix
    (h = 2) against all its right-hand sides, TF32 off."""
    import torch

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        weight = torch.tensor([[[-0.5, 1.0, -0.5]]], device=rows.device)
        lerp_in = rows.unsqueeze(1)
        lerp_ms = median_ms(lambda: torch.nn.functional.conv1d(lerp_in, weight, stride=2))
        n, h = coarse.shape[0], 2.0
        mass = torch.zeros((n, n), dtype=torch.float32, device=coarse.device)
        idx = torch.arange(n, device=coarse.device)
        mass[idx, idx] = 2.0 * h / 3.0
        mass[idx[1:], idx[:-1]] = h / 6.0
        mass[idx[:-1], idx[1:]] = h / 6.0
        mass[0, 0] = mass[-1, -1] = h / 3.0
        solve_ms = median_ms(lambda: torch.linalg.solve(mass, coarse))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return {"tridiag.solve_mass": solve_ms, "mgard_lerp.lerp_coefficients": lerp_ms}


def phase_mgard_timings(api, run: dict, card: str) -> list[dict]:
    """Phase 5, MGARD: each kernel alone and its plain version at the main
    path's shapes, every solve of one direction, one profiled call's
    stages, and end to end."""
    import torch

    from repro_torch.kernels.mgard_lerp import kernel as lk
    from repro_torch.kernels.mgard_lerp import ref as lr
    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr

    coeffs, keys, lmap, bins = run["coeffs"], run["keys"], run["lmap"], run["bins"]
    rows, coarse, thomas = run["rows"], run["coarse"], run["thomas"]
    field, c = run["field"], run["c"]
    n = coeffs.numel()
    b, w = rows.shape
    sn, sb = coarse.shape
    ms = {
        "quantize_map.quantize": median_ms(lambda: qk.quantize(coeffs, lmap, bins)),
        "quantize_map.dequantize": median_ms(lambda: qk.dequantize(keys, lmap, bins)),
        "tridiag.solve_mass": median_ms(lambda: tk.solve_columns(coarse, 2.0, thomas)),
        "mgard_lerp.lerp_coefficients": median_ms(lambda: lk.lerp_coefficients(rows)),
    }
    plain_ms = {
        "quantize_map.quantize": median_ms(lambda: qr.quantize(coeffs, lmap, bins)),
        "quantize_map.dequantize": median_ms(lambda: qr.dequantize(keys, lmap, bins)),
        "tridiag.solve_mass": median_ms(lambda: tr.sweep_columns(coarse, 2.0, thomas)),
        "mgard_lerp.lerp_coefficients": median_ms(lambda: lr.lerp_coefficients(rows)),
    }
    moved = {  # each input read once, each output written once
        "quantize_map.quantize": 12 * n + 4 * bins.numel(),
        "quantize_map.dequantize": 12 * n + 4 * bins.numel(),
        "tridiag.solve_mass": 8 * sn * sb + 8 * sn,
        "mgard_lerp.lerp_coefficients": 4 * b * w + 4 * b * (w // 2),
    }
    ops = {  # float32 operations on these inputs
        "quantize_map.quantize": 5 * n,      # flush, divide, round, zig-zag
        "quantize_map.dequantize": 4 * n,    # unzig-zag, convert, multiply, flush
        "tridiag.solve_mass": 5 * sn * sb,   # 2 multiplies + subtract, multiply + subtract
        "mgard_lerp.lerp_coefficients": 3 * b * (w // 2),
    }
    library_ms = {"quantize_map.quantize": None, "quantize_map.dequantize": None,
                  **library_yardsticks(rows, coarse)}
    out = []
    for name, (replaces, source) in MGARD_KERNELS.items():
        b_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        o_ms = ops[name] / OPS_PER_S * 1e3
        bound_ms = max(b_ms, o_ms)
        lib = library_ms[name]
        log(f"phase 5 [{card}] mgard {name}: kernel {ms[name]:.4f} ms "
            f"({moved[name] / ms[name] / 1e6:.1f} GB/s), plain version {plain_ms[name]:.4f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms "
            f"(bytes {b_ms:.4f} ms, operations {o_ms:.4f} ms), "
            f"{bound_ms / ms[name]:.1%} of the bound")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": run["counts"][name], "max_abs_err": run["errs"][name],
                    "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                    "bound_by": "bytes" if b_ms >= o_ms else "operations", "library_ms": lib})

    # every solve of one direction, level by level: the three axis views
    solve_ms = solve_bound_ms = 0.0
    thomas_all = run["plan"].workspace["thomas"]
    for level, (n_l, h_l, views) in enumerate(level_views(thomas_all)):
        coeffs_l = thomas_all[(n_l, h_l)]
        times = []
        for view in views:
            v = torch.randn(view, device=coarse.device)
            times.append(median_ms(lambda: tk.solve_columns(v, h_l, coeffs_l)))
        bound_l = 3 * 8 * n_l ** 3 / HBM_BYTES_PER_S * 1e3
        solve_ms += sum(times)
        solve_bound_ms += bound_l
        log(f"phase 5 [{card}] mgard tridiag.solve_mass level {level} (n {n_l}, h {h_l}): axes "
            + ", ".join(f"{view} {t:.4f} ms" for view, t in zip(views, times))
            + f"; sum {sum(times):.4f} ms, bound {bound_l:.4f} ms")
    log(f"phase 5 [{card}] mgard tridiag.solve_mass, all {run['counts']['tridiag.solve_mass'] // 2}"
        f" launches of one direction at their shapes: {solve_ms:.4f} ms (bound "
        f"{solve_bound_ms:.4f} ms; events around each call, the host's enqueue included)")
    levels = [(n_l, h_l, [torch.randn(view, device=coarse.device) for view in views])
              for n_l, h_l, views in level_views(thomas_all)]
    device = kernel_device_ms(lambda: [tk.solve_columns(v, h_l, thomas_all[(n_l, h_l)])
                                       for n_l, h_l, vs in levels for v in vs],
                              ("tile_kernel", "global_kernel"))
    if len(device) == 3 * len(levels):
        log(f"phase 5 [{card}] mgard tridiag.solve_mass device time (torch.profiler), one "
            "direction: " + "; ".join(
                f"level {i} " + ", ".join(f"{t:.4f}" for t in device[3 * i: 3 * i + 3])
                for i in range(len(levels))) + f" ms; all {len(device)}: {sum(device):.4f} ms")
    else:
        log(f"phase 5 [{card}] mgard tridiag.solve_mass device time: not measured "
            f"({len(device)} kernel events)")
    histogram_timings(run["name"], run["entropy_keys"], run["dict_size"], card)
    decode_timings(run, card)

    spec = api.make_spec(field, "mgard")
    _, enc_stages, enc_moved = api.encode_profiled(spec, field)
    _, dec_stages, dec_moved = api.decode_profiled(c)
    log(f"phase 5 [{card}] mgard {MGARD_EDGE}^3 one profiled call: encode stages "
        f"{enc_stages} s, transfers {enc_moved.as_dict()}; decode stages {dec_stages} s, "
        f"transfers {dec_moved.as_dict()}")
    e2e = {}
    for what, fn in (("api.compress", lambda: api.compress(field, "mgard")),
                     ("api.decompress", lambda: api.decompress(c))):
        probe = median_wall_ms(fn, runs=1, warmup=1)
        runs = TIMED_RUNS if probe * TIMED_RUNS <= 20e3 else 5
        e2e[what] = (median_wall_ms(fn, runs=runs, warmup=1), runs)
    nbytes = field.numel() * field.element_size()
    log(f"phase 5 [{card}] mgard {MGARD_EDGE}^3 end to end (host wall, synchronised): "
        + ", ".join(f"{k} {v:.4f} ms (median of {r}; {nbytes / v / 1e6:.1f} GB/s of the field)"
                    for k, (v, r) in e2e.items()))
    return out


# ---------------------------------------------------------------------------
# the progressive tier and the pytree entry points
# ---------------------------------------------------------------------------


def mgard_solves(shape: tuple) -> int:
    """``solve_mass`` launches of one decomposition (or recomposition) of a
    grid of ``shape``: one per participating axis of every level."""
    from repro_torch.core import mgard

    padded = tuple(mgard.padded_dim(n) for n in shape)
    return sum(len(mgard._participating(tuple(len(range(n)[s]) for n, s in zip(padded, sl))))
               for _h, sl in mgard._levels(tuple(shape)))


def check_counts(what: str, counts: dict, want: dict) -> None:
    """Every kernel in ``want`` launched exactly that often, every other
    kernel not at all."""
    extra = {k: n for k, n in counts.items() if n and k not in want}
    if any(counts[k] != n for k, n in want.items()) or extra:
        raise PhaseError(f"{what}: launches {counts}, expected {want} and no other")


@contextlib.contextmanager
def count_file_reads():
    """Bytes and calls of every ``os.pread`` while the block runs (the segment
    reader reads the trailer, the directory and each component with it)."""
    import os

    seen = {"calls": 0, "bytes": 0}
    original = os.pread

    def counted(fd, n, offset):
        raw = original(fd, n, offset)
        seen["calls"] += 1
        seen["bytes"] += len(raw)
        return raw

    os.pread = counted
    try:
        yield seen
    finally:
        os.pread = original


def phase_progressive(device, api) -> dict:
    """Phase 3, the progressive tier: the MGARD cell's 512^3 field (padded to
    513^3) through ``api.compress(field, "mgard-progressive")`` (relative
    bound 1e-2, 4096 keys, 3 tiers, ratio 8), ``progressive.refactor`` of
    the same field and bound, ``ProgressiveStream.write`` to a segment file,
    ``ProgressiveReader.retrieve(tiers=1)`` then ``refine`` to tiers 2 and
    3, and ``api.decompress``; each call counted.  Checks every tier within
    its bound, ``refine`` bit-identical to a direct retrieve, the reader's
    file reads (the components' bytes plus the trailer and directory), the
    kernels against their plain versions on tier 0's inputs, and the cuda
    and torch backends' containers of a 129^3 field byte for byte."""
    import tempfile

    import torch

    from repro_torch.core import mgard, progressive
    from repro_torch.core.container import Compressed
    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr

    field = main_field(MGARD_EDGE, device)
    solves = mgard_solves(tuple(field.shape))
    tiers = PROG_TIERS
    torch.cuda.synchronize()
    reset_counts()
    c = api.compress(field, "mgard-progressive")
    torch.cuda.synchronize()
    calls = {"api.compress": read_counts()}
    bounds = [float(b) for b in c.meta["tier_bounds"]]
    if len(bounds) != tiers or c.meta["padded"] != [MGARD_EDGE + 1] * 3:
        raise PhaseError(f"progressive manifest: {c.meta}")
    encode_want = {"tridiag.solve_mass": solves, "quantize_map.quantize": tiers,
                   "quantize_map.dequantize": tiers, "histogram.histogram": tiers,
                   "huffman_encode.encode_lookup": tiers}
    check_counts("mgard-progressive api.compress", calls["api.compress"], encode_want)

    reset_counts()
    stream = progressive.refactor(field, bounds[-1], tiers=tiers, tier_ratio=PROG_RATIO,
                                  dict_size=DICT_SIZE)
    torch.cuda.synchronize()
    calls["progressive.refactor"] = read_counts()
    check_counts("progressive.refactor", calls["progressive.refactor"], encode_want)
    if stream.components != progressive.ProgressiveStream.from_container(c).components:
        raise PhaseError("refactor's components differ from api.compress's at the same bound")

    tmp = tempfile.TemporaryDirectory(prefix="hpdr-progressive-")
    path = Path(tmp.name) / "field.hpdr"
    t0 = time.perf_counter()
    directory = stream.write(path)
    write_s = time.perf_counter() - t0
    file_bytes = path.stat().st_size
    dir_bytes = file_bytes - max(int(s["offset"]) + int(s["nbytes"])
                                 for s in directory["segments"].values())
    outs, errs = [], []
    with count_file_reads() as reads:
        with progressive.ProgressiveReader(path) as r:
            opened = dict(reads)
            for k in range(1, tiers + 1):
                reset_counts()
                out = r.retrieve(tiers=1) if k == 1 else r.refine(tiers=k)
                torch.cuda.synchronize()
                name = "reader.retrieve(tiers=1)" if k == 1 else f"reader.refine(tiers={k})"
                calls[name] = read_counts()
                check_counts(name, calls[name], {
                    "huffman_decode.decode_chunks": 1, "quantize_map.dequantize": 1,
                    "tridiag.solve_mass": solves})
                errs.append(float((out - field).abs().max()))
                if not errs[-1] <= bounds[k - 1]:
                    raise PhaseError(f"tier {k}: max |error| {errs[-1]:.6e} > {bounds[k - 1]:.6e}")
                if r.bytes_fetched != stream.nbytes_upto(k) or \
                        reads["bytes"] != opened["bytes"] + stream.nbytes_upto(k):
                    raise PhaseError(f"tier {k}: read {reads['bytes']} bytes, "
                                     f"{r.bytes_fetched} of components; expected the "
                                     f"directory's {opened['bytes']} + {stream.nbytes_upto(k)}")
                outs.append(out)
    if opened["bytes"] != dir_bytes:
        raise PhaseError(f"opening the reader read {opened['bytes']} bytes, the trailer and "
                         f"directory are {dir_bytes}")
    if any(b > a for a, b in zip(errs, errs[1:])):
        raise PhaseError(f"refinement made the error grow: {errs}")
    direct = progressive.retrieve(stream)
    if not same_bits(outs[-1], direct):
        raise PhaseError("refine is not bit-identical to a direct retrieve")
    reset_counts()
    dec = api.decompress(c)
    torch.cuda.synchronize()
    calls["api.decompress"] = read_counts()
    check_counts("mgard-progressive api.decompress", calls["api.decompress"], {
        "huffman_decode.decode_chunks": tiers, "quantize_map.dequantize": tiers,
        "tridiag.solve_mass": solves})
    if not same_bits(dec, direct) or dec.device != device:
        raise PhaseError("api.decompress differs from progressive.retrieve")
    for name, counts in calls.items():
        log(f"phase 3 launches on the progressive path, {name}: "
            f"{ {k: n for k, n in counts.items() if n} }")
    log(f"phase 3 ok: mgard-progressive {MGARD_EDGE}^3 (padded {MGARD_EDGE + 1}^3): tier bounds "
        f"{bounds}, max |error| per tier {errs} (non-increasing, each within its bound), "
        f"component bytes {stream.manifest['component_nbytes']} (ratio "
        f"{field.numel() * 4 / stream.nbytes():.6f} at all tiers, "
        f"{field.numel() * 4 / stream.nbytes_upto(1):.6f} at tier 1), segment file "
        f"{file_bytes} bytes written in {write_s:.3f} s; the reader read the trailer and "
        f"directory ({dir_bytes} bytes) once and then exactly nbytes_upto(k); refine == "
        f"direct retrieve == api.decompress (bits)")

    # the kernels against their plain versions on tier 0's inputs
    plan = progressive._mgard_plan(tuple(field.shape), DICT_SIZE, None)
    lmap = plan.workspace["lmap"].reshape(-1)
    bins = progressive._level_bins(bounds[0], plan.meta["L"], device)
    coeffs = plan.executables["decompose"](field).reshape(-1)
    keys = qk.quantize(coeffs, lmap, bins)
    back = qk.dequantize(keys, lmap, bins)
    kerr = {"quantize_map.quantize": int_err(keys, qr.quantize(coeffs, lmap, bins)),
            "quantize_map.dequantize": max_abs_err(back, qr.dequantize(keys, lmap, bins))}
    entropy_keys = mgard._quantize_stage_impl(coeffs, lmap, bins, (coeffs.numel(),), DICT_SIZE,
                                              "cuda")[1]
    comp0 = Compressed.from_bytes(stream.components[0])
    ent = check_entropy_kernels("mgard-progressive tier 0", entropy_keys,
                                int(comp0.meta["num_keys"]), comp0, device)
    kerr.update(ent["errs"])
    edge = MGARD_EDGE + 1
    coarse = mgard.pad_to_dyadic(field)[::2, ::2, ::2].reshape(-1, edge // 2 + 1).t().contiguous()
    check_solve(coarse, 2.0, "progressive level 0", plan.workspace["thomas"][(coarse.shape[0], 2.0)])
    kerr["tridiag.solve_mass"] = 0.0
    if any(kerr.values()):
        raise PhaseError(f"progressive: kernels differ from their plain versions: {kerr}")
    log(f"phase 3 ok: mgard-progressive tier 0: quantize, dequantize, histogram, encode_lookup, "
        f"decode_chunks ({len(comp0.arrays['chunk_offsets'])} chunks, alphabet "
        f"{comp0.meta['num_keys']}) and solve_mass {tuple(coarse.shape)} == plain versions "
        "(tolerance 0)")

    small = main_field(MGARD_CMP_EDGE, device)
    t0 = time.perf_counter()
    plain = api.compress(small.cpu(), "mgard-progressive", backend="torch")
    plain_s = time.perf_counter() - t0
    if plain.to_bytes() != api.compress(small, "mgard-progressive").to_bytes():
        raise PhaseError(f"mgard-progressive {MGARD_CMP_EDGE}^3: the cuda and torch backends' "
                         "containers differ")
    log(f"phase 3 ok: mgard-progressive {MGARD_CMP_EDGE}^3: the cuda and torch backends' "
        f"containers are byte-identical ({len(plain.to_bytes())} bytes; the CPU encode took "
        f"{plain_s:.1f} s)")
    return {"field": field, "c": c, "out": dec, "stream": stream, "bounds": bounds,
            "path": path, "tmp": tmp, "calls": calls, "errs": kerr}


def qwen_tree(device) -> dict:
    """The float32 parameters of qwen2.5-3b's embedding and first
    ``QWEN_LAYERS`` decoder layers (hf:Qwen/Qwen2.5-3B: d_model 2048, 16 heads of 128, 2 KV
    heads, d_ff 11008, vocab 151936, QKV bias), every matrix stored as
    (in, out), every weight N(0, 0.02^2) from the seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 30)

    def w(*shape):
        return torch.randn(shape, generator=g, device=device) * 0.02

    d, kv, ff = QWEN["d_model"], QWEN["kv_dim"], QWEN["d_ff"]
    return {"embed": w(QWEN["vocab"], d), "layers": [
        {"wq": w(d, d), "wk": w(d, kv), "wv": w(d, kv), "wo": w(d, d),
         "bq": w(d), "bk": w(kv), "bv": w(kv), "attn_norm": w(d), "mlp_norm": w(d),
         "w_gate": w(d, ff), "w_up": w(d, ff), "w_down": w(ff, d)} for _ in range(QWEN_LAYERS)]}


def mixed_select(api):
    """The per-leaf futures path's select: the norms to ``huffman-bytes``,
    the ``wo`` matrices to ``mgard-progressive``, the rest the default."""

    def select(key, arr):
        if key.endswith("_norm"):
            return "huffman-bytes", {}
        if key.endswith("/wo"):
            return "mgard-progressive", {}
        return api.default_select(key, arr)

    return select


def phase_pytree(device, api) -> dict:
    """Phase 3, the pytree entry points: ``compress_pytree`` of the qwen2.5-3b
    embedding and 4 layers (about 620M float32 parameters) under
    ``default_select``, then ``decompress_pytree``, each counted; every
    container against that leaf's ``compress_leaf`` on the card and every
    decoded leaf against ``decompress_leaf``, byte for byte; the stacked
    kernels against their plain versions on one bucket's inputs; layer 0's
    containers against the ``torch`` backend's; then the mixed select
    (norms to ``huffman-bytes``, ``wo`` to ``mgard-progressive``) through
    the per-leaf futures path."""
    import torch

    from repro_torch.core import engine as engine_mod
    from repro_torch.core import zfp
    from repro_torch.core.container import Compressed

    tree = qwen_tree(device)
    leaves = dict(api.flatten_with_keys(tree))
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    eng = engine_mod.default_engine()
    torch.cuda.synchronize()
    reset_counts()
    flat, stats = api.compress_pytree(tree)
    torch.cuda.synchronize()
    enc_counts = read_counts()
    reset_counts()
    out = api.decompress_pytree(flat, tree)
    torch.cuda.synchronize()
    dec_counts = read_counts()
    zkeys = [k for k, v in flat.items() if isinstance(v, Compressed)]
    shapes = {}
    for k in zkeys:
        shapes.setdefault(tuple(flat[k].meta["shape"]), []).append(k)
    check_counts("compress_pytree", enc_counts, {"zfp_block.compress_blocks": len(shapes)})
    check_counts("decompress_pytree", dec_counts, {"zfp_block.decompress_blocks": len(shapes)})
    stacked = sum(len(ks) for ks in shapes.values() if len(ks) > 1)
    if stats["sharded_leaves"] != stacked or stats["buckets"] != len(shapes):
        raise PhaseError(f"compress_pytree stats {stats}: expected {len(shapes)} buckets, "
                         f"{stacked} stacked leaves")
    outs = dict(api.flatten_with_keys(out))
    worst = 0.0
    for k, x in leaves.items():
        got = outs[k]
        if got.device != device or got.dtype != x.dtype or got.shape != x.shape:
            raise PhaseError(f"pytree leaf {k}: decoded {got.device} {got.dtype} {tuple(got.shape)}")
        if k not in zkeys:
            if not same_bits(got, x):
                raise PhaseError(f"pytree leaf {k}: a raw leaf changed")
            continue
        if api.compress_leaf(x, "zfp", rate=RATE).to_bytes() != flat[k].to_bytes():
            raise PhaseError(f"pytree leaf {k}: container differs from compress_leaf's")
        if not same_bits(got, api.decompress_leaf(flat[k])):
            raise PhaseError(f"pytree leaf {k}: decoded differs from decompress_leaf's")
        worst = max(worst, float((got - x).abs().max()) / float(x.max() - x.min()))
    if not worst <= ERR_TOL:
        raise PhaseError(f"pytree: max |error| {worst:.3e} of a leaf's range")
    log(f"phase 3 launches on the pytree path: compress_pytree "
        f"{ {k: n for k, n in enc_counts.items() if n} }, decompress_pytree "
        f"{ {k: n for k, n in dec_counts.items() if n} }")
    log(f"phase 3 ok: pytree qwen2.5-3b embed + {QWEN_LAYERS} layers: {len(leaves)} leaves, "
        f"{nbytes} bytes, {len(zkeys)} compressed in {len(shapes)} buckets "
        f"({sorted(len(ks) for ks in shapes.values())} leaves), ratio {stats['ratio']:.6f}, "
        f"max |error| {worst:.3e} of a leaf's range; every container == compress_leaf's and "
        f"every leaf == decompress_leaf's (bytes), raw leaves unchanged; engine {eng.stats()}")

    # the stacked kernels against their plain versions on one bucket's inputs
    shape, keys = min(((s, ks) for s, ks in shapes.items() if len(ks) > 1),
                      key=lambda item: math.prod(item[0]))
    xs = torch.stack([api.as_blocked_3d(leaves[k]) for k in keys])
    tables = api.get_plan(api.make_spec(xs[0], "zfp", rate=RATE)).workspace
    enc = {a: zfp.compress_stacked(xs, RATE, 3, shape, a, perm=tables["perm"],
                                   scale=tables["enc_scale"]) for a in ("cuda", "torch")}
    decs = {a: zfp.decompress_stacked(*enc["cuda"], RATE, 3, shape, a, perm=tables["perm"],
                                      scale=tables["dec_scale"]) for a in ("cuda", "torch")}
    zerr = {"zfp_block.compress_blocks": max(int_err(enc["cuda"][0], enc["torch"][0]),
                                             int_err(enc["cuda"][1], enc["torch"][1])),
            "zfp_block.decompress_blocks": max_abs_err(decs["cuda"], decs["torch"])}
    if any(zerr.values()):
        raise PhaseError(f"pytree bucket {shape} x {len(keys)}: kernels differ from plain: {zerr}")
    log(f"phase 3 ok: pytree bucket of {len(keys)} x {shape}: the stacked compress_blocks / "
        "decompress_blocks == plain versions (tolerance 0)")

    layer0 = {"layers": [{k: v.cpu() for k, v in tree["layers"][0].items()}]}
    t0 = time.perf_counter()
    with engine_mod.ExecutionEngine([torch.device("cpu")], backend="torch") as cpu_eng:
        cflat, _ = cpu_eng.compress_pytree(layer0)
    cpu_s = time.perf_counter() - t0
    for k, v in cflat.items():
        if isinstance(v, Compressed) != isinstance(flat[k], Compressed) or (
                isinstance(v, Compressed) and v.to_bytes() != flat[k].to_bytes()):
            raise PhaseError(f"pytree layer 0 {k}: the cuda and torch backends differ")
    log(f"phase 3 ok: pytree layer 0 ({len(cflat)} leaves): containers == the torch backend's "
        f"(its CPU engine took {cpu_s:.1f} s)")

    select = mixed_select(api)
    torch.cuda.synchronize()
    reset_counts()
    mflat, mstats = api.compress_pytree(tree, select)
    torch.cuda.synchronize()
    menc = read_counts()
    reset_counts()
    mout = dict(api.flatten_with_keys(api.decompress_pytree(mflat, tree)))
    torch.cuda.synchronize()
    mdec = read_counts()
    wo = [k for k in leaves if k.endswith("/wo")]
    norms = [k for k in leaves if k.endswith("_norm")]
    mshapes = {tuple(v.meta["shape"]) for k, v in mflat.items()
               if isinstance(v, Compressed) and v.method == "zfp"}
    tiers, solves = PROG_TIERS, mgard_solves(tuple(leaves[wo[0]].shape))
    check_counts("compress_pytree (mixed select)", menc, {
        "zfp_block.compress_blocks": len(mshapes),
        "histogram.histogram": len(norms) + tiers * len(wo),
        "huffman_encode.encode_lookup": len(norms) + tiers * len(wo),
        "quantize_map.quantize": tiers * len(wo), "quantize_map.dequantize": tiers * len(wo),
        "tridiag.solve_mass": solves * len(wo)})
    check_counts("decompress_pytree (mixed select)", mdec, {
        "zfp_block.decompress_blocks": len(mshapes),
        "huffman_decode.decode_chunks": len(norms) + tiers * len(wo),
        "quantize_map.dequantize": tiers * len(wo), "tridiag.solve_mass": solves * len(wo)})
    for k in norms + wo:
        c = mflat[k]
        method = "huffman-bytes" if k in norms else "mgard-progressive"
        if c.method != method or c.to_bytes() != api.compress_leaf(leaves[k], method).to_bytes():
            raise PhaseError(f"mixed pytree {k}: container differs from compress_leaf's")
        if k in norms and not same_bits(mout[k], leaves[k]):
            raise PhaseError(f"mixed pytree {k}: the norm's round trip is not exact")
        if k in wo:
            err = float((mout[k] - leaves[k]).abs().max())
            if not err <= c.meta["tier_bounds"][-1]:
                raise PhaseError(f"mixed pytree {k}: max |error| {err:.6e} > the bound")
    log(f"phase 3 launches on the pytree path (mixed select): compress_pytree "
        f"{ {k: n for k, n in menc.items() if n} }, decompress_pytree "
        f"{ {k: n for k, n in mdec.items() if n} }")
    log(f"phase 3 ok: pytree mixed select: {len(norms)} norms through huffman-bytes (one "
        f"bucket, exact), {len(wo)} wo through mgard-progressive (per-leaf futures, within "
        f"the bound), every container == compress_leaf's; stats {mstats}")
    calls = {"compress_pytree": enc_counts, "decompress_pytree": dec_counts,
             "compress_pytree (mixed)": menc, "decompress_pytree (mixed)": mdec}
    return {"tree": tree, "leaves": leaves, "flat": flat, "out": out, "zkeys": zkeys,
            "nbytes": nbytes, "calls": calls, "errs": zerr, "mflat": mflat}


# ---------------------------------------------------------------------------
# the chunk-pipelined stream and the checkpoint manager
# ---------------------------------------------------------------------------


def counted(what: str, fn, want):
    """``fn()`` with every counter zeroed just before and read just after;
    the launches must be ``want`` (or ``want(result)``)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(what, counts, want(out) if callable(want) else want)
    return out, counts


def run_stream(api, what: str, data, want, **kw):
    """One counted ``CompressorStream.compress`` of ``data``."""
    stream = api.CompressorStream(**kw)
    res, counts = counted(what, lambda: stream.compress(data), want)
    if res.max_in_flight > res.window:
        raise PhaseError(f"{what}: {res.max_in_flight} chunks in flight at window {res.window}")
    return stream, res, counts


def check_chunks_one_shot(api, what: str, res, x, method: str, **params) -> None:
    """Every chunk of a stream == the one-shot ``api.compress`` of its rows."""
    ends = res.boundaries[1:] + [x.shape[res.axis]]
    for i, (b, e) in enumerate(zip(res.boundaries, ends)):
        one = api.compress(x.narrow(res.axis, b, e - b), method, **params)
        if one.to_bytes() != res.chunks[i].to_bytes():
            raise PhaseError(f"{what}: chunk {i} differs from the one-shot api.compress")


def phase_stream(device, api, field, mgard_field) -> dict:
    """Phase 3, the stream: the 512^3 field from pageable host memory through
    ``CompressorStream("zfp", rate=16, mode="fixed", c_fixed_elems=8 << 20)``
    (16 chunks of 32 planes) at windows 1, 2 and 3, 128 chunks at windows 1
    and 3 (a chunk read before its staging copy completed would change the
    bytes), the 4096x4096 weight leaf through ``huffman-bytes`` (4 chunks)
    and the 513^3 MGARD field (nine (57, 513, 513) chunks) at window 2, and
    the auto plan from a cold calibration; every run's launches exact."""
    import tempfile

    import torch

    from repro_torch.core import mgard
    from repro_torch.runtime import calibrate

    calls, errs = {}, {}
    host = field.cpu()              # pageable host memory, as a caller's array holds it
    planes = FIELD_EDGE * FIELD_EDGE
    n = host.numel() // STREAM_CHUNK
    zfp_runs, blobs = {}, {}
    for w in STREAM_WINDOWS:
        what = f"zfp stream (window {w})"
        _s, res, calls[what] = run_stream(
            api, what, host, lambda r: {"zfp_block.compress_blocks": n}, method="zfp",
            rate=RATE, mode="fixed", c_fixed_elems=STREAM_CHUNK, window=w)
        if len(res.chunks) != n or res.window != w or res.axis != 0:
            raise PhaseError(f"{what}: {len(res.chunks)} chunks on axis {res.axis} at window "
                             f"{res.window}")
        zfp_runs[w], blobs[w] = res, api.CompressorStream.to_bytes(res)
    if len(set(blobs.values())) != 1:
        raise PhaseError("zfp stream: to_bytes differs between windows 1, 2 and 3")
    res = zfp_runs[2]
    check_chunks_one_shot(api, "zfp stream", res, field, "zfp", rate=RATE)
    rows = STREAM_CHUNK // planes
    t0 = time.perf_counter()
    plain = api.compress(host[:rows], "zfp", rate=RATE, backend="torch")
    plain_s = time.perf_counter() - t0
    if plain.to_bytes() != res.chunks[0].to_bytes():
        raise PhaseError("zfp stream: chunk 0 differs from the torch backend's")
    out, calls["zfp stream decompress"] = counted(
        "zfp stream decompress", lambda: api.CompressorStream.decompress(res),
        {"zfp_block.decompress_blocks": n})
    chunkwise = torch.cat([api.decompress(c) for c in res.chunks])
    if not same_bits(out, chunkwise):
        raise PhaseError("zfp stream: decode differs from the chunk-wise api.decompress")
    if not same_bits(out[:rows], api.decompress(plain, backend="torch")):
        raise PhaseError("zfp stream: chunk 0 decodes differently from the torch backend")
    errs["zfp_block.compress_blocks"] = errs["zfp_block.decompress_blocks"] = 0.0
    err = float((out - field).abs().max()) / float(field.max() - field.min())
    if not err <= ERR_TOL:
        raise PhaseError(f"zfp stream: max |error| {err:.3e} of the range")
    again = api.CompressorStream.decompress(api.CompressorStream.from_bytes(blobs[2]))
    if not same_bits(again, out):
        raise PhaseError("zfp stream: decode of to_bytes/from_bytes differs")
    log(f"phase 3 ok: zfp stream {FIELD_EDGE}^3 from host memory, {n} chunks of {rows} planes: "
        f"to_bytes identical at windows {STREAM_WINDOWS} (max in flight "
        f"{[zfp_runs[w].max_in_flight for w in STREAM_WINDOWS]}), every chunk == one-shot "
        f"api.compress, chunk 0 == torch backend's bytes (CPU encode {plain_s:.1f} s), decode == "
        f"chunk-wise api.decompress and to_bytes/from_bytes, max |error| {err:.3e} of the range")

    race = {}
    nr = host.numel() // RACE_CHUNK
    for w in (1, 3):
        what = f"zfp stream {nr} chunks (window {w})"
        _s, r, calls[what] = run_stream(
            api, what, host, lambda r: {"zfp_block.compress_blocks": nr}, method="zfp",
            rate=RATE, mode="fixed", c_fixed_elems=RACE_CHUNK, window=w)
        race[w] = api.CompressorStream.to_bytes(r)
    if race[1] != race[3]:
        raise PhaseError(f"zfp stream of {nr} chunks: window 3 bytes differ from window 1's "
                         "(a chunk computed before its staging copy completed?)")
    log(f"phase 3 ok: zfp stream of {nr} chunks of {RACE_CHUNK // planes} planes: window 3 "
        "bytes == window 1 bytes")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "stream.hpds"
        directory = api.CompressorStream.to_file(res, path)
        with count_file_reads() as seen:
            back = api.CompressorStream.from_file(path)
            first = back.chunks[0]
        ok = (back.chunks.reader.preads == 1 and back.chunks.materialized == 1
              and first.to_bytes() == res.chunks[0].to_bytes())
        back.chunks.reader.close()
        if not ok:
            raise PhaseError(f"zfp stream file: chunk 0 took {back.chunks.reader.preads} "
                             "segment preads or differs")
        log(f"phase 3 ok: zfp stream to_file ({path.stat().st_size} bytes, "
            f"{len(directory['segments'])} segments) -> from_file -> chunk 0 read with one "
            f"segment pread ({seen['calls']} preads and {seen['bytes']} bytes in all, the "
            "trailer and directory included)")

    g = torch.Generator(device=device).manual_seed(SEED + 40)
    leaf = torch.randn(HUFF_LEAF_SHAPE, generator=g, device=device) * 0.02
    hk = leaf.numel() // HUFF_STREAM_CHUNK
    hb = {}
    for w in (1, 2):
        what = f"huffman-bytes stream (window {w})"
        _s, hres, calls[what] = run_stream(
            api, what, leaf.cpu(), lambda r: {"histogram.histogram": hk,
                                              "huffman_encode.encode_lookup": hk},
            method="huffman-bytes", mode="fixed", c_fixed_elems=HUFF_STREAM_CHUNK, window=w)
        hb[w] = api.CompressorStream.to_bytes(hres)
    if hb[1] != hb[2]:
        raise PhaseError("huffman-bytes stream: to_bytes differs between windows 1 and 2")
    check_chunks_one_shot(api, "huffman-bytes stream", hres, leaf, "huffman-bytes")
    hout, calls["huffman-bytes stream decompress"] = counted(
        "huffman-bytes stream decompress", lambda: api.CompressorStream.decompress(hres),
        {"huffman_decode.decode_chunks": hk})
    if not same_bits(hout, leaf) or not same_bits(
            hout, torch.cat([api.decompress(c) for c in hres.chunks])):
        raise PhaseError("huffman-bytes stream: the round trip is not exact")
    log(f"phase 3 ok: huffman-bytes stream {HUFF_LEAF_SHAPE} float32 weights, {hk} chunks: "
        f"to_bytes identical at windows 1 and 2, every chunk == one-shot api.compress, exact "
        f"round trip, ratio {hres.ratio():.6f}")

    mhost = mgard_field.cpu()
    edge = mgard_field.shape[1]
    mk = mgard_field.shape[0] // MGARD_STREAM_ROWS
    solves = mgard_solves((MGARD_STREAM_ROWS, edge, edge))
    what = "mgard stream (window 2)"
    _s, mres, calls[what] = run_stream(
        api, what, mhost, lambda r: {
            "quantize_map.quantize": mk, "histogram.histogram": mk,
            "huffman_encode.encode_lookup": mk, "tridiag.solve_mass": mk * solves},
        method="mgard", mode="fixed", c_fixed_elems=MGARD_STREAM_ROWS * edge * edge, window=2)
    if len(mres.chunks) != mk:
        raise PhaseError(f"mgard stream: {len(mres.chunks)} chunks, expected {mk}")
    check_chunks_one_shot(api, "mgard stream", mres, mgard_field, "mgard")
    mout, calls["mgard stream decompress"] = counted(
        "mgard stream decompress", lambda: api.CompressorStream.decompress(mres),
        {"quantize_map.dequantize": mk, "huffman_decode.decode_chunks": mk,
         "tridiag.solve_mass": mk * solves})
    worst = 0.0
    for i, b in enumerate(mres.boundaries):
        sl = slice(b, b + MGARD_STREAM_ROWS)
        e = float((mout[sl] - mgard_field[sl]).abs().max())
        if not e <= mres.chunks[i].meta["error_bound"]:
            raise PhaseError(f"mgard stream chunk {i}: max |error| {e:.6e} > its bound")
        worst = max(worst, e / mres.chunks[i].meta["error_bound"])
    log(f"phase 3 ok: mgard stream {tuple(mgard_field.shape)}, {mk} chunks of "
        f"{MGARD_STREAM_ROWS} planes ({solves} solves each way a chunk): every chunk == one-shot "
        f"api.compress, within its bound (worst {worst:.4f} of it), ratio {mres.ratio():.6f}")

    sweeps0 = calibrate.SWEEPS_RUN
    t0 = time.perf_counter()
    mc = calibrate.get_method_calibration("zfp", "float32", params={"rate": RATE})
    cal_s = time.perf_counter() - t0
    sweeps_cold = calibrate.SWEEPS_RUN - sweeps0
    auto = {}
    for run in (1, 2):
        sweeps_before = calibrate.SWEEPS_RUN
        what = f"zfp stream auto (run {run})"
        astream, ares, calls[what] = run_stream(
            api, what, host, lambda r: {"zfp_block.compress_blocks": len(r.chunks)},
            method="zfp", rate=RATE, chunk_size="auto", window="auto")
        if ares.tuned is None or ares.tuned["source"] != "calibrated":
            raise PhaseError(f"{what}: the plan is {ares.tuned}, not a calibrated one")
        if calibrate.SWEEPS_RUN != sweeps_before:
            raise PhaseError(f"{what}: SWEEPS_RUN grew {sweeps_before} -> {calibrate.SWEEPS_RUN}")
        auto[run] = (ares, sweeps_before)
    ares = auto[1][0]
    explicit = api.CompressorStream("zfp", rate=RATE, mode="fixed",
                                    c_fixed_elems=ares.tuned["chunk_elems"],
                                    window=ares.tuned["window"]).compress(host)
    if api.CompressorStream.to_bytes(ares) != api.CompressorStream.to_bytes(explicit):
        raise PhaseError("zfp stream auto: bytes differ from the explicit stream of its plan")
    log(f"phase 3 ok: zfp stream auto from a cold calibration ({cal_s:.3f} s, {sweeps_cold} "
        f"sweeps; phi gamma {mc.phi.gamma / 1e9:.3f} GB/s, h2d {mc.h2d.bps / 1e9:.3f} GB/s + "
        f"{mc.h2d.t0 * 1e6:.1f} us, serialize {mc.serialize.bps / 1e9:.3f} GB/s + "
        f"{mc.serialize.t0 * 1e6:.1f} us, window overhead "
        f"{calibrate.window_overhead_s() * 1e6:.1f} us): "
        + "; ".join(f"run {k}: plan chunk_elems {r.tuned['chunk_elems']}, window "
                    f"{r.tuned['window']}, {len(r.chunks)} chunks, source {r.tuned['source']}, "
                    f"predicted {r.tuned['predicted_s'] * 1e3:.3f} ms, measured "
                    f"{r.wall_time * 1e3:.3f} ms, SWEEPS_RUN {s} -> {calibrate.SWEEPS_RUN}"
                    for k, (r, s) in auto.items())
        + "; bytes == the explicit stream of the plan")
    return {"host": host, "res": res, "calls": calls, "errs": errs, "auto_stream": astream,
            "hleaf": leaf.cpu(), "mhost": mhost}


def pinned_copy_rates(device, nbytes: int) -> tuple[float, float]:
    """GB/s of one ``nbytes`` copy between page-locked host memory and the
    card, each way (CUDA events, median of 10)."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    h2d = median_ms(lambda: dev.copy_(host, non_blocking=True))
    d2h = median_ms(lambda: host.copy_(dev, non_blocking=True))
    return nbytes / h2d / 1e6, nbytes / d2h / 1e6


def phase_stream_timings(api, st: dict, card: str, device) -> None:
    """Phase 5 for the stream: host wall (synchronised, median of 5) of each
    window and the auto plan beside the one-shot ``api.compress`` of the same
    host field; the last run's lane seconds, overlap and staging rates."""
    import torch

    host, runs = st["host"], NEW_TIMED_RUNS
    nbytes = host.numel() * host.element_size()
    wall = {"one-shot api.compress": median_wall_ms(
        lambda: api.compress(host, "zfp", rate=RATE), runs=runs, warmup=1)}
    last = {}
    for w in STREAM_WINDOWS:
        stream = api.CompressorStream("zfp", rate=RATE, mode="fixed", c_fixed_elems=STREAM_CHUNK,
                                      window=w)
        wall[f"stream window {w}"] = median_wall_ms(
            lambda: last.__setitem__(w, stream.compress(host)), runs=runs, warmup=1)
    auto = st["auto_stream"]
    wall["stream auto"] = median_wall_ms(lambda: last.__setitem__("auto", auto.compress(host)),
                                         runs=runs, warmup=1)
    log(f"phase 5 [{card}] zfp stream {FIELD_EDGE}^3 from host memory (host wall, synchronised, "
        f"median of {runs}): " + ", ".join(
            f"{k} {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s of the field)" for k, v in wall.items()))
    for k, r in last.items():
        lanes = r.lane_seconds()
        staged = sum(t.nbytes for t in r.timings)
        log(f"phase 5 [{card}] zfp stream {k}: window {r.window}, {len(r.chunks)} chunks, wall "
            f"{r.wall_time * 1e3:.3f} ms, lane_seconds " + ", ".join(
                f"{n} {s * 1e3:.3f} ms" for n, s in lanes.items())
            + f", overlap_efficiency {r.overlap_efficiency():.4f}, staging H2D "
            f"{staged / lanes['h2d'] / 1e9:.3f} GB/s, io lane {r.nbytes() / lanes['serialize'] / 1e9:.3f}"
            " GB/s of compressed bytes (fetch into page-locked memory + container)"
            + (f", plan {r.tuned}" if r.tuned else ""))
    for size in (STREAM_CHUNK * 4, STREAM_CHUNK * 2):
        h2d, d2h = pinned_copy_rates(device, size)
        log(f"phase 5 [{card}] page-locked copies of {size} bytes (events, median of 10): "
            f"H2D {h2d:.3f} GB/s, D2H {d2h:.3f} GB/s")
    torch.cuda.synchronize()


def fs_type(path) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", str(path)], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or "unknown"


def write_probe_gbps(directory: Path, nbytes: int) -> float:
    """GB/s of writing ``nbytes`` to a file in ``directory`` in 64 MiB pieces
    (the machine's disk and page cache; no card involved)."""
    import os

    piece = b"\0" * (64 << 20)
    path = directory / "write_probe.bin"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(max(1, nbytes // len(piece))):
            f.write(piece)
    s = time.perf_counter() - t0
    written = path.stat().st_size
    os.unlink(path)
    return written / s / 1e9


def stream_rows(leaf, tuned: dict, device) -> tuple[int, list[int]]:
    """The axis and the row counts the stream cuts ``leaf`` into under the
    plan ``tuned``."""
    from repro_torch.core import pipeline as pl

    axis = max(range(leaf.ndim), key=lambda a: leaf.shape[a])
    pipe = pl.ChunkedPipeline(compute_fn=None, finish_fn=None, mode="fixed",
                              c_fixed_elems=tuned["chunk_elems"], devices=[device])
    return axis, pipe._row_schedule(leaf, axis)


def streamed_decode(api, leaf, tuned: dict, device, rate: int):
    """``leaf`` cut as the stream cuts it, each chunk through the one-shot
    ``api.compress``/``decompress``, concatenated (the stream's decode)."""
    import torch

    axis, rows = stream_rows(leaf, tuned, device)
    parts, start = [], 0
    for r in rows:
        parts.append(api.decompress(api.compress(leaf.narrow(axis, start, r), "zfp", rate=rate)))
        start += r
    return torch.cat(parts, dim=axis)


def phase_checkpoint(device, api, tree, card: str) -> dict:
    """Phase 3, the checkpoint manager: ``CheckpointManager.save`` of the
    pytree phase's qwen2.5-3b tree with the default policy (zfp rate 28,
    stream threshold 8 MiB, lossless below 16384 elements), its routing and
    launches checked exactly; ``restore`` flat and with ``target``;
    ``save_async`` + ``wait``; a partial restore; and a
    ``mgard-progressive`` policy on the four ``wo`` leaves, whose
    ``restore(max_error=<tier-2 bound>)`` reads fewer bytes than a full one."""
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
    from repro_torch.runtime import calibrate
    from repro_torch.runtime.io import AggregatedReader

    policy = CheckpointPolicy()
    leaves = dict(api.flatten_with_keys(tree, "::"))
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    big = {k for k, x in leaves.items() if x.numel() * x.element_size() >= policy.stream_threshold}
    zfp1 = {k for k, x in leaves.items() if k not in big and x.numel() >= policy.lossless_small}
    exact = set(leaves) - big - zfp1
    if (len(big), len(zfp1), len(exact)) != CKPT_ROUTING:
        raise PhaseError(f"checkpoint tree: {len(big)}/{len(zfp1)}/{len(exact)} leaves to stream"
                         f"/zfp/huffman-bytes, expected {CKPT_ROUTING}")
    calls, out = {}, {}
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    try:
        mgr = CheckpointManager(root / "ckpt", policy)
        sweeps = calibrate.SWEEPS_RUN
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        manifest = mgr.save(1, tree)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        counts = calls["CheckpointManager.save"] = read_counts()
        entries = manifest["leaves"]
        streamed = {k for k, e in entries.items() if e.get("stream")}
        if streamed != big or calibrate.SWEEPS_RUN != sweeps:
            raise PhaseError(f"checkpoint: streamed {sorted(streamed)}, expected {sorted(big)} "
                             f"(SWEEPS_RUN {sweeps} -> {calibrate.SWEEPS_RUN})")
        if any(entries[k]["tuned"]["source"] != "calibrated" for k in streamed):
            raise PhaseError("checkpoint: a streamed leaf's plan is not calibrated")
        methods = {}
        with AggregatedReader(root / "ckpt" / "step_00000001" / "leaves.hpdr") as r:
            for k in zfp1 | exact:
                methods[k] = api.Compressed.from_bytes(r.read(entries[k]["segment"])).method
        if any(methods[k] != "zfp" for k in zfp1) or any(
                methods[k] != "huffman-bytes" for k in exact):
            raise PhaseError(f"checkpoint: one-shot leaves routed {methods}")
        chunks = {k: len(stream_rows(leaves[k], entries[k]["tuned"], device)[1]) for k in big}
        n_chunks = sum(chunks.values())
        check_counts("CheckpointManager.save", counts, {
            "zfp_block.compress_blocks": n_chunks + len(zfp1),
            "histogram.histogram": len(exact), "huffman_encode.encode_lookup": len(exact)})
        log(f"phase 3 ok: checkpoint routing: {len(big)} streamed leaves ({n_chunks} chunks in "
            f"all; embed {chunks['embed']}), {len(zfp1)} one-shot zfp leaves, {len(exact)} "
            f"huffman-bytes leaves; launches {({k: v for k, v in counts.items() if v})}")

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        flat, _ = mgr.restore(1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rcounts = calls["CheckpointManager.restore"] = read_counts()
        check_counts("CheckpointManager.restore", rcounts, {
            "zfp_block.decompress_blocks": n_chunks + len(zfp1),
            "huffman_decode.decode_chunks": len(exact)})
        worst = 0.0
        for k, x in leaves.items():
            got = flat[k]
            if got.device != device or got.dtype != x.dtype or got.shape != x.shape:
                raise PhaseError(f"checkpoint leaf {k}: restored {got.device} {got.dtype} "
                                 f"{tuple(got.shape)}")
            if k in exact:
                want = x
            elif k in zfp1:
                want = api.decompress_leaf(api.compress_leaf(x, "zfp", rate=policy.zfp_rate))
            else:
                want = streamed_decode(api, x, entries[k]["tuned"], device, policy.zfp_rate)
            if not same_bits(got, want):
                raise PhaseError(f"checkpoint leaf {k}: restored values differ from the decode "
                                 "of the same containers")
            if k not in exact:
                worst = max(worst, float((got - x).abs().max()) / float(x.max() - x.min()))
        if not worst <= ERR_TOL:
            raise PhaseError(f"checkpoint: max |error| {worst:.3e} of a leaf's range")
        t0 = time.perf_counter()
        target, _ = mgr.restore(1, target=tree)
        torch.cuda.synchronize()
        target_s = time.perf_counter() - t0
        if any(not same_bits(v, flat[k]) for k, v in api.flatten_with_keys(target, "::")):
            raise PhaseError("checkpoint: restore(target=) differs from the flat restore")
        log(f"phase 3 ok: checkpoint restore: every leaf on the card with its dtype and shape, "
            f"huffman-bytes leaves bit-exact, zfp leaves == the one-shot decode of the same "
            f"chunks (max |error| {worst:.3e} of a leaf's range), restore(target=) == flat")

        sel = ["layers::0::wk", "layers::0::bq"]
        with count_file_reads() as seen:
            part, _ = mgr.restore(1, leaves=sel)
        io = mgr.last_restore_io
        want_bytes = sum(entries[k]["bytes"] for k in sel)
        if sorted(part) != sorted(sel) or io["local_preads"] != 2 or \
                io["local_bytes"] != want_bytes:
            raise PhaseError(f"checkpoint: restore(leaves={sel}) read {io}")
        log(f"phase 3 ok: checkpoint restore(leaves={sel}): 2 segment preads of {want_bytes} "
            f"bytes ({seen['calls']} preads, {seen['bytes']} bytes with the trailer and "
            "directory)")

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sub = mgr.save_async(2, tree)
        submit_s = time.perf_counter() - t0
        m2 = mgr.wait()
        torch.cuda.synchronize()
        async_s = time.perf_counter() - t0
        acounts = calls["CheckpointManager.save_async"] = read_counts()
        e2 = m2["leaves"]
        n2 = sum(len(stream_rows(leaves[k], e2[k]["tuned"], device)[1]) for k in big)
        check_counts("CheckpointManager.save_async", acounts, {
            "zfp_block.compress_blocks": n2 + len(zfp1),
            "histogram.histogram": len(exact), "huffman_encode.encode_lookup": len(exact)})
        if sub.result()["step"] != 2 or mgr.latest_step() != 2 or any(
                e2[k]["bytes"] != entries[k]["bytes"] for k in zfp1 | exact):
            raise PhaseError("checkpoint: save_async wrote another checkpoint")
        log(f"phase 3 ok: checkpoint save_async(2) + wait: one-shot leaves' bytes == save(1)'s, "
            f"latest_step 2")

        wo = {"layers": [{"wo": layer["wo"]} for layer in tree["layers"]]}
        pm = CheckpointManager(root / "prog", CheckpointPolicy(float_method="mgard-progressive"))
        solves = mgard_solves(tuple(tree["layers"][0]["wo"].shape))
        nwo, tiers = len(tree["layers"]), policy.progressive_tiers
        pman, calls["CheckpointManager.save (mgard-progressive)"] = counted(
            "CheckpointManager.save (mgard-progressive)", lambda: pm.save(1, wo), {
                "quantize_map.quantize": tiers * nwo, "quantize_map.dequantize": tiers * nwo,
                "histogram.histogram": tiers * nwo, "huffman_encode.encode_lookup": tiers * nwo,
                "tridiag.solve_mass": solves * nwo})
        (full, _), calls["CheckpointManager.restore (mgard-progressive)"] = counted(
            "CheckpointManager.restore (mgard-progressive)", lambda: pm.restore(1), {
                "huffman_decode.decode_chunks": tiers * nwo,
                "quantize_map.dequantize": tiers * nwo, "tridiag.solve_mass": solves * nwo})
        full_io = dict(pm.last_restore_io)
        bound = max(e["progressive"]["tier_bounds"][1] for e in pman["leaves"].values())
        (coarse, _), calls["CheckpointManager.restore (max_error)"] = counted(
            "CheckpointManager.restore (max_error)", lambda: pm.restore(1, max_error=bound), {
                "huffman_decode.decode_chunks": 2 * nwo,
                "quantize_map.dequantize": 2 * nwo, "tridiag.solve_mass": solves * nwo})
        cio = pm.last_restore_io
        if not (cio["local_preads"] == 2 * nwo and full_io["local_preads"] == tiers * nwo
                and cio["local_bytes"] < full_io["local_bytes"]):
            raise PhaseError(f"checkpoint restore(max_error=): read {cio}, full read {full_io}")
        for k, e in pman["leaves"].items():
            x = leaves[k]
            for got, b in ((full[k], e["progressive"]["tier_bounds"][-1]), (coarse[k], bound)):
                err = float((got - x).abs().max())
                if not err <= b:
                    raise PhaseError(f"checkpoint progressive {k}: max |error| {err:.3e} > {b:.3e}")
        log(f"phase 3 ok: checkpoint mgard-progressive on {nwo} wo leaves: restore(max_error="
            f"{bound:.3e}) read {cio['local_preads']} segments / {cio['local_bytes']} bytes, the "
            f"full restore {full_io['local_preads']} / {full_io['local_bytes']}; every leaf within "
            "its tier's bound")

        files = sum(p.stat().st_size for p in (root / "ckpt" / "step_00000001").iterdir())
        disk = write_probe_gbps(root, files)
        log(f"phase 5 [{card}] checkpoint of qwen2.5-3b embed + {QWEN_LAYERS} layers ({nbytes} "
            f"bytes on the card, {len(leaves)} leaves) to {fs_type(root)} (host wall, one run "
            f"each): save {save_s * 1e3:.1f} ms ({nbytes / save_s / 1e9:.3f} GB/s of the tree; "
            f"{files} bytes written, ratio {manifest['ratio']:.6f}), restore "
            f"{restore_s * 1e3:.1f} ms ({nbytes / restore_s / 1e9:.3f} GB/s), restore(target=) "
            f"{target_s * 1e3:.1f} ms, save_async {submit_s * 1e3:.1f} ms to return and "
            f"{async_s * 1e3:.1f} ms to wait(); the machine's disk (not the card): a plain "
            f"write of {files} bytes there {disk:.3f} GB/s")
    finally:
        tmp.cleanup()
    return {"calls": calls, "errs": {}}



def phase_new_round_trips(api, prog: dict, pyt: dict) -> None:
    """Phase 4 for the new paths: the progressive container and the
    pytree's containers through ``to_bytes``/``from_bytes``."""
    from repro_torch.core.container import Compressed

    phase_bytes_round_trip(api, prog["c"], prog["out"])
    carried = {k: Compressed.from_bytes(v.to_bytes()) if isinstance(v, Compressed) else v
               for k, v in pyt["flat"].items()}
    again = dict(api.flatten_with_keys(api.decompress_pytree(carried, pyt["tree"])))
    direct = dict(api.flatten_with_keys(pyt["out"]))
    if any(not same_bits(again[k], direct[k]) for k in direct):
        raise PhaseError("pytree: decode of to_bytes/from_bytes differs from the direct decode")
    log(f"phase 4 ok: pytree: {len(pyt['zkeys'])} containers -> to_bytes -> from_bytes -> "
        "decompress_pytree on the card is bit-identical")


def phase_new_timings(api, prog: dict, pyt: dict, card: str) -> None:
    """Phase 5 for the new paths: host wall times, synchronised (median of 5):
    refactor and its stages, each retrieve tier, refine, compress_pytree and
    decompress_pytree beside serial compress_leaf / decompress_leaf over the
    same leaves."""
    import torch

    from repro_torch.core import progressive

    field, stream, bounds = prog["field"], prog["stream"], prog["bounds"]
    runs = NEW_TIMED_RUNS
    wall = {"progressive.refactor": median_wall_ms(
        lambda: progressive.refactor(field, bounds[-1], tiers=PROG_TIERS,
                                     tier_ratio=PROG_RATIO, dict_size=DICT_SIZE),
        runs=runs, warmup=1)}
    steps = {k: [] for k in ("reader.retrieve(tiers=1)", "reader.refine(tiers=2)",
                             "reader.refine(tiers=3)", "progressive.retrieve (3 tiers)")}
    for _ in range(runs + 1):
        with progressive.ProgressiveReader(prog["path"]) as r:
            for k, name in enumerate(list(steps)[:3], start=1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.refine(tiers=k)
                torch.cuda.synchronize()
                steps[name].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        progressive.retrieve(stream)
        torch.cuda.synchronize()
        steps["progressive.retrieve (3 tiers)"].append((time.perf_counter() - t0) * 1e3)
    wall.update({k: statistics.median(v[1:]) for k, v in steps.items()})

    # refactor's stages on tier 0
    plan = progressive._mgard_plan(tuple(field.shape), DICT_SIZE, None)
    bins = progressive._level_bins(bounds[0], plan.meta["L"], field.device)
    coeffs = plan.executables["decompose"](field)
    q, keys, inlier, _ = plan.executables["quantize"](coeffs, plan.workspace["lmap"], bins)
    hspec = progressive._huffman_spec(coeffs.numel())
    comp = api.encode(hspec, keys.reshape(-1))
    stage = {
        "decompose (27 solves)": lambda: plan.executables["decompose"](field),
        "quantize executable": lambda: plan.executables["quantize"](
            coeffs, plan.workspace["lmap"], bins),
        "outlier gather (nonzero + D2H)": lambda: q.reshape(-1)[
            torch.nonzero(~inlier.reshape(-1)).reshape(-1)].cpu(),
        "huffman api.encode of the keys": lambda: api.encode(hspec, keys.reshape(-1)),
        "dequantize executable": lambda: plan.executables["dequantize"](
            q, plan.workspace["lmap"], bins),
        "component to_bytes": lambda: comp.to_bytes(),
        "huffman api.decode of a component": lambda: api.decode(comp),
        "recompose (27 solves)": lambda: plan.executables["recompose"](coeffs),
    }
    stage_ms = {k: median_wall_ms(fn, runs=runs, warmup=1) for k, fn in stage.items()}
    nbytes = field.numel() * field.element_size()
    log(f"phase 5 [{card}] mgard-progressive {MGARD_EDGE}^3 end to end (host wall, synchronised,"
        f" median of {runs}): " + ", ".join(
            f"{k} {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s of the field)" for k, v in wall.items()))
    log(f"phase 5 [{card}] mgard-progressive {MGARD_EDGE}^3 stages of tier 0 (host wall, "
        f"synchronised, median of {runs}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items()))

    tree, flat, leaves, zkeys = pyt["tree"], pyt["flat"], pyt["leaves"], pyt["zkeys"]
    pw = {
        "compress_pytree": median_wall_ms(lambda: api.compress_pytree(tree), runs=runs,
                                          warmup=1),
        "serial compress_leaf": median_wall_ms(
            lambda: [api.compress_leaf(leaves[k], "zfp", rate=RATE) for k in zkeys],
            runs=runs, warmup=1),
        "decompress_pytree": median_wall_ms(lambda: api.decompress_pytree(flat, tree),
                                            runs=runs, warmup=1),
        "serial decompress_leaf": median_wall_ms(
            lambda: [api.decompress_leaf(flat[k]) for k in zkeys], runs=runs, warmup=1),
    }
    mflat, select = pyt["mflat"], mixed_select(api)
    pw["compress_pytree (mixed)"] = median_wall_ms(
        lambda: api.compress_pytree(tree, select), runs=runs, warmup=1)
    pw["decompress_pytree (mixed)"] = median_wall_ms(
        lambda: api.decompress_pytree(mflat, tree), runs=runs, warmup=1)
    log(f"phase 5 [{card}] pytree qwen2.5-3b embed + {QWEN_LAYERS} layers ({pyt['nbytes']} "
        f"bytes) end to end (host wall, synchronised, median of {runs}): " + ", ".join(
            f"{k} {v:.4f} ms ({pyt['nbytes'] / v / 1e6:.1f} GB/s of the tree)"
            for k, v in pw.items()))
    log(f"phase 5 [{card}] pytree overlap: compress_pytree / serial compress_leaf "
        f"{pw['compress_pytree'] / pw['serial compress_leaf']:.4f}, decompress_pytree / serial "
        f"decompress_leaf {pw['decompress_pytree'] / pw['serial decompress_leaf']:.4f}")


# ---------------------------------------------------------------------------
# serving: qwen2.5-3b served, its sessions parked, the service and the wire
# ---------------------------------------------------------------------------


def _layer_of(tree, i):
    """Layer ``i`` (or the layers of the slice ``i``) of the stacked layer
    parameters, as its own tree."""
    if isinstance(tree, dict):
        return {k: _layer_of(v, i) for k, v in tree.items()}
    return tree[i]


def zfp_buckets(api, tree) -> int:
    """The ZFP buckets of ``tree`` under the default policy, one kernel
    launch each: its ZFP leaves' distinct post-policy specs."""
    specs = set()
    for key, x in api.flatten_with_keys(tree):
        choice = api.default_select(key, x)
        if choice is not None:
            xp, method, params = api.leaf_policy(x, *choice)
            specs.add(api.make_spec(xp, method, **params))
    return len(specs)


def _pctl(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def check_zfp_rate(name: str, c, x, out, tables: dict, rate: int) -> dict:
    """A ZFP container of the blocked ``x`` (and its decode ``out``) against
    the plain block versions at ``rate`` (tolerance 0)."""
    import torch

    from repro_torch.kernels.zfp_block import ref

    blocks = blocks_of(x, 3)
    payload = torch.from_numpy(c.arrays["payload"].view("int32")).to(x.device)
    emax = torch.from_numpy(c.arrays["emax"]).to(x.device)
    rp, re_ = ref.compress_blocks(blocks, rate, 3, perm=tables["perm"],
                                  scale=tables["enc_scale"], chunk=PLAIN_CHUNK)
    rd = ref.decompress_blocks(payload, emax, rate, 3, perm=tables["perm"],
                               scale=tables["dec_scale"], chunk=PLAIN_CHUNK)
    got = blocks_of(out.reshape(x.shape), 3)
    errs = {"zfp_block.compress_blocks": max(int_err(payload, rp), int_err(emax, re_)),
            "zfp_block.decompress_blocks": max_abs_err(got, rd.reshape(got.shape))}
    if any(errs.values()):
        raise PhaseError(f"{name}: kernels differ from their plain versions: {errs}")
    return errs


def check_kv_restored(name: str, restored: dict, cache: dict) -> float:
    """Restored KV pages on the card, in shape and dtype, within ZFP's error
    at the parking rate (KV_ERR_TOL of the page's largest magnitude)."""
    import torch

    worst = 0.0
    for k, x in cache.items():
        got = restored[k]
        if got.device != x.device or got.dtype != x.dtype or got.shape != x.shape:
            raise PhaseError(f"{name} {k}: restored {got.device} {got.dtype} {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise PhaseError(f"{name} {k}: restored values are not all finite")
        scale = float(x.abs().max())
        err = float((got - x).abs().max()) / max(scale, 1e-30)
        if not err <= KV_ERR_TOL:
            raise PhaseError(f"{name} {k}: max |error| {err:.3e} of the largest |value| > "
                             f"{KV_ERR_TOL}")
        worst = max(worst, err)
    return worst


def phase_serving(device, api, prog: dict, st: dict, card: str) -> dict:
    """Phase 3, serving: qwen2.5-3b (hf:Qwen/Qwen2.5-3B) at full width and
    depth through ``ServingEngine`` (batch 4, 8192 positions, float32 cache,
    bfloat16 compute over float32 weights from the seed): 8 requests of 32
    prompt tokens and 16 new tokens, twice on two engines (same tokens);
    one decode step on the card against the CPU path on a depth-2 cut.  Then
    ``ReductionService`` on the card: the served cache and 4 long-context
    sessions of 2 tenants parked (zfp rate 12, the default 256 MiB budget,
    so sessions spill), fetched, restored and released; a park whose cache
    is written in place right after ``park_async`` returns; 4 client threads
    compressing one layer each under the default policy (coalesced buckets)
    and a ``huffman-bytes`` request, decompressed back; ``compress_stream``
    of the 512^3 field; two overlapping ``decompress_stream`` requests in
    one dispatch cycle; ``quicklook(tiers=1)`` of the progressive phase's
    segment file; ``overload="reject"``.  Then the wire: a
    ``ReductionServer`` on a unix socket and on 127.0.0.1, driven by the
    port's ``ReductionClient``.  Every call counted (zero launches where the
    call runs no kernel) and every kernel it launches held to its plain
    version on that call's inputs."""
    import tempfile
    import threading
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import progressive
    from repro_torch.core.container import Compressed
    from repro_torch.models import build_model, load_params
    from repro_torch.serving import (
        ReductionClient,
        ReductionServer,
        ReductionService,
        Request,
        ServiceOverloaded,
        ServingEngine,
        compress_kv_cache,
        decompress_kv_cache,
        protocol,
    )

    calls, errs = {}, {}
    cfg = get_config("qwen2.5-3b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 60), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(api.flatten_with_keys(params))
    n_params = sum(v.numel() for v in leaves.values())
    log(f"phase 3 serving: qwen2.5-3b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, QKV bias, tied embeddings): {n_params} float32 "
        f"parameters ({n_params * 4} bytes) made on the card in {init_s:.2f} s")

    # -- the served model ---------------------------------------------------
    rng = np.random.default_rng(SEED + 61)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    tokens, served = [], []
    for run in range(2):
        eng_s = ServingEngine(model, params, SERVE_BATCH, SERVE_MAX_LEN, torch.float32)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)]
        stats, calls[f"ServingEngine.serve (engine {run + 1})"] = counted(
            f"ServingEngine.serve (engine {run + 1})", lambda: eng_s.serve(reqs), {})
        toks = [r.out_tokens for r in reqs]
        if not all(r.done and len(r.out_tokens) == SERVE_NEW for r in reqs) or any(
                not 0 <= t < cfg.vocab for r in toks for t in r):
            raise PhaseError(f"serve (engine {run + 1}): tokens {toks}")
        tokens.append(toks)
        served.append((eng_s, stats))
    if tokens[0] != tokens[1]:
        raise PhaseError(f"two engines on the same weights gave different tokens: {tokens}")
    engine, serve_stats = served[0]
    del served
    log(f"phase 3 ok: serve: {SERVE_REQUESTS} requests x ({SERVE_PROMPT} prompt + {SERVE_NEW} "
        f"new tokens) on {SERVE_BATCH} slots, {serve_stats['decode_steps']} decode steps after "
        f"prefill, {serve_stats['new_tokens']} tokens in {serve_stats['wall_s']:.3f} s; tokens "
        f"in the vocabulary, two engines gave the same tokens (first request {tokens[0][0]})")

    # one decode step on the card against the CPU path, on a depth-2 cut
    cut = {"embed": params["embed"], "ln_f": params["ln_f"],
           "layers": _layer_of(params["layers"], slice(0, SERVE_CHECK_LAYERS))}
    cpu_cut = load_params(cut, torch.device("cpu"))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, SERVE_BATCH).astype(np.int32))
    diffs = {}
    for dtype, tol in SERVE_CHECK_TOL.items():
        m = build_model(replace(cfg, n_layers=SERVE_CHECK_LAYERS, dtype=dtype))
        outs = []
        for p, dev in ((cut, device), (cpu_cut, torch.device("cpu"))):
            cache = m.init_cache(SERVE_BATCH, 64, torch.float32, dev)
            for step in range(3):
                logits, cache = m.decode_step(p, toks.to(dev), cache, step)
            outs.append(logits.float().cpu())
        ref = outs[1]
        diff = float((outs[0] - ref).abs().max())
        bound = tol * (1.0 + float(ref.abs().max()))
        if not diff <= bound:
            raise PhaseError(f"decode_step ({dtype}, depth {SERVE_CHECK_LAYERS}): card vs CPU "
                             f"max |logit difference| {diff:.4e} > {bound:.4e}")
        diffs[dtype] = (diff, bound)
    del cpu_cut
    log(f"phase 3 ok: decode_step, depth-{SERVE_CHECK_LAYERS} cut of the served weights, 3 "
        "steps, card vs CPU: " + ", ".join(
            f"{k} max |logit difference| {d:.4e} <= {b:.4e} ({SERVE_CHECK_TOL[k]} x (1 + "
            f"max |logit|))" for k, (d, b) in diffs.items()))

    # -- KV parking in process ----------------------------------------------
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-serving-")
    root = Path(tmp.name)
    svc = ReductionService(batch_window=0.01, spill_dir=root / "kv")
    eng = svc.engine
    served_cache = engine.cache
    pstats, calls["park_kv (served cache)"] = counted(
        "park_kv (served cache)", lambda: svc.park_kv("served", served_cache, tenant="serve"),
        {"zfp_block.compress_blocks": 1})
    want, _ = compress_kv_cache(served_cache, rate=12)
    got = svc.fetch_kv("served", tenant="serve")
    for k in ("k", "v"):
        if got[k].to_bytes() != want[k].to_bytes():
            raise PhaseError(f"park_kv (served cache) {k}: container differs from "
                             "compress_kv_cache's")
    served_bytes = sum(x.numel() * 4 for x in served_cache.values())
    log(f"phase 3 ok: park_kv of the served cache (k, v {tuple(served_cache['k'].shape)}, "
        f"{served_bytes} bytes): one stacked launch, ratio {pstats['ratio']:.6f}, containers "
        "== compress_kv_cache's (bytes)")

    g = torch.Generator(device=device).manual_seed(SEED + 62)
    sessions = {}
    for i in range(KV_SESSIONS):
        sessions[(f"t{i % KV_TENANTS}", f"session{i}")] = {
            "k": torch.randn(KV_SESSION_SHAPE, generator=g, device=device),
            "v": torch.randn(KV_SESSION_SHAPE, generator=g, device=device)}
    session_bytes = sum(x.numel() * 4 for x in next(iter(sessions.values())).values())
    containers = {}
    for (tenant, sid), cache in sessions.items():
        _, calls[f"park_kv ({sid})"] = counted(
            f"park_kv ({sid})", lambda: svc.park_kv(sid, cache, tenant=tenant),
            {"zfp_block.compress_blocks": 1})
        containers[sid] = {k: c.to_bytes() for k, c in svc.fetch_kv(sid, tenant=tenant).items()}
    kv = svc.stats().kv
    if not kv["spills"] >= 3:
        raise PhaseError(f"parking {KV_SESSIONS} sessions under the default budget spilled "
                         f"{kv['spills']} times: {kv}")
    worst = 0.0
    for (tenant, sid), cache in sessions.items():
        flat, calls[f"fetch_kv ({sid})"] = counted(
            f"fetch_kv ({sid})", lambda: svc.fetch_kv(sid, tenant=tenant), {})
        if {k: c.to_bytes() for k, c in flat.items()} != containers[sid]:
            raise PhaseError(f"fetch_kv ({sid}): containers differ from those parked")
        out, calls[f"restore_kv ({sid})"] = counted(
            f"restore_kv ({sid})", lambda: svc.restore_kv(sid, cache, tenant=tenant),
            {"zfp_block.decompress_blocks": 1})
        worst = max(worst, check_kv_restored(f"restore_kv ({sid})", out, cache))
    kv = svc.stats().kv
    if not (kv["spills"] >= 3 and kv["loads"] >= 1):
        raise PhaseError(f"KV store: spills {kv['spills']} (want >= 3), loads {kv['loads']} "
                         f"(want >= 1)")
    # the kernels against their plain versions on one session's own pages
    (tenant0, sid0), cache0 = next(iter(sessions.items()))
    flat0 = svc.fetch_kv(sid0, tenant=tenant0)
    restored0 = svc.restore_kv(sid0, cache0, tenant=tenant0)
    xb = api.as_blocked_3d(cache0["k"])
    tables = api.get_plan(api.make_spec(xb, "zfp", rate=12)).workspace
    for k in ("k", "v"):
        e = check_zfp_rate(f"parked {sid0} {k}", flat0[k], api.as_blocked_3d(cache0[k]),
                           restored0[k], tables, 12)
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
    released = []
    for (tenant, sid), _cache in sessions.items():
        _, calls[f"release_kv ({sid})"] = counted(
            f"release_kv ({sid})", lambda: svc.release_kv(sid, tenant=tenant), {})
        try:
            svc.fetch_kv(sid, tenant=tenant)
        except KeyError:
            released.append(sid)
    if len(released) != KV_SESSIONS:
        raise PhaseError(f"release_kv: still fetchable after release: "
                         f"{set(s for _t, s in sessions) - set(released)}")
    kv_end = svc.stats().kv
    log(f"phase 3 ok: {KV_SESSIONS} sessions of {KV_TENANTS} tenants (k, v {KV_SESSION_SHAPE} "
        f"float32, {session_bytes} bytes each) parked under the {kv['capacity_bytes']}-byte "
        f"budget: {kv['spills']} spills, {kv['loads']} loads; fetch_kv == the parked "
        f"containers, restore_kv within {worst:.3e} of the largest |value| (<= {KV_ERR_TOL}), "
        f"compress_blocks / decompress_blocks == plain at rate 12 on {sid0}'s pages; released "
        f"(fetch raises KeyError); store {kv_end}")

    # park_async, then the cache written in place at once, from the default
    # stream and from a side stream (a decode loop under torch.cuda.stream(s))
    (tenant1, sid1), cache1 = list(sessions.items())[1]
    for label, stream in (("default stream", torch.cuda.default_stream(device)),
                          ("side stream", torch.cuda.Stream(device))):
        before = {k: v.clone() for k, v in cache1.items()}

        def park_then_write():
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                sub = svc.kv.park_async("mutated", cache1, tenant=tenant1)
                for _ in range(8):
                    cache1["k"].mul_(1.5).add_(1.0)
                cache1["v"].zero_()
            return sub.result(timeout=600)

        what = f"park_async + in-place writes ({label})"
        _, calls[what] = counted(what, park_then_write, {"zfp_block.compress_blocks": 1})
        want, _ = compress_kv_cache(before, rate=12)
        got = svc.fetch_kv("mutated", tenant=tenant1)
        if any(got[k].to_bytes() != want[k].to_bytes() for k in ("k", "v")):
            raise PhaseError(f"park_async ({label}): the parked bytes are not those the cache "
                             "held when park_async returned")
        svc.release_kv("mutated", tenant=tenant1)
        cache1.update(before)
        del before
    log("phase 3 ok: park_async then 8 in-place writes of k and a zeroing of v at once, from the "
        "default stream and from a side stream: the parked containers == compress_kv_cache of "
        "the cache as it was (bytes)")

    # -- the service in process ---------------------------------------------
    def stall_dispatcher(service):
        """Hold ``service``'s dispatcher inside a dispatch (its batch closed)
        until the returned gate is set, so what is submitted next queues and
        leaves in one cycle."""
        gate, entered = threading.Event(), threading.Event()

        def stalled_select(key, arr):
            entered.set()
            gate.wait(600)
            return None

        stall = service.submit_compress({"x": np.zeros(4, np.float32)}, stalled_select)
        if not entered.wait(600):
            raise PhaseError("the service's dispatcher never took the stalling request")
        return gate, stall

    layers = [_layer_of(params["layers"], i) for i in range(SERVICE_CLIENTS)]
    outs = [None] * SERVICE_CLIENTS

    def four_clients():
        """The clients' requests queue behind a held dispatch, so they leave
        in one cycle and share buckets."""
        def worker(i):
            outs[i] = svc.compress({"layers": {str(i): layers[i]}})

        gate, stall = stall_dispatcher(svc)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVICE_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 600
        while svc.stats().queue_depth < SERVICE_CLIENTS and time.monotonic() < deadline:
            time.sleep(0.001)
        gate.set()
        stall.result(600)
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads) or any(o is None for o in outs):
            raise PhaseError("service compress: a client thread did not finish")
        return outs

    before_stats = svc.stats()
    _, counts = counted("service compress (4 clients)", four_clients,
                        lambda _o: {"zfp_block.compress_blocks": read_counts()[
                            "zfp_block.compress_blocks"]})
    calls["service compress (4 clients)"] = counts
    snap = svc.stats()
    coalesced = snap.coalesced_buckets - before_stats.coalesced_buckets
    if counts["zfp_block.compress_blocks"] < 1 or coalesced < 1:
        raise PhaseError(f"service compress: {counts['zfp_block.compress_blocks']} launches, "
                         f"{coalesced} coalesced buckets (want >= 1 each)")
    zkeys = 0
    for i, (flat, _stats) in enumerate(outs):
        for key, x in api.flatten_with_keys({"layers": {str(i): layers[i]}}):
            choice = api.default_select(key, x)
            if choice is None:
                if isinstance(flat[key], Compressed) or not same_bits(flat[key], x):
                    raise PhaseError(f"service compress {key}: a raw leaf changed")
                continue
            zkeys += 1
            if flat[key].to_bytes() != api.compress_leaf(x, *choice[:1], **choice[1]).to_bytes():
                raise PhaseError(f"service compress {key}: container differs from compress_leaf's")
    hb = {k: layers[0]["attn"][k]["w"] for k in ("wk", "wv")}
    (hflat, _), calls["service compress (huffman-bytes)"] = counted(
        "service compress (huffman-bytes)",
        lambda: svc.compress(hb, lambda k, a: ("huffman-bytes", {})),
        {"histogram.histogram": 2, "huffman_encode.encode_lookup": 2})
    for k, x in hb.items():
        if hflat[k].to_bytes() != api.compress_leaf(x, "huffman-bytes").to_bytes():
            raise PhaseError(f"service compress (huffman-bytes) {k}: container differs")
    ent = check_entropy_kernels("service huffman-bytes wk", policy_keys(hb["wk"], "huffman-bytes"),
                                256, hflat["wk"], device)
    errs.update(ent["errs"])

    def decompress_all():
        return [svc.decompress(flat, {"layers": {str(i): layers[i]}})
                for i, (flat, _s) in enumerate(outs)]

    layer_buckets = [zfp_buckets(api, {"layers": {str(i): x}}) for i, x in enumerate(layers)]
    decoded, calls["service decompress (4 layers)"] = counted(
        "service decompress (4 layers)", decompress_all,
        {"zfp_block.decompress_blocks": sum(layer_buckets)})
    for i, tree in enumerate(decoded):
        got = dict(api.flatten_with_keys(tree))
        for key, c in outs[i][0].items():
            want = api.decompress_leaf(c) if isinstance(c, Compressed) else c
            if got[key].device != device or not same_bits(got[key], want):
                raise PhaseError(f"service decompress {key}: differs from decompress_leaf")
    hout, calls["service decompress (huffman-bytes)"] = counted(
        "service decompress (huffman-bytes)", lambda: svc.decompress(hflat, hb),
        {"huffman_decode.decode_chunks": 2})
    if any(not same_bits(hout[k], x) for k, x in hb.items()):
        raise PhaseError("service decompress (huffman-bytes): not exact")
    log(f"phase 3 ok: service: {SERVICE_CLIENTS} client threads compressed one layer each "
        f"({zkeys} zfp leaves, {counts['zfp_block.compress_blocks']} launches, {coalesced} "
        f"coalesced buckets, fill {snap.batch_fill_ratio:.2f}); every container == "
        f"compress_leaf's, every decoded leaf == decompress_leaf's on the card (each layer's "
        f"decompress {layer_buckets[0]} launches, one a bucket); wk, wv through "
        "huffman-bytes exact, histogram / encode_lookup / decode_chunks == plain")

    host = st["host"]
    n_chunks = host.numel() // STREAM_CHUNK
    (blob, sinfo), calls["service compress_stream"] = counted(
        "service compress_stream",
        lambda: svc.compress_stream(host, "zfp", rate=RATE, chunk_size=STREAM_CHUNK, window=2),
        {"zfp_block.compress_blocks": n_chunks})
    direct = api.CompressorStream("zfp", rate=RATE, chunk_size=STREAM_CHUNK, window=2)
    if blob != api.CompressorStream.to_bytes(direct.compress(host)):
        raise PhaseError("service compress_stream: bytes differ from a direct CompressorStream")
    lo_hi = ((0, n_chunks * 5 // 8), (n_chunks * 3 // 8, n_chunks))  # 16: (0, 10), (6, 16)

    def two_overlapping():
        gate, stall = stall_dispatcher(svc)
        subs = [svc.submit_decompress_stream(blob, chunks=r) for r in lo_hi]
        gate.set()
        stall.result(600)
        return [s.result(600) for s in subs]

    hits0 = svc.stats().chunk_coalesce_hits
    parts, calls["service decompress_stream (2 overlapping)"] = counted(
        "service decompress_stream (2 overlapping)", two_overlapping,
        {"zfp_block.decompress_blocks": n_chunks})
    hits = svc.stats().chunk_coalesce_hits - hits0
    res = api.CompressorStream.from_bytes(blob)
    whole = api.CompressorStream.decompress(res)
    ends = res.boundaries + [host.shape[res.axis]]
    for (lo, hi), (arr, _info) in zip(lo_hi, parts):
        if arr.device != device or not same_bits(
                arr, whole.narrow(res.axis, ends[lo], ends[hi] - ends[lo])):
            raise PhaseError(f"service decompress_stream {lo, hi}: differs from the stream decode")
    if hits < 1:
        raise PhaseError(f"service decompress_stream: {hits} coalesce hits (want >= 1)")
    solves = mgard_solves(tuple(prog["field"].shape))
    ql_want = {"huffman_decode.decode_chunks": 1, "quantize_map.dequantize": 1,
               "tridiag.solve_mass": solves}
    with held_to_plain() as held:  # each kernel also against its plain version, in the call
        (qarr, qinfo), calls["service quicklook(tiers=1)"] = counted(
            "service quicklook(tiers=1)", lambda: svc.quicklook(prog["path"], tiers=1), ql_want)
    if {k: n for k, (n, _e) in held.items()} != ql_want or any(e for _n, e in held.values()):
        raise PhaseError(f"service quicklook: kernels against their plain versions on the "
                         f"call's own inputs (calls, max |err|): {held}")
    for name, (_n, e) in held.items():
        errs[name] = max(errs.get(name, 0.0), e)
    with progressive.ProgressiveReader(prog["path"]) as r:
        if not same_bits(qarr, r.retrieve(tiers=1)):
            raise PhaseError("service quicklook: differs from a direct retrieve(tiers=1)")
    small = ReductionService(eng, max_queue=1, overload="reject", batch_window=0.0,
                             spill_dir=root / "small")
    rejected = False
    gate2, first = stall_dispatcher(small)
    try:
        second = small.submit_compress({"x": np.zeros(4, np.float32)})
        try:
            small.submit_compress({"x": np.zeros(4, np.float32)})
        except ServiceOverloaded:
            rejected = True
    finally:
        gate2.set()
    first.result(600)
    second.result(600)
    small.close(600)
    if not rejected or small.stats().rejected != 1:
        raise PhaseError("overload='reject' with max_queue=1 did not raise ServiceOverloaded")
    log(f"phase 3 ok: service compress_stream of the {FIELD_EDGE}^3 field ({n_chunks} chunks, "
        f"window 2) == a direct CompressorStream (bytes); two decompress_stream requests "
        f"{lo_hi} in one dispatch cycle: {n_chunks} chunk decodes, {hits} coalesce hits, each "
        f"== the stream's decode; quicklook(tiers=1) == a direct retrieve, {qinfo['bytes_fetched']} "
        f"of {qinfo['file_bytes']} bytes read, its decode_chunks / dequantize / {solves} "
        f"solve_mass launches == plain on their own inputs; overload='reject' raised "
        f"ServiceOverloaded")

    # -- the wire -------------------------------------------------------------
    server = ReductionServer(svc, unix_path=root / "hpdr.sock", tcp=("127.0.0.1", 0))
    ucli = ReductionClient(server.unix_address, timeout=600)
    tcli = ReductionClient(server.tcp_address, timeout=600)
    if ucli.ping(b"ping") != b"ping" or tcli.ping(b"ping") != b"ping":
        raise PhaseError("wire: ping did not echo")
    wstats = ucli.stats()
    if set(wstats) != set(svc.stats().as_dict()):
        raise PhaseError("wire: stats keys differ from ServiceStats")
    layer0 = {"layers": {"0": layers[0]}}
    flat_layer0 = dict(api.flatten_with_keys(layer0))
    for name, cli in (("unix", ucli), ("tcp", tcli)):
        (wflat, _), calls[f"wire compress ({name})"] = counted(
            f"wire compress ({name})", lambda: cli.compress(flat_layer0),
            {"zfp_block.compress_blocks": layer_buckets[0]})
        for key, c in outs[0][0].items():
            if isinstance(c, Compressed):
                if wflat[key].to_bytes() != c.to_bytes():
                    raise PhaseError(f"wire compress ({name}) {key}: bytes differ from in process")
            elif wflat[key].tobytes() != c.cpu().numpy().tobytes():
                raise PhaseError(f"wire compress ({name}) {key}: raw leaf differs")
    wout, calls["wire decompress (unix)"] = counted(
        "wire decompress (unix)", lambda: ucli.decompress(wflat),
        {"zfp_block.decompress_blocks": layer_buckets[0]})
    dec0 = dict(api.flatten_with_keys(decoded[0]))
    if any(wout[k].tobytes() != dec0[k].cpu().numpy().tobytes() for k in dec0):
        raise PhaseError("wire decompress: differs from the in-process decode")
    (tenant2, sid2), cache2 = list(sessions.items())[2]
    _, calls["wire park_kv (tcp)"] = counted(
        "wire park_kv (tcp)", lambda: tcli.park_kv("wire", cache2),
        {"zfp_block.compress_blocks": 1})
    wfetch, calls["wire fetch_kv (tcp)"] = counted(
        "wire fetch_kv (tcp)", lambda: tcli.fetch_kv("wire"), {})
    if {k: c.to_bytes() for k, c in wfetch.items()} != containers[sid2]:
        raise PhaseError("wire park_kv/fetch_kv: containers differ from the in-process park")
    _, calls["wire release_kv (tcp)"] = counted(
        "wire release_kv (tcp)", lambda: tcli.release_kv("wire"), {})
    (wblob, _), calls["wire compress_stream (unix)"] = counted(
        "wire compress_stream (unix)",
        lambda: ucli.compress_stream(host, "zfp", rate=RATE, chunk_size=STREAM_CHUNK, window=2),
        {"zfp_block.compress_blocks": n_chunks})
    if wblob != blob:
        raise PhaseError("wire compress_stream: bytes differ from the in-process stream")
    (wq, _), calls["wire quicklook (unix)"] = counted(
        "wire quicklook (unix)", lambda: ucli.quicklook(prog["path"], tiers=1),
        {"huffman_decode.decode_chunks": 1, "quantize_map.dequantize": 1,
         "tridiag.solve_mass": solves})
    if wq.tobytes() != qarr.cpu().numpy().tobytes():
        raise PhaseError("wire quicklook: differs from the in-process quicklook")
    import socket as socket_mod

    raw = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    raw.settimeout(60)
    raw.connect(server.unix_address)
    raw.sendall(b"\x18\x00\x00\x00" + b"JUNK" + bytes(20))
    frame = protocol.recv_frame(raw)
    raw.close()
    field_name = None
    try:
        protocol.raise_error_payload(frame.payload)
    except protocol.ProtocolError as e:
        field_name = e.field
    if frame.opcode != protocol.OP_ERROR or field_name != "magic":
        raise PhaseError(f"wire: a frame with bad magic got opcode {frame.opcode:#x}, "
                         f"field {field_name}")
    with ReductionClient(server.unix_address, timeout=60) as fresh:
        if fresh.ping(b"after") != b"after":
            raise PhaseError("wire: no service on a fresh connection after a bad frame")
    log(f"phase 3 ok: wire on {server.unix_address} and {server.tcp_address}: ping, stats, "
        f"compress of layer 0 over both (container bytes == in process), decompress (== in "
        f"process), park_kv / fetch_kv / release_kv of {sid2} ({session_bytes} bytes; "
        f"containers == the in-process park), compress_stream of the {FIELD_EDGE}^3 field "
        f"(bytes == in process), quicklook (== in process); bad magic -> OP_ERROR [field=magic],"
        f" then a fresh connection served; server {server.stats()}")
    return {"calls": calls, "errs": errs, "model": model, "params": params, "engine": engine,
            "serve_stats": serve_stats, "svc": svc, "server": server, "ucli": ucli, "tcli": tcli,
            "sessions": sessions, "layers": layers, "outs": outs,
            "session_bytes": session_bytes,
            "tmp": tmp, "host": host, "blob": blob, "flat_layer0": flat_layer0}


def device_trace(fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (after a warm-up call):
    its device events (kernels, memcpys, memsets), the time the device was
    busy with them (their union), the host wall time of that same call
    (synchronised; the profiler's own host cost included), and the ``top``
    names by total time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiling session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"launches": len(events), "busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "top": [(name, n, ms) for name, (n, ms) in ranked]}


def phase_serving_timings(api, srv: dict, card: str) -> None:
    """Phase 5, serving: decode tokens/s and one decode step; park_kv,
    fetch_kv (resident and spilled) and restore_kv, median and p99 of
    KV_TIMED_RUNS; 4 concurrent compress requests against their serial sum;
    in process against over the socket (one layer on both listeners, one
    parked session on the unix socket; loopback GB/s); the service's waits
    and dispatch cycles.  Host wall, each run synchronised."""
    import threading

    import torch

    from repro_torch.core.container import Compressed

    model, params, engine, svc = srv["model"], srv["params"], srv["engine"], srv["svc"]
    ss = srv["serve_stats"]
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"(phase 5 serving, {what}: {now - clock[0]:.1f} s)")
        clock[0] = now

    toks = torch.zeros(SERVE_BATCH, dtype=torch.int32, device=engine.device)
    cache_len = int(engine.lens.max())
    step_ms = median_wall_ms(
        lambda: model.decode_step(params, toks, engine.cache, cache_len), runs=TIMED_RUNS)
    log(f"phase 5 [{card}] serving qwen2.5-3b, batch {SERVE_BATCH}, cache {SERVE_MAX_LEN} "
        f"positions float32: serve() {ss['new_tokens']} new tokens in {ss['wall_s']:.4f} s "
        f"({ss['tokens_per_s']:.3f} tokens/s, {ss['decode_steps']} decode steps + "
        f"{SERVE_REQUESTS * SERVE_PROMPT} prefill steps); one decode step (host wall, "
        f"synchronised, median of {TIMED_RUNS}) {step_ms:.4f} ms = "
        f"{SERVE_BATCH / step_ms * 1e3:.3f} tokens/s at batch {SERVE_BATCH}")
    trace = device_trace(lambda: model.decode_step(params, toks, engine.cache, cache_len))
    busy, wall = trace["busy_ms"], trace["wall_ms"]
    log(f"phase 5 [{card}] one decode step under torch.profiler: {trace['launches']} device "
        f"launches (kernels and copies), device busy {busy:.4f} ms of that call's {wall:.4f} ms "
        f"(host wall, synchronised, profiler included; idle share {1 - busy / wall:.4f}); by "
        f"time: " + ", ".join(
            f"{name[:60]} x{n} {ms:.4f} ms" for name, n, ms in trace["top"]))
    lap("decode step")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    sessions = list(srv["sessions"].items())
    kv_ms = {"park_kv": [], "fetch_kv resident": [], "fetch_kv spilled": [], "restore_kv": []}
    for i in range(KV_TIMED_RUNS):
        (tenant, sid), cache = sessions[i % len(sessions)]
        kv_ms["park_kv"].append(timed(lambda: svc.park_kv(sid, cache, tenant=tenant))[0])
        kv_ms["fetch_kv resident"].append(timed(lambda: svc.fetch_kv(sid, tenant=tenant))[0])
        kv_ms["restore_kv"].append(timed(lambda: svc.restore_kv(sid, cache, tenant=tenant))[0])
    spills0 = svc.stats().kv["loads"]
    for i in range(KV_TIMED_RUNS):  # the older parked sessions, spilled in turn
        (tenant, sid), _cache = sessions[i % len(sessions)]
        kv_ms["fetch_kv spilled"].append(timed(lambda: svc.fetch_kv(sid, tenant=tenant))[0])
    loads = svc.stats().kv["loads"] - spills0
    log(f"phase 5 [{card}] KV parking, sessions of {srv['session_bytes']} bytes (host wall, "
        f"synchronised, {KV_TIMED_RUNS} runs; fetch_kv spilled: {loads} of "
        f"{KV_TIMED_RUNS} re-materialised from disk): " + ", ".join(
            f"{k} median {statistics.median(v):.4f} ms p99 {_pctl(v, 99):.4f} ms"
            for k, v in kv_ms.items()))
    lap("KV parking")

    layers = srv["layers"]
    trees = [{"layers": {str(i): layers[i]}} for i in range(SERVICE_CLIENTS)]
    layer_bytes = sum(x.numel() * 4 for _k, x in api.flatten_with_keys(trees[0]))
    # phase 3's containers of the same trees, which every concurrent run must give again
    want = [{k: c.to_bytes() if isinstance(c, Compressed) else c for k, c in flat.items()}
            for flat, _stats in srv["outs"]]

    def run():
        res, errors = [None] * len(trees), []

        def worker(i):
            try:
                res[i] = svc.compress(trees[i])
            except BaseException as e:  # re-raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(trees))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise PhaseError("concurrent service compress: a client thread still runs after 600 s")
        if errors:
            raise errors[0]
        return res

    serial, concurrent = [], []
    for _ in range(NEW_TIMED_RUNS):
        serial.append(timed(lambda: [svc.compress(t) for t in trees])[0])
        ms, res = timed(run)
        concurrent.append(ms)
        for i, (flat, _stats) in enumerate(res):
            for k, w in want[i].items():
                if not (flat[k].to_bytes() == w if isinstance(w, bytes) else same_bits(flat[k], w)):
                    raise PhaseError(f"concurrent service compress {k}: differs from phase 3's")
    log(f"phase 5 [{card}] service compress of {SERVICE_CLIENTS} layers ({layer_bytes} bytes "
        f"each; host wall, synchronised, median of {NEW_TIMED_RUNS}): {SERVICE_CLIENTS} "
        f"concurrent clients {statistics.median(concurrent):.4f} ms, serial sum "
        f"{statistics.median(serial):.4f} ms, ratio "
        f"{statistics.median(concurrent) / statistics.median(serial):.4f}")
    lap("concurrent and serial compress")

    flat_layer0, ucli, tcli = srv["flat_layer0"], srv["ucli"], srv["tcli"]
    wire = {"in process": [], "unix": [], "tcp": []}
    for _ in range(WIRE_TIMED_RUNS):
        wire["in process"].append(timed(lambda: svc.compress(flat_layer0))[0])
        wire["unix"].append(timed(lambda: ucli.compress(flat_layer0))[0])
        wire["tcp"].append(timed(lambda: tcli.compress(flat_layer0))[0])
    (tenant, sid), cache = sessions[0]
    sess = {"in process": [], "unix": []}
    for _ in range(WIRE_TIMED_RUNS):
        sess["in process"].append(timed(lambda: svc.park_kv("timing", cache))[0])
        sess["unix"].append(timed(lambda: ucli.park_kv("timing-wire", cache))[0])
    log(f"phase 5 [{card}] in process vs over the socket (host wall, synchronised, median of "
        f"{WIRE_TIMED_RUNS}): compress of layer 0 ({layer_bytes} bytes): " + ", ".join(
            f"{k} {statistics.median(v):.4f} ms ({layer_bytes / statistics.median(v) / 1e6:.3f} "
            "GB/s of the layer)" for k, v in wire.items())
        + f"; park_kv of one session ({srv['session_bytes']} bytes): " + ", ".join(
            f"{k} {statistics.median(v):.4f} ms "
            f"({srv['session_bytes'] / statistics.median(v) / 1e6:.3f} GB/s of the session)"
            for k, v in sess.items()))
    lap("in process and over the socket")
    s = svc.stats()
    log(f"phase 5 [{card}] service: {s.dispatch_cycles} dispatch cycles, {s.admitted} "
        f"admitted, {s.completed} completed, waits: " + ", ".join(
            f"{p} p50 {h['wait_p50'] * 1e3:.4f} ms p99 {h['wait_p99'] * 1e3:.4f} ms "
            f"({h['samples']} samples)" for p, h in s.priorities.items())
        + f"; connections {s.connections['opened']} opened, rx {s.connections['rx_bytes']} "
        f"bytes, tx {s.connections['tx_bytes']} bytes; kv {s.kv['spills']} spills, "
        f"{s.kv['loads']} loads")
    for cli in (ucli, tcli):
        cli.close()
    srv["server"].close(60)
    lap("server close")
    svc.close(600)
    lap("service close")
    srv["tmp"].cleanup()
    torch.cuda.synchronize()
    lap("spill directory removed")


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

    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"({what}: {now - clock[0]:.1f} s)")
        clock[0] = now

    phase_kernels_vs_plain(device)
    lap("phase 2, ZFP")
    phase_huffman_kernels_vs_plain(device)
    lap("phase 2, Huffman")
    phase_mgard_kernels_vs_plain(device)
    lap("phase 2, MGARD")
    field, c, out, main_res, launches, tables = phase_main_path(device, api, kernel)
    lap("phase 3, ZFP")
    huff_runs = phase_huffman_main_path(device, api)
    lap("phase 3, Huffman")
    mgard_run = phase_mgard_main_path(device, api)
    lap("phase 3, MGARD")
    phase_dtypes(device, api)
    lap("phase 3, dtypes")
    prog = phase_progressive(device, api)
    lap("phase 3, progressive")
    pyt = phase_pytree(device, api)
    lap("phase 3, pytree")
    import tempfile

    from repro_torch.core import mgard
    from repro_torch.runtime import calibrate

    cal_dir = tempfile.TemporaryDirectory()   # a cold calibration, removed at the end
    calibrate.set_calibration_dir(cal_dir.name)
    st = phase_stream(device, api, field, mgard.pad_to_dyadic(mgard_run["field"]))
    lap("phase 3, stream")
    ckpt = phase_checkpoint(device, api, pyt["tree"], card)
    lap("phase 3, checkpoint")
    srv = phase_serving(device, api, prog, st, card)
    lap("phase 3, serving")
    phase_bytes_round_trip(api, c, out)
    phase_bytes_round_trip(api, huff_runs[0]["c"], huff_runs[0]["out"], leaf=True)
    again = phase_bytes_round_trip(api, mgard_run["c"], mgard_run["out"])
    check_mgard_result("mgard from_bytes", mgard_run["c"], mgard_run["field"], again)
    phase_new_round_trips(api, prog, pyt)
    lap("phase 4")
    kernels = phase_timings(api, kernel, field, c, main_res, tables, card)
    lap("phase 5, ZFP")
    for k in kernels:
        short = k["name"].split(".", 1)[1]
        k["launches"] = launches[short]
        k["max_abs_err"] = main_res[short]
    huff_kernels = phase_huffman_timings(api, huff_runs[0], card)
    phase_huffman_timings(api, huff_runs[1], card)
    lap("phase 5, Huffman")
    mgard_kernels = phase_mgard_timings(api, mgard_run, card)
    lap("phase 5, MGARD")
    phase_new_timings(api, prog, pyt, card)
    lap("phase 5, progressive and pytree")
    phase_stream_timings(api, st, card, device)
    lap("phase 5, stream")
    phase_serving_timings(api, srv, card)
    lap("phase 5, serving")
    prog["tmp"].cleanup()
    calibrate.set_calibration_dir(None)
    cal_dir.cleanup()
    for k in huff_kernels:  # the entropy tail runs on the Huffman and the MGARD paths
        runs = huff_runs + [mgard_run]
        k["launches"] = sum(r["counts"][k["name"]] for r in runs)
        k["max_abs_err"] = max(r["errs"][k["name"]] for r in runs)
    # the progressive, pytree, stream, checkpoint and serving paths' launches and
    # checks join every kernel's
    new_paths = {"progressive": prog, "pytree": pyt, "stream": st, "checkpoint": ckpt,
                 "serving": srv}
    for k in kernels + huff_kernels + mgard_kernels:
        for run in new_paths.values():
            k["launches"] += sum(counts[k["name"]] for counts in run["calls"].values())
            k["max_abs_err"] = max(k["max_abs_err"], run["errs"].get(k["name"], 0.0))
    log("launches by path: " + json.dumps({
        name: {call: {k: n for k, n in counts.items() if n} for call, counts in run["calls"].items()}
        for name, run in new_paths.items()}))
    log(json.dumps({"kernels": kernels + huff_kernels + mgard_kernels}))
    from repro_torch.core import engine as engine_mod

    engine_mod.default_engine().close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
