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
     a protocol error, then a fresh connection served); each call counted.
     Training (after serving's timings; the served model, the trees and
     the fields freed first) — ``train_loop("qwen2.5-3b", smoke=False,
     steps=6, batch=8, seq=128)`` through the port's entry point: 36
     layers, 3.09B float32 parameters from the seed, bfloat16 compute,
     float32 AdamW moments, no checkpoint and no kernel launched; every
     loss finite and every step's update applied; its peak
     ``max_memory_allocated``, the median of the last 4 step times,
     tokens/s and the model-FLOP share of 989 TFLOP/s; one step under
     ``torch.profiler``; a depth-2 full-width step (loss and every
     gradient) on the card against the CPU, float32 within 1e-5 / 1e-3 and
     bfloat16 within 1e-2 / 5e-2 (loss / a leaf's largest |gradient|, no
     TF32); a resume at depth 2 under ``torch.use_deterministic_algorithms``
     (the config resized by patching ``train.get_config``, as the
     reference's example does), placed: ``train_loop(mesh=)`` on a 1 x 1
     ``("data","model")`` mesh over the card (a world-size-1 NCCL group,
     started before this phase and ended after the next), parameters and
     moments placed by ``param_shardings``: runs A and A again (6 steps), B (an exact
     checkpoint at step 3, ``sync_ckpt``, a failure injected at step 4), C
     restarting on B's directory (restore of step 3 onto the placements,
     steps 3-5, a ``save_async`` of step 6 and ``wait()``), C's losses and final state
     == A's bit for bit (or, were an op nondeterministic, within the
     spread of the two A runs, named); every save and restore counted
     exactly (one ``histogram`` and ``encode_lookup`` per ``huffman-bytes``
     container, one ``decode_chunks`` per decoded one; the 1.24 GB
     embedding and its moments in 128 MiB chunks) with the entropy
     kernels held to their plain versions inside the call on the 2^27
     byte keys and the container of the embedding's first chunk; then C's
     placed state saved with the default zfp policy and restored onto its
     placements, every launch
     of the ZFP and entropy kernels inside both calls held to its plain
     version on the same inputs, each leaf == the one-shot or streamed
     decode of its containers.  The placed path (same mesh) —
     ``train_loop(mesh=)`` of qwen2.5-3b at full width and depth under the
     ``tp`` policy (against the unplaced run above) and under ``dp_zero1``
     with the dry run's ``OPT_OVERRIDES`` (bfloat16 parameters; against an
     unplaced run of that config): losses and parameters within the
     bfloat16 tolerances above, ms a step, tokens/s and peak placed and
     unplaced; at the depth-2 cut ``make_prefill_step`` against the
     forward's last position and ``make_decode_step`` on a placed cache of
     8 slots for 10 steps, the masked update == the slice write bit for
     bit, placed vs unplaced.  The ssm family (the previous phase's
     model and state freed first) — ``train_loop("mamba2-370m",
     smoke=False, steps=6, batch=8, seq=1024)`` at full width and depth
     (48 layers, 368M float32 parameters from the seed, bfloat16 compute,
     8 SSD chunks a sequence, no kernel launched), a depth-2 full-width
     step on the card against the CPU (two chunks; float32 and bfloat16 at
     the training phase's tolerances) and a bit-exact resume at depth 4
     (runs A, A, B, C as above; the entropy kernels held to plain inside
     each save and restore on the embedding's first 128 MiB chunk); then
     mamba2-370m served at full width and depth by ``ServingEngine`` (8
     requests of 32 + 16 tokens on 4 slots), the same requests on a
     depth-2 cut in float32 on the card and on the CPU (the same tokens),
     three decode steps against the CPU (float32 within 1e-4, bfloat16
     within 2^-5 of 1 + max |logit|), 200 decode steps over a prompt
     against the forward's last-position logits at full depth in float32
     (within 1e-3 of 1 + max |logit|), and the served cache (state and
     conv) parked in a ``KVPageStore`` at zfp rate 12, fetched and
     restored resident and after a spill (the same container bytes,
     within 0.05 of each leaf's largest |value|), every ZFP launch held to
     its plain version.  The vlm family — qwen2-vl-72b at full width cut
     to 2 of its 80 layers (4.25B float32 parameters): ``value_and_grad``
     on an ``embeds`` batch (8, 128, 8192) whose M-RoPE positions mix text
     tokens and an 8 x 8 image grid (loss and every gradient finite; the
     positions move the loss), the smoke cut's step on the card against
     the CPU in float32, and ``ServingEngine`` decode on tokens.  The moe
     family — deepseek-v3-671b at full width (d_model 7168, 128 MLA heads,
     256 routed experts top-8 + 1 shared, dense FFN 18432, vocab 129280,
     MTP) cut to 4 of its 61 layers (its 3 dense layers and 1 MoE layer,
     15.8B float32 parameters from the seed): ``loss`` under ``no_grad`` on
     tokens (4, 128) (``ce``, ``aux`` and ``mtp_ce`` finite, ``aux`` > 0),
     served by ``ServingEngine`` (4 slots x 1024 positions, the float32 MLA
     cache; 8 requests of 32 + 16 tokens); llama4-scout-17b-a16e at full
     width (d_model 5120, 40 heads, 8 KV heads, 16 routed experts top-1 +
     1 shared, vocab 202048) cut to 2 of its 48 layers (6.47B parameters):
     ``value_and_grad`` on tokens (8, 128) (loss and every gradient finite,
     the router's non-zero), served at 4 x 8192 positions; each served
     cache parked in a ``KVPageStore`` at zfp rate 12, fetched and restored
     resident and after a spill, every ZFP launch held to its plain
     version; both smoke cuts card against CPU in float32 (a train step at
     the training phase's float32 tolerances, the same served tokens, every
     routing decision equal call for call); and a bit-exact resume of
     ``train_loop("deepseek-v3-671b")`` at the smoke cut (runs A, A, B, C
     as above).  The hybrid family — recurrentgemma-9b at full width and
     depth (38 layers: 12 (rec, rec, attn) superblocks of RG-LRU and local
     attention sublayers and a 2-layer tail; 9.40B float32 parameters from
     the seed, bfloat16 compute) served by ``ServingEngine`` (4 slots x
     4096 positions, the float32 cache: the RG-LRU ``h`` and conv buffers,
     the attention cache a 2048-slot ring; 8 requests of 32 + 16 tokens),
     its cache parked as above; the first superblock at full width in
     float32, 2100 decode steps over a prompt against the forward's
     last-position logits under ``local_causal_mask`` (the ring wraps at
     2048; within 1e-3 of 1 + max |logit|); ``train_loop
     ("recurrentgemma-9b", smoke=False, steps=6, batch=8, seq=128)`` at full
     width cut to 5 of 38 layers (1 superblock and the 2-layer tail, as
     the full model's 12 and 2; AdamW), its parameters saved with the config's policy
     (zfp rate 16, ``huffman-bytes`` below 16384 elements) and restored, every
     ZFP launch inside both calls held to plain, exact leaves bit for bit,
     zfp leaves within 1e-2 of their largest |value|; the smoke cut card
     against CPU (a train step, the same served tokens) and a bit-exact
     resume of ``train_loop("recurrentgemma-9b")`` there.  The encdec
     family — seamless-m4t-medium at full width and depth (12 + 12 layers,
     0.88B parameters, bfloat16 compute): 6 steps of ``value_and_grad`` +
     ``apply_updates_`` on ``enc_embeds`` (8, 512, 1024) and tokens (8,
     128), ``encode`` of 4 x 512 frames, ``precompute_cross`` and 64 greedy
     ``decode_step``s, the self-attention cache parked as above, the
     training state through the config's zfp policy as recurrentgemma's;
     its smoke cut card against CPU (the loss and gradients, 8 decode
     steps' logits).  Abstractions and examples (last) — the paper's
     parallel abstractions on the 512^3 field: ``locality`` with 4^3
     blocks and an elementwise ``fn`` and, on a 128^3 cut, with a halo of
     1 (card == the same call on a CPU copy, bit for bit), ``iterative`` as
     a prefix sum along axis 0 (512 steps, forward and reversed),
     ``map_and_process`` with MGARD's 513^3 level map as subset ids,
     ``global_pipeline`` and ``jitted_dem``; the standalone
     ``zfp.compress``/``decompress`` at rate 16 (the kernel, as a card
     tensor takes it == ``compress_jit(adapter="torch")``, the plain block
     path == the ``zfp`` codec container) and
     ``mgard.compress``/``decompress`` at the absolute bound 1e-2 (stream ==
     the ``mgard`` codec container, decode == the codec's, within the
     bound); ``ExecutionEngine(mesh=make_data_mesh())`` against the
     ``devices=`` engine; the reference's API as the port now takes it (a
     64 MiB cut through the single-phase ``ChunkedPipeline(compress_fn)``
     == the two-phase stream's chunks, ``zfp``/``mgard.compress`` of a
     numpy float64 array recording "float64", ``pad_to_blocks`` in every
     mode and ``iterative`` over an empty axis card == CPU,
     ``ExecutionEngine(make_data_mesh())`` given positionally); then the
     four examples through their ``main``
     (``examples/*_torch.py``: quickstart at 64^3, serve_batched and
     compressed_checkpoint_io at the smoke cuts, train_lm ``--preset
     small`` for 200 steps and ``--preset 100m`` for 20), every launch
     inside held to its plain version;
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
     yardsticks the port never calls), ``pack_stream`` beside its plain
     version at 2^26 keys and at MGARD's 513^3 keys (device time too), the
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
     loopback GB/s), and the service's waits and dispatch cycles;
     training: the full run's step times, tokens/s, model-FLOP share and
     peak memory, the traced step's busy share, launches and top device
     operations, and each checkpoint save and restore of the depth-2
     state (host wall, one run each); the ssm, vlm and moe phases' step,
     forward, ``value_and_grad`` and decode times, peak memory and park /
     fetch / restore times; the hybrid and encdec phases' decode steps,
     serve, window check, training steps, peaks and checkpoint times; each
     printed with the card's name and power limit.

The last two lines are one JSON object per kernel (``{"kernels": [...]}``;
the Huffman kernels' times are those of the ``huffman-bytes`` leaf; a
kernel's launches are summed over every counted main-path call (the ZFP,
Huffman, MGARD, progressive, pytree, stream, checkpoint, serving,
training, placed path, mamba2 training, mamba2 serving, qwen2-vl,
deepseek-v3, llama4-scout, moe card vs CPU, moe resume,
recurrentgemma-9b serving and training, hybrid smoke cut,
seamless-m4t-medium, encdec card vs CPU, abstractions and codec API
and examples paths; a line before gives the last twenty-one paths'
calls' own), its error
the largest of them) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
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
SERVE_LAYERS = 12                   # of qwen2.5-3b's 36: serve() is host-bound a layer at a time
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
TRAIN_ARCH = "qwen2.5-3b"           # hf:Qwen/Qwen2.5-3B at full width and depth
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 128   # the reference's default batch and length
TRAIN_TIMED = 4                     # the median step of the last 4
TRAIN_CUT_LAYERS = 2                # the depth cut of the card vs CPU step and of the resume
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 1, 64
# (loss, each gradient leaf) within these shares of the CPU's value / largest |gradient|
TRAIN_CHECK_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (1e-2, 5e-2)}
RESUME_EVERY, RESUME_FAIL_AT = 3, 4  # checkpoint at step 3, failure injected at step 4
PLACED_DECODE_SLOTS = 8             # the placed decode's cache; 10 steps wrap its ring
SSM_ARCH = "mamba2-370m"            # arXiv:2405.21060 at full width and depth (48 layers)
SSM_BATCH, SSM_SEQ = 8, 1024        # 8 SSD chunks of 128: the inter-chunk recurrence runs
SSM_CHECK_BATCH, SSM_CHECK_SEQ = 2, 256   # the card vs CPU step: two chunks
SSM_RESUME_LAYERS = 4               # the depth cut of the resume (the embedding streams in chunks)
SSM_IDENTITY_PROMPT = 200           # decode vs forward over two chunks, the second padded
SSM_IDENTITY_TOL = 1e-3             # float32: of 1 + max |logit| over 48 layers
SSM_PARK_RATE = 12                  # the store's default zfp rate
VLM_ARCH = "qwen2-vl-72b"           # hf:Qwen/Qwen2-VL-72B at full width
VLM_LAYERS = 2                      # of 80: 4.25B float32 parameters, 17.0 GB
VLM_BATCH, VLM_SEQ = 8, 128
VLM_IMAGE_AT, VLM_GRID = 16, (8, 8)  # 64 image patches at t = 16 inside the 128 positions
VLM_SERVE_REQUESTS, VLM_SERVE_PROMPT, VLM_SERVE_NEW, VLM_SERVE_MAX_LEN = 4, 8, 8, 64
DS_ARCH = "deepseek-v3-671b"       # arXiv:2412.19437, hf:deepseek-ai/DeepSeek-V3 at full width
DS_LAYERS = 4                       # of 61: its 3 dense layers and 1 MoE layer, 15.8B parameters
DS_BATCH, DS_SEQ = 4, 128           # the forward under no_grad (its gradients would not fit)
DS_SERVE_MAX_LEN = 1024             # cache positions a slot (the MLA cache: 576 floats a token)
L4_ARCH = "llama4-scout-17b-a16e"   # hf:meta-llama/Llama-4-Scout-17B-16E at full width
L4_LAYERS = 2                       # of 48: 6.47B float32 parameters, 25.9 GB
L4_BATCH, L4_SEQ = 8, 128
HYB_ARCH = "recurrentgemma-9b"      # arXiv:2402.19427, hf:google/recurrentgemma-9b at full width
HYB_SERVE_MAX_LEN = 4096            # positions a slot; the attention cache is the 2048-slot ring
HYB_TRAIN_LAYERS = 5                # of 38: 1 superblock + the 2-layer tail (the time limit)
HYB_WINDOW_STEPS = 2100             # decode steps of the first superblock, past the 2048 window
HYB_WINDOW_BATCH = 1
HYB_WINDOW_TOL = 1e-3               # float32: of 1 + max |logit|
ED_ARCH = "seamless-m4t-medium"     # arXiv:2308.11596, hf:facebook/seamless-m4t-medium
ED_BATCH, ED_ENC_SEQ, ED_DEC_SEQ = 8, 512, 128
ED_SERVE_BATCH, ED_DECODE_STEPS = 4, 64
ED_CHECK_STEPS = 8                  # the smoke cut's decode steps, card vs CPU
STATE_ERR_TOL = 1e-2                # a lossy state checkpoint: of a leaf's largest |value|
ENCODE_LOOKUP, PACK_STREAM = "huffman_encode.encode_lookup", "huffman_encode.pack_stream"
LOSSY_KERNELS = ("zfp_block.compress_blocks", "zfp_block.decompress_blocks", "histogram.histogram",
                 "huffman_encode.encode_lookup", "huffman_decode.decode_chunks")
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
ABS_BLOCK = (4, 4, 4)                # locality's blocks (ZFP's)
ABS_HALO_EDGE = 128                 # the 128^3 cut of locality with a halo
ABS_MGARD_EB = 1e-2                 # mgard.compress's absolute bound on the 512^3 field
ABS_TIMED_RUNS = 5
EXAMPLE_EDGE = 64                   # quickstart's field, the reference's n
EXAMPLE_TRAIN = {"small": 200, "100m": 20}   # the examples' --steps: the reference's default, a cut
GAP_CUT_PLANES = 64                 # the single-phase stream's cut: 64 x 512 x 512 float32, 64 MiB
GAP_CHUNK_ELEMS = 4 << 20           # its chunking: four (64, 128, 512) chunks along axis 1
GAP_WIDE_EDGE = 65                  # the numpy float64 field of the standalone API
GAP_PAD_SHAPES = ((61, 62, 63), (1, 2, 5))   # padded by 3, 2 and 1; dims of 1 and 2
PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap", "maximum", "minimum", "mean",
             "median", "linear_ramp", "empty")
HELD_KERNELS = ("zfp_block.compress_blocks", "zfp_block.decompress_blocks", "histogram.histogram",
                "huffman_encode.encode_lookup", "huffman_encode.pack_stream",
                "huffman_decode.decode_chunks",
                "quantize_map.quantize", "quantize_map.dequantize", "tridiag.solve_mass")
HUFF_KERNELS = {  # name: (TPU kernel it replaces, CUDA source)
    "histogram.histogram": ("src/repro/kernels/histogram/kernel.py:39",
                            "src/repro_torch/kernels/histogram/csrc/histogram.cu"),
    "huffman_encode.encode_lookup": (
        "src/repro/kernels/huffman_encode/kernel.py:31",
        "src/repro_torch/kernels/huffman_encode/csrc/huffman_encode.cu"),
    "huffman_encode.pack_stream": (
        "no TPU kernel (XLA in the reference: src/repro/kernels/huffman_encode/ref.py:21)",
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


def local_leaves(tree) -> dict:
    """``{key: leaf}`` of ``tree`` with ``::`` keys, a placed leaf (DTensor)
    as its local block (on a 1 x 1 mesh: the whole tensor)."""
    from repro_torch.core import api
    from repro_torch.runtime.sharding import is_placed

    return {k: x.to_local() if is_placed(x) else x for k, x in api.flatten_with_keys(tree, "::")}


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


def decode_step_ms(eng) -> float:
    """One decode step of a served engine, median of TIMED_RUNS (host wall,
    synchronised), at the engine's shared cache_len."""
    import numpy as np

    step_toks = np.zeros(SERVE_BATCH, np.int32)
    return median_wall_ms(lambda: eng._step(step_toks, int(eng.lens.max())))


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
    """Phase 2, Huffman: histogram, encode_lookup, pack_stream (at each of
    CHECK_CHUNKS) and decode_chunks against their plain versions on the card
    (tolerance 0)."""
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
        num_words = max(1, -(-int(ep[1].to(torch.int64).sum()) // 32))
        for chunk in CHECK_CHUNKS:
            got = enc_kernel.pack_stream(*ek, num_words, chunk)
            want = enc_ref.pack_stream(*ep, num_words, chunk)
            errs[f"pack_stream, chunk {chunk}"] = max(int_err(got[0], want[0]),
                                                      int_err(got[1], want[1]))
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
    log(f"phase 2 ok: histogram, encode_lookup, pack_stream (chunks {CHECK_CHUNKS}) == plain "
        f"versions on the card for {checked} "
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
    """histogram, encode_lookup, pack_stream and decode_chunks against their
    plain versions on one main-path run's keys (alphabet ``nb``) and
    container ``c``, whose codebook must be the one these keys give, and
    pack_stream against the container's words and chunk offsets too
    (tolerance 0)."""
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
    packed = enc_kernel.pack_stream(codes, lens, words.numel(), chunk)
    plain = enc_ref.pack_stream(pc, pl, words.numel(), chunk)
    errs = {
        "histogram.histogram": int_err(freq, hist_ref.histogram(keys, nb)),
        "huffman_encode.encode_lookup": max(int_err(codes, pc), int_err(lens, pl)),
        "huffman_encode.pack_stream": max(
            int_err(packed[0], plain[0]), int_err(packed[1], plain[1]),
            int_err(packed[0], words), int_err(packed[1], offsets)),
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
    library calls, codebook and end to end."""
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
        "huffman_encode.pack_stream": median_ms(
            lambda: enc_kernel.pack_stream(codes, lens, num_words, chunk)),
        "huffman_decode.decode_chunks": median_ms(
            lambda: dec_kernel.decode_chunks(words, offsets, *tables, chunk, max_len)),
    }
    plain_ms = {
        "histogram.histogram": median_ms(lambda: hist_ref.histogram(keys, nb)),
        "huffman_encode.encode_lookup": median_ms(
            lambda: enc_ref.encode_lookup(keys, codes_t, lens_t)),
        "huffman_encode.pack_stream": median_ms(
            lambda: enc_ref.pack_stream(codes, lens, num_words, chunk)),
        "huffman_decode.decode_chunks": median_ms(
            lambda: dec_ref.decode_chunks(words, offsets, *tables, chunk, max_len),
            runs=1, warmup=0),
    }
    library_ms = {
        "histogram.histogram": median_ms(lambda: torch.bincount(keys, minlength=nb)),
        "huffman_encode.encode_lookup": median_ms(lambda: (codes_t[keys], lens_t[keys])),
        "huffman_encode.pack_stream": None,
        "huffman_decode.decode_chunks": None,
    }
    freq_np = run["freq"].cpu().numpy()
    codebook_ms = median_wall_ms(lambda: huffman.build_codebook(freq_np))
    e2e_compress = median_wall_ms(lambda: api.compress_leaf(x, method))
    e2e_decompress = median_wall_ms(lambda: api.decompress_leaf(c))

    moved = {  # each input read once, each output written once
        "histogram.histogram": 4 * n + 4 * nb,
        "huffman_encode.encode_lookup": 12 * n + 8 * nb,
        "huffman_encode.pack_stream": pack_bytes(n, num_words, n_chunks),
        "huffman_decode.decode_chunks": decode_bytes(run),
    }
    ops = {  # integer operations on this run's data
        "histogram.histogram": 4 * n,             # range check, match, popcount, add
        "huffman_encode.encode_lookup": 4 * n,    # clamp, two probes, store
        "huffman_encode.pack_stream": 8 * n,      # scan, mask, two shifts, two ORs, stores
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
    log(f"phase 5 [{card}] {run['name']}: host codebook build {codebook_ms:.4f} ms (wall, "
        f"alphabet {nb})")
    log(f"phase 5 [{card}] {run['name']} one profiled call: encode stages {enc_stages} s, "
        f"transfers {enc_moved.as_dict()}; decode stages {dec_stages} s, "
        f"transfers {dec_moved.as_dict()}")
    nbytes = x.numel() * x.element_size()
    log(f"phase 5 [{card}] {run['name']} end to end (host wall, synchronised): "
        f"compress_leaf {e2e_compress:.4f} ms ({nbytes / e2e_compress / 1e6:.1f} GB/s of input), "
        f"decompress_leaf {e2e_decompress:.4f} ms ({nbytes / e2e_decompress / 1e6:.1f} GB/s "
        "of output)")
    return out


def pack_bytes(n: int, num_words: int, n_chunks: int) -> int:
    """pack_stream's least traffic: codes and lengths read once, words and
    chunk offsets written once."""
    return 8 * n + 4 * num_words + 4 * n_chunks


def pack_timings(name: str, codes, lens, num_words: int, chunk: int, card: str) -> None:
    """Phase 5: pack_stream on one main-path run's codes in events around a
    call (median of TIMED_RUNS) and in device time (its three kernels,
    torch.profiler), beside its bound and the plain version."""
    from repro_torch.kernels.huffman_encode import kernel as enc_kernel
    from repro_torch.kernels.huffman_encode import ref as enc_ref

    n = codes.numel()
    ms = median_ms(lambda: enc_kernel.pack_stream(codes, lens, num_words, chunk))
    # two calls profiled, the second's three kernels kept: a session now and
    # then misses its first device event
    device = kernel_device_ms(lambda: [enc_kernel.pack_stream(codes, lens, num_words, chunk)
                                       for _ in range(2)], ("pack_",))[-3:]
    plain_ms = median_ms(lambda: enc_ref.pack_stream(codes, lens, num_words, chunk), runs=3)
    bound_ms = pack_bytes(n, num_words, -(-n // chunk)) / HBM_BYTES_PER_S * 1e3
    dev = (f"{sum(device):.4f} ms in {len(device)} kernels "
           f"({', '.join(f'{t:.4f}' for t in device)})" if len(device) == 3 else
           f"not measured ({len(device)} kernel events)")
    log(f"phase 5 [{card}] {name} huffman_encode.pack_stream at {n} symbols ({num_words} words, "
        f"chunk {chunk}): kernel {ms:.4f} ms (events), device {dev}, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), {bound_ms / ms:.1%} of the bound")


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


DECODE_SIDE = ("huffman_decode.decode_chunks", "quantize_map.dequantize", "tridiag.solve_mass")


@contextlib.contextmanager
def held_to_plain(names: tuple[str, ...] = DECODE_SIDE):
    """While the block runs, every call of the kernel wrappers of ``names``
    (by default the decode side's: ``decode_chunks``, ``dequantize``,
    ``solve_columns``; ZFP's by both their block and field forms), wherever
    the port holds them (module attributes, the adapters' registry), also
    runs the plain version on the same inputs; yields kernel name ->
    [calls, largest |kernel - plain|].  The plain runs launch nothing that
    is counted."""
    import threading

    from repro_torch.core import adapters
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ref as hr
    from repro_torch.kernels.huffman_decode import kernel as dk
    from repro_torch.kernels.huffman_decode import ref as dr
    from repro_torch.kernels.huffman_encode import kernel as ek
    from repro_torch.kernels.huffman_encode import ref as er
    from repro_torch.kernels.quantize_map import kernel as qk
    from repro_torch.kernels.quantize_map import ref as qr
    from repro_torch.kernels.tridiag import kernel as tk
    from repro_torch.kernels.tridiag import ref as tr
    from repro_torch.kernels.zfp_block import kernel as zk
    from repro_torch.kernels.zfp_block import ref as zr

    table = {
        "zfp_block.compress_blocks": [(zk.compress_blocks, zr.compress_blocks),
                                      (zk.compress_field, zr.compress_field)],
        "zfp_block.decompress_blocks": [(zk.decompress_blocks, zr.decompress_blocks),
                                        (zk.decompress_field, zr.decompress_field)],
        "histogram.histogram": [(hk.histogram, hr.histogram)],
        "huffman_encode.encode_lookup": [(ek.encode_lookup, er.encode_lookup)],
        "huffman_encode.pack_stream": [(ek.pack_stream, er.pack_stream)],
        "huffman_decode.decode_chunks": [(dk.decode_chunks, dr.decode_chunks)],
        "quantize_map.quantize": [(qk.quantize, qr.quantize)],
        "quantize_map.dequantize": [(qk.dequantize, qr.dequantize)],
        "tridiag.solve_mass": [(tk.solve_columns, tr.sweep_columns)],
    }
    pairs = [(name, k, plain) for name in names for k, plain in table[name]]
    seen = {name: [0, 0.0] for name in names}
    lock = threading.Lock()

    def err_of(out, want) -> float:
        if isinstance(out, tuple):
            return max(err_of(o, w) for o, w in zip(out, want))
        return max_abs_err(out, want) if out.is_floating_point() else int_err(out, want)

    def spy(name, kernel_fn, plain_fn):
        def run(*args, **kwargs):
            out = kernel_fn(*args, **kwargs)
            err = err_of(out, plain_fn(*args, **kwargs))
            with lock:
                seen[name][0] += 1
                seen[name][1] = max(seen[name][1], err)
            return out
        return run

    spies = {id(k): spy(name, k, plain) for name, k, plain in pairs}
    kernels = {id(k): k for _name, k, _plain in pairs}
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
            "huffman_encode.pack_stream": 1,
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
        f"encode_lookup, pack_stream, decode_chunks on this run's {entropy_keys.numel()} keys (alphabet "
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
            **{k: ent[k] for k in ("words", "offsets", "tables", "chunk", "codes", "lens")}}


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
    pack_timings(run["name"], run["codes"], run["lens"], run["words"].numel(), run["chunk"], card)
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
    kernel not at all.  ``pack_stream`` packs what each ``encode_lookup``
    launch encoded: where ``want`` does not name it, it launches as often."""
    want = {PACK_STREAM: want.get(ENCODE_LOOKUP, 0), **want}
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
    with engine_mod.ExecutionEngine(devices=[torch.device("cpu")], backend="torch") as cpu_eng:
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


def reset_peak(what: str) -> int:
    """Collect garbage (an earlier phase's tensors held in reference cycles
    go now, not inside the next measurement), reset the card's peak
    memory counter and log what is still allocated; returns that."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    log(f"{what}: {held} bytes allocated on the card before it")
    return held


def counted(what: str, fn, want):
    """``fn()`` with every counter zeroed just before and read just after;
    the launches must be ``want`` (or ``want(result)``) where it is given."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    if want is not None:
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
    pipe = pl.ChunkedPipeline(lambda chunk: chunk, mode="fixed",
                              c_fixed_elems=tuned["chunk_elems"], devices=[device])
    return axis, pipe._row_schedule(leaf, axis)


def streamed_parts(api, leaf, tuned: dict, device, rate: int):
    """``leaf`` cut as the stream cuts it: yields ``(axis, start, rows, the
    chunk through the one-shot api.compress/decompress)``, the stream's
    decode a chunk at a time."""
    axis, rows = stream_rows(leaf, tuned, device)
    start = 0
    for r in rows:
        yield axis, start, r, api.decompress(api.compress(leaf.narrow(axis, start, r), "zfp",
                                                          rate=rate))
        start += r


def streamed_decode(api, leaf, tuned: dict, device, rate: int):
    """The chunks of :func:`streamed_parts` concatenated (the stream's decode)."""
    import torch

    parts = list(streamed_parts(api, leaf, tuned, device, rate))
    return torch.cat([p for _a, _s, _r, p in parts], dim=parts[0][0])


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


def zfp_buckets(api, tree, select=None) -> int:
    """The ZFP buckets of ``tree`` under ``select`` (default: the default
    policy), one kernel launch each: its ZFP leaves' distinct post-policy
    specs."""
    specs = set()
    for key, x in api.flatten_with_keys(tree):
        choice = (select or api.default_select)(key, x)
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
    """Restored KV pages on the card (every leaf of the tree ``cache``), in
    shape and dtype, within ZFP's error at the parking rate (KV_ERR_TOL of
    the page's largest magnitude)."""
    import torch

    from repro_torch.core import api

    worst = 0.0
    flat = dict(api.flatten_with_keys(restored))
    for k, x in api.flatten_with_keys(cache):
        got = flat[k]
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


def check_decode_vs_cpu(what: str, cut, params: dict, cpu_params: dict, toks, device,
                        steps: int = 3) -> dict:
    """``steps`` decode steps of the model ``cut`` on the card against the
    CPU path on the same weights and tokens, in each dtype of
    SERVE_CHECK_TOL: the last logits within its share of 1 + max |logit|.
    Returns dtype -> (max |difference|, bound)."""
    from dataclasses import replace

    import torch

    from repro_torch.models import build_model

    diffs = {}
    for dtype, tol in SERVE_CHECK_TOL.items():
        m = build_model(replace(cut, dtype=dtype))
        outs = []
        for p, dev in ((params, device), (cpu_params, torch.device("cpu"))):
            cache = m.init_cache(toks.shape[0], 64, torch.float32, dev)
            for step in range(steps):
                logits, cache = m.decode_step(p, toks.to(dev), cache, step)
            outs.append(logits.float().cpu())
        ref = outs[1]
        diff = float((outs[0] - ref).abs().max())
        bound = tol * (1.0 + float(ref.abs().max()))
        if not diff <= bound:
            raise PhaseError(f"{what} ({cut.name}, {dtype}, depth {cut.n_layers}): card vs CPU "
                             f"max |logit difference| {diff:.4e} > {bound:.4e}")
        diffs[dtype] = (diff, bound)
    return diffs


def phase_serving(device, api, prog: dict, st: dict, card: str) -> dict:
    """Phase 3, serving: qwen2.5-3b (hf:Qwen/Qwen2.5-3B) at full width and
    SERVE_LAYERS of its 36 layers through ``ServingEngine`` (batch 4, 8192
    positions, float32 cache, bfloat16 compute over float32 weights from
    the seed): 8 requests of 32 prompt tokens and 16 new tokens, twice on
    two engines (same tokens); one decode step on the card against the CPU
    path on a depth-2 cut.  Then
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
    cfg = replace(get_config("qwen2.5-3b"), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 60), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(api.flatten_with_keys(params))
    n_params = sum(v.numel() for v in leaves.values())
    log(f"phase 3 serving: qwen2.5-3b ({cfg.n_layers} of 36 layers, d_model {cfg.d_model}, "
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
    diffs = check_decode_vs_cpu("decode_step", replace(cfg, n_layers=SERVE_CHECK_LAYERS), cut,
                                cpu_cut, toks, device)
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
    log(f"phase 5 [{card}] serving qwen2.5-3b ({SERVE_LAYERS} of 36 layers), batch "
        f"{SERVE_BATCH}, cache {SERVE_MAX_LEN} "
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def checkpoint_chunks(leaf, entry: dict, device) -> int:
    """Containers the manager writes for ``leaf``: the streamed leaf's chunks
    (at its tuned plan, or the fixed lossless chunk), else one."""
    from repro_torch.checkpoint import manager as ckpt_manager

    if not entry.get("stream"):
        return 1
    if "tuned" in entry:
        return len(stream_rows(leaf, entry["tuned"], device)[1])
    elems = ckpt_manager.LOSSLESS_CHUNK_BYTES // leaf.element_size()
    return len(stream_rows(leaf, {"chunk_elems": elems}, device)[1])


def checkpoint_want(flat: dict, manifest: dict, policy, restore: bool, device) -> dict:
    """The launches one save (or restore) of ``flat`` under ``policy`` makes:
    per container, one ``compress_blocks`` (``decompress_blocks``) for a zfp
    leaf or chunk, one ``histogram`` and one ``encode_lookup`` (one
    ``decode_chunks``) for a ``huffman-bytes`` one.  Under ``exact`` every
    leaf is ``huffman-bytes``; else a float leaf of ``lossless_small``
    elements or more is zfp (streamed: its tuned chunks)."""
    zfp = huff = 0
    for k, x in flat.items():
        n = checkpoint_chunks(x, manifest["leaves"][k], device)
        if policy.exact or not x.dtype.is_floating_point or x.numel() < policy.lossless_small:
            huff += n
        else:
            zfp += n
    if restore:
        want = {"zfp_block.decompress_blocks": zfp, "huffman_decode.decode_chunks": huff}
    else:
        want = {"zfp_block.compress_blocks": zfp, "histogram.histogram": huff,
                "huffman_encode.encode_lookup": huff}
    return {k: n for k, n in want.items() if n}


@contextlib.contextmanager
def counted_checkpoints(calls: dict, errs: dict, timings: list, device, probe: str | None = None,
                        hold: tuple[str, ...] = ()):
    """Every ``CheckpointManager.save``/``restore`` while the block runs (on
    any thread: ``save_async`` saves on the engine's io lane) counted
    exactly: the counters zeroed just before the call and read just after,
    against :func:`checkpoint_want`; each call's wall seconds in
    ``timings``.  Inside the same call, the kernels of ``hold`` are held to
    their plain versions on every launch (:func:`held_to_plain`; the
    seconds then include the plain runs), and the entropy kernels to theirs
    on the keys and the container of leaf ``probe`` — of its first chunk,
    where the leaf is streamed."""
    import torch

    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.core import api
    from repro_torch.core.container import Compressed
    from repro_torch.runtime.io import AggregatedReader

    cls = ckpt_manager.CheckpointManager
    save, restore = cls.save, cls.restore

    def probe_entropy(name: str, mgr, manifest: dict, x) -> None:
        step_dir = mgr.dir / f"step_{manifest['step']:08d}"
        entry = manifest["leaves"][probe]
        with AggregatedReader(step_dir / manifest["aggregate"]) as r:
            raw = r.read(entry["segment"])
        if entry.get("stream"):
            res = api.CompressorStream.from_bytes(raw)
            ends = res.boundaries + [x.shape[res.axis]]
            c, x = res.chunks[0], x.narrow(res.axis, ends[0], ends[1] - ends[0])
            if x.numel() * x.element_size() != ckpt_manager.LOSSLESS_CHUNK_BYTES:
                raise PhaseError(f"{name}: {probe}'s first chunk is {x.numel()} elements, not "
                                 f"a full {ckpt_manager.LOSSLESS_CHUNK_BYTES}-byte chunk")
        else:
            c = Compressed.from_bytes(raw)
        if c.method != "huffman-bytes":
            raise PhaseError(f"{name}: leaf {probe} went through {c.method}")
        ent = check_entropy_kernels(f"{name} {probe}", policy_keys(x, "huffman-bytes"), 256, c,
                                    device)
        for k, v in ent["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)

    def checked(name: str, counts: dict, want: dict, held: dict) -> None:
        check_counts(name, counts, want)
        for k in hold:
            n, e = held[k]
            if n < counts[k] or e:
                raise PhaseError(f"{name}: {k} held to its plain version in {n} calls for "
                                 f"{counts[k]} launches, max |kernel - plain| {e}")
            errs[k] = max(errs.get(k, 0.0), e)

    def run(fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with held_to_plain(hold) as held:
            out = fn()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return out, seconds, read_counts(), held

    def policy_name(self) -> str:
        return ("exact" if self.policy.exact else "zfp") + (", held" if hold else "")

    def counted_save(self, step, tree, extra=None):
        manifest, seconds, counts, held = run(lambda: save(self, step, tree, extra))
        name = f"CheckpointManager.save (step {step}, {policy_name(self)})"
        flat = local_leaves(tree)
        checked(name, counts, checkpoint_want(flat, manifest, self.policy, False, device), held)
        calls[name] = counts
        timings.append((name, seconds, manifest["raw_bytes"], manifest["compressed_bytes"]))
        if probe is not None:
            probe_entropy(name, self, manifest, flat[probe])
        return manifest

    def counted_restore(self, step=None, *args, **kwargs):
        (tree, manifest), seconds, counts, held = run(
            lambda: restore(self, step, *args, **kwargs))
        name = f"CheckpointManager.restore (step {manifest['step']}, {policy_name(self)})"
        flat = local_leaves(tree)
        checked(name, counts, checkpoint_want(flat, manifest, self.policy, True, device), held)
        calls[name] = counts
        timings.append((name, seconds, manifest["raw_bytes"], manifest["compressed_bytes"]))
        if probe is not None:
            probe_entropy(name, self, manifest, flat[probe])
        return tree, manifest

    cls.save, cls.restore = counted_save, counted_restore
    try:
        yield
    finally:
        cls.save, cls.restore = save, restore


def check_grads_close(what: str, card: dict, cpu: dict, tol: float) -> float:
    """Every gradient leaf on the card within ``tol`` of the CPU's largest
    |gradient| in that leaf; the key bias, whose exact gradient is 0
    (softmax ignores a shift common to a query's scores), against the
    query bias's largest |gradient| (both its values are rounding noise).
    Returns the worst share."""
    worst = 0.0
    for k, g in cpu.items():
        ref = cpu[k.replace("wk::b", "wq::b")] if k.endswith("attn::wk::b") else g
        diff = float((card[k].float().cpu() - g).abs().max())
        share = diff / max(float(ref.abs().max()), 1e-30)
        if not share <= tol:
            raise PhaseError(f"{what} {k}: card vs CPU max |difference| {diff:.4e} = {share:.4e} "
                             f"of the largest |gradient| > {tol}")
        worst = max(worst, share)
    return worst


def check_step_vs_cpu(what: str, cut, params: dict, cpu_params: dict, batches: dict,
                      device, dtypes: tuple = tuple(TRAIN_CHECK_TOL)) -> dict:
    """``value_and_grad`` of the model ``cut`` on the card against the CPU,
    on the same weights and batch, in each of ``dtypes`` (TRAIN_CHECK_TOL's
    by default): the
    loss within its share of the CPU's, each gradient leaf within its share
    of the CPU's largest |gradient| in that leaf.  Returns dtype -> (CPU
    loss, loss difference share, worst gradient share, CPU seconds)."""
    from dataclasses import replace

    from repro_torch.core import api
    from repro_torch.models import build_model

    cpu = next(iter(api.flatten_with_keys(cpu_params)))[1].device
    diffs = {}
    for dtype in dtypes:
        ltol, gtol = TRAIN_CHECK_TOL[dtype]
        m = build_model(replace(cut, dtype=dtype))
        (l_card, _), g_card = m.value_and_grad(params, batches[device])
        t0 = time.perf_counter()
        (l_cpu, _), g_cpu = m.value_and_grad(cpu_params, batches[cpu])
        cpu_s = time.perf_counter() - t0
        ldiff = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        if not ldiff <= ltol:
            raise PhaseError(f"{what} ({dtype}, depth {cut.n_layers}): card loss "
                             f"{float(l_card)} vs CPU {float(l_cpu)}: {ldiff:.4e} > {ltol}")
        worst = check_grads_close(f"{what} ({dtype})", dict(api.flatten_with_keys(g_card, "::")),
                                  dict(api.flatten_with_keys(g_cpu, "::")), gtol)
        diffs[dtype] = (float(l_cpu), ldiff, worst, cpu_s)
        del g_card, g_cpu
    return diffs


def step_diffs_text(diffs: dict) -> str:
    return ", ".join(
        f"{k} loss {v[0]:.6f} within {v[1]:.4e} (<= {TRAIN_CHECK_TOL[k][0]}), gradients within "
        f"{v[2]:.4e} of each leaf's largest |gradient| (<= {TRAIN_CHECK_TOL[k][1]}; CPU step "
        f"{v[3]:.1f} s)" for k, v in diffs.items())


@contextlib.contextmanager
def resized(T, cut):
    """``train.get_config`` returns ``cut`` while the block runs (the
    reference example's way to resize a run)."""
    original = T.get_config
    T.get_config = lambda name: cut
    try:
        yield
    finally:
        T.get_config = original


def check_resume(T, arch: str, cut, calls: dict, errs: dict, timings: list, device,
                 probe: str, ckpt_dir: Path, label: str, **loop_kw) -> tuple:
    """A resume of ``train_loop(arch)`` at the config ``cut`` (``train.get_config``
    patched, the reference example's way to resize a run) under
    ``torch.use_deterministic_algorithms``: runs A and A again, B (an exact
    checkpoint at step RESUME_EVERY, ``sync_ckpt``, a failure injected at
    RESUME_FAIL_AT) and C restarting on B's directory (``save_async`` of the
    last step and ``wait()``); C's losses and final state must be A's bit for
    bit (or, were an op nondeterministic, within the spread of the two A
    runs).  Every save and restore counted exactly, the entropy kernels held
    to their plain versions inside each on ``probe``'s keys
    (:func:`counted_checkpoints`).  Returns ``(C's result, a summary for the
    log)``."""
    import warnings

    import torch

    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.core import api

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    kw = dict(steps=TRAIN_STEPS, smoke=False, log_every=TRAIN_STEPS, **loop_kw)
    try:
        with resized(T, cut), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = []
            for i in range(2):
                run, calls[f"train_loop {label}{i + 1} (depth {cut.n_layers}, no checkpoint)"] = \
                    counted(f"train_loop {label}{i + 1}", lambda: T.train_loop(arch, **kw), {})
                runs.append(run)
            with counted_checkpoints(calls, errs, timings, device, probe):
                try:
                    T.train_loop(arch, ckpt_dir=str(ckpt_dir), ckpt_every=RESUME_EVERY,
                                 sync_ckpt=True, inject_failure_at=RESUME_FAIL_AT, **kw)
                except RuntimeError as e:
                    if str(e) != f"injected failure at step {RESUME_FAIL_AT}":
                        raise
                else:
                    raise PhaseError(f"train_loop {arch} B: the injected failure was not raised")
                c = T.train_loop(arch, ckpt_dir=str(ckpt_dir), ckpt_every=RESUME_EVERY, **kw)
        nondet = sorted({str(w.message)[:200] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(deterministic)
    a1, a2 = runs
    fa1, fa2 = (local_leaves(r["state"]) for r in runs)
    fc = local_leaves(c["state"])
    spread = max(float((fa1[k].double() - fa2[k].double()).abs().max()) for k in fa1)
    same_a = a1["losses"] == a2["losses"] and spread == 0.0
    if c["steps_run"] != TRAIN_STEPS - RESUME_EVERY or not all(c["finite"]):
        raise PhaseError(f"train_loop {arch} C: ran {c['steps_run']} steps, finite {c['finite']}")
    if not nondet and same_a:
        bad = [k for k in fa1 if not same_bits(fa1[k], fc[k])]
        if c["losses"] != a1["losses"][RESUME_EVERY:] or bad:
            raise PhaseError(f"resume {arch}: C's losses {c['losses']} vs A's "
                             f"{a1['losses'][RESUME_EVERY:]}, leaves differing {bad[:5]}")
        verdict = "bit for bit"
    else:  # an op without a deterministic implementation: hold C within A's spread
        cspread = max(float((fa1[k].double() - fc[k].double()).abs().max()) for k in fa1)
        if not cspread <= spread:
            raise PhaseError(f"resume {arch}: C differs from A by {cspread:.4e}, beyond the "
                             f"spread of two A runs {spread:.4e} (ops: {nondet})")
        verdict = f"within the spread of two A runs ({spread:.4e}; ops {nondet})"
    summary = (
        f"{arch} under torch.use_deterministic_algorithms: A1 == A2 ({same_a}); B saved step "
        f"{RESUME_EVERY} (exact, sync) and raised the injected failure at step {RESUME_FAIL_AT}; "
        f"C restored step {RESUME_EVERY}, ran steps {RESUME_EVERY}-{TRAIN_STEPS - 1} (losses "
        f"{[round(x, 4) for x in c['losses']]}) and saved step {TRAIN_STEPS} with save_async + "
        f"wait(); C's losses and final parameters, moments and step == A's {verdict}; every save "
        f"and restore's launches exact, the entropy kernels == plain inside each on the "
        f"{min(fa1[probe].numel() * fa1[probe].element_size(), ckpt_manager.LOSSLESS_CHUNK_BYTES)} "
        f"byte keys of {probe} (its first chunk where it streams)")
    return c, summary


def phase_training(device, api, card: str, mesh) -> dict:
    """Phase 3 and 5, training: ``train_loop`` of qwen2.5-3b at full width and
    depth (36 layers, 3.09B float32 parameters from the seed, bfloat16
    compute, float32 moments, batch 8 x 128, 6 steps, no checkpoint) with
    its peak memory, step times, tokens/s and model-FLOP share; one step
    under ``torch.profiler``; a depth-2 full-width step on the card against
    the same step on the CPU (float32 and bfloat16); a bit-exact resume at
    depth 2 from an exact checkpoint, placed on ``mesh`` (runs A, A again,
    B failing at step 4 after the step-3 save, C restarting on B's
    directory, restoring onto the placements and saving asynchronously at
    step 6) under deterministic algorithms, every save and restore counted
    exactly with the entropy kernels held to their plain versions inside
    the call on a full 128 MiB chunk of the embedding; and C's placed state
    saved with the default zfp policy and restored onto its placements,
    every kernel launch inside both calls held to its plain version, each
    leaf held to the one-shot or streamed decode.  Returns the calls and
    errors, and the full-size run's losses, step times, peak and final
    parameters (a host copy) for the placed phase."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.checkpoint import CheckpointPolicy
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch import train as T
    from repro_torch.models import build_model, load_params
    from repro_torch.optim import adamw, schedule
    from repro_torch.runtime import roofline

    calls, errs = {}, {}
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"(phase 3 training, {what}: {now - clock[0]:.1f} s)")
        clock[0] = now

    # -- qwen2.5-3b at full width and depth --------------------------------
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(model.param_shapes()))
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_peak(f"train_loop {TRAIN_ARCH}")
    t0 = time.perf_counter()
    out, calls["train_loop (full, 6 steps)"] = counted(
        "train_loop (full, 6 steps)", lambda: T.train_loop(
            TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, smoke=False,
            log_every=1), {})
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, finite = out["losses"], out["finite"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses) or not all(finite):
        raise PhaseError(f"train_loop (full): losses {losses}, finite {finite}")
    unplaced = {"losses": losses, "step_s": out["step_s"], "peak": peak,
                "params": {k: x.cpu() for k, x in local_leaves(out["state"]["params"]).items()}}
    step_s = statistics.median(out["step_s"][-TRAIN_TIMED:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    counts = roofline.count_params(model.param_shapes())
    flops = roofline.model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                 counts)["model_flops"]
    log(f"phase 3 ok: train_loop({TRAIN_ARCH!r}, smoke=False, steps={TRAIN_STEPS}, "
        f"batch={TRAIN_BATCH}, seq={TRAIN_SEQ}): {cfg.n_layers} layers, {n_params} float32 "
        f"parameters, bfloat16 compute, float32 moments; losses {[round(x, 4) for x in losses]} "
        f"all finite, every step's update applied; no kernel launched")
    log(f"phase 5 [{card}] training {TRAIN_ARCH} full width and depth, {tokens} tokens a step: "
        f"step times {[round(x * 1e3, 2) for x in out['step_s']]} ms (host wall, each ending in "
        f"the loss's read); median of the last {TRAIN_TIMED} {step_s * 1e3:.4f} ms = "
        f"{tokens / step_s:.3f} tokens/s; model FLOPs (6·N·D + attention, N = {counts['other']} "
        f"without the embedding) {flops:.6e} a step = {flops / step_s / 1e12:.4f} TFLOP/s, "
        f"{flops / step_s / roofline.PEAK_FLOPS:.4f} of {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; "
        f"peak torch.cuda.max_memory_allocated {peak} bytes; the run {wall_s:.2f} s with init")
    lap("full-size train_loop")

    # one step under the profiler, on the run's own state
    state = out.pop("state")
    step_fn = T.make_train_step(model, adamw.AdamWConfig(), schedule.cosine, 3e-4, TRAIN_STEPS)
    batch = SyntheticLMStream(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH), device).next_batch()
    trace = device_trace(lambda: step_fn(state["params"], state["opt"], batch), top=8)
    busy, wall = trace["busy_ms"], trace["wall_ms"]
    log(f"phase 5 [{card}] one train step under torch.profiler: {trace['launches']} device "
        f"launches (kernels and copies), device busy {busy:.4f} ms of that call's {wall:.4f} ms "
        f"(host wall, synchronised, profiler included; idle share {1 - busy / wall:.4f}); by "
        "time: " + ", ".join(f"{name[:60]} x{n} {ms:.4f} ms" for name, n, ms in trace["top"]))
    del state, batch, out, step_fn
    torch.cuda.empty_cache()
    lap("traced step")

    # -- a depth-2 full-width step on the card against the CPU -------------
    cut = replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    params = build_model(cut).init(torch.Generator(device=device).manual_seed(SEED + 70), device)
    cpu = torch.device("cpu")
    cpu_params = load_params(params, cpu)
    window = torch.from_numpy(np.random.default_rng(SEED + 71).integers(
        0, cfg.vocab, (TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ + 1)).astype(np.int32))
    batches = {dev: {"tokens": window[:, :-1].to(dev), "labels": window[:, 1:].to(dev)}
               for dev in (device, cpu)}
    diffs = check_step_vs_cpu(f"train step {TRAIN_ARCH}", cut, params, cpu_params, batches,
                              device)
    del params, cpu_params
    torch.cuda.empty_cache()
    log(f"phase 3 ok: a train step (loss and every gradient), depth-{TRAIN_CUT_LAYERS} cut at full "
        f"width, batch {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, card vs CPU (no TF32): "
        + step_diffs_text(diffs))
    lap("card vs CPU step")

    # -- resume at depth 2, bit for bit, from exact checkpoints ------------
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-train-")
    root = Path(tmp.name)
    timings: list = []
    probe = "params::embed::table"  # streamed in 128 MiB chunks: 2^27 byte keys each
    c, summary = check_resume(T, TRAIN_ARCH, cut, calls, errs, timings, device, probe,
                              root / "ck", "A", mesh=mesh)
    log(f"phase 3 ok: resume at depth {TRAIN_CUT_LAYERS}, full width, placed on the "
        f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} mesh (parameters and moments by "
        "param_shardings, step replicated, C restored onto those placements), " + summary)
    torch.cuda.empty_cache()
    lap("resume")

    # -- C's state through the default (zfp) policy -------------------------
    summary = check_state_checkpoint(TRAIN_ARCH, CheckpointPolicy(), c["state"], calls, errs,
                                     timings, device, root / "lossy",
                                     places=placements_of(c["state"]))
    log("phase 3 ok: C's placed state, with the default policy, restored onto its placements, "
        + summary)
    log(f"phase 5 [{card}] checkpoints of the depth-{TRAIN_CUT_LAYERS} training state (host wall, "
        "synchronised, one run each; filesystem " + fs_type(root) + "; a held call's seconds "
        "include its plain versions): " + ", ".join(
            f"{name} {s:.3f} s ({raw} bytes -> {comp}, {raw / s / 1e9:.3f} GB/s of the state)"
            for name, s, raw, comp in timings))
    del c
    tmp.cleanup()
    torch.cuda.empty_cache()
    lap("lossy checkpoint")
    return {"calls": calls, "errs": errs, "unplaced": unplaced}


def placed_vs_unplaced(what: str, out: dict, ref: dict, tol: tuple, device,
                       exact: bool) -> tuple:
    """A placed run's losses and final parameters against the unplaced
    run's (``ref``: losses and a host copy of the parameters): the largest
    loss difference relative to the unplaced loss, the largest parameter
    difference relative to the leaf's largest |value|; with ``exact``
    every loss and every parameter equal bit for bit, else each within its
    share of ``tol``."""
    ldiff = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"]))
    worst, where, differ = 0.0, "every leaf equal", []
    for k, x in local_leaves(out["state"]["params"]).items():
        want = ref["params"][k].to(device)
        if not same_bits(x, want):
            differ.append(k)
        share = float((x.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)
        if share > worst:
            worst, where = share, f"at {k}"
        del want
    if exact:
        bad = out["losses"] != ref["losses"] or bool(differ)
    else:
        bad = (len(out["losses"]) != len(ref["losses"]) or not ldiff <= tol[0]
               or not worst <= tol[1])
    if bad:
        held = "bit for bit" if exact else f"within {tol}"
        raise PhaseError(f"{what}: placed losses {out['losses']} vs unplaced {ref['losses']} "
                         f"({ldiff:.4e}), parameters within {worst:.4e} ({where}; "
                         f"{len(differ)} leaves differ), held {held}")
    return ldiff, worst, where


def phase_placed(device, api, card: str, mesh, unplaced: dict) -> dict:
    """Phase 3 and 5, the placed path on ``mesh`` (1 x 1 over the card, a
    world-size-1 NCCL group): ``train_loop(mesh=)`` of qwen2.5-3b at full
    width and depth, its parameters and moments placed by
    ``param_shardings`` and its batches ``Shard(0)`` over the data axis,
    under the ``tp`` policy (against the training phase's unplaced run)
    and under ``dp_zero1`` with the dry run's ``OPT_OVERRIDES`` for this
    arch (bfloat16 parameters; against an unplaced run of the same config):
    the losses and final parameters, the largest differences, ms a step,
    tokens/s and peak memory placed and unplaced; then, at the depth-2
    cut, ``make_prefill_step`` on placed parameters and batch against the
    unplaced step and the forward's last position, and ``make_decode_step``
    on a placed cache with ``decode_masked_update`` off and on (past the
    cache's end: the ring's wrap) against each other and the unplaced
    decode.  On a mesh whose axes all have one rank every placement is
    ``Replicate``: the placed path runs the same kernels on the same
    tensors, so the placed losses, parameters and logits must equal the
    unplaced ones bit for bit; TRAIN_CHECK_TOL (and the forward's
    comparison) holds where a mesh splits tensors."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch import train as T
    from repro_torch.launch.dryrun import opt_overrides_for
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import rms_norm
    from repro_torch.runtime import sharding as shr

    calls, errs = {}, {}
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"(phase 3 placed, {what}: {now - clock[0]:.1f} s)")
        clock[0] = now

    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tol = TRAIN_CHECK_TOL[cfg.dtype]
    exact = all(n == 1 for n in mesh.mesh.shape)
    held = "bit for bit" if exact else f"within {tol}"
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, smoke=False,
              log_every=TRAIN_STEPS)
    shape = f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}"

    def med_ms(step_s) -> float:
        return statistics.median(step_s[-TRAIN_TIMED:]) * 1e3

    for policy, overrides in (("tp", {"sharding_policy": "tp"}),
                              ("dp_zero1", opt_overrides_for(TRAIN_ARCH, "train"))):
        run_cfg = replace(cfg, **overrides)
        ref = unplaced
        if policy != "tp":  # the unplaced twin of this config
            with resized(T, run_cfg):
                reset_peak(f"train_loop {TRAIN_ARCH} {policy} unplaced")
                out, calls[f"train_loop {policy} unplaced (full, {TRAIN_STEPS} steps)"] = counted(
                    f"train_loop {policy} unplaced", lambda: T.train_loop(TRAIN_ARCH, **kw), {})
            ref = {"losses": out["losses"], "step_s": out["step_s"],
                   "peak": torch.cuda.max_memory_allocated(),
                   "params": {k: x.cpu() for k, x in local_leaves(out["state"]["params"]).items()}}
            del out
            torch.cuda.empty_cache()
        with resized(T, run_cfg):
            reset_peak(f"train_loop {TRAIN_ARCH} {policy} placed")
            out, calls[f"train_loop {policy} placed (full, {TRAIN_STEPS} steps)"] = counted(
                f"train_loop {policy} placed", lambda: T.train_loop(TRAIN_ARCH, mesh=mesh, **kw),
                {})
        peak = torch.cuda.max_memory_allocated()
        if not all(out["finite"]):
            raise PhaseError(f"train_loop {policy} placed: finite {out['finite']}")
        pl = local_leaves(out["state"]["params"])
        leaf = next(iter(api.flatten_with_keys(out["state"]["params"], "::")))[1]
        ldiff, worst, where = placed_vs_unplaced(f"train_loop {policy}", out, ref, tol, device,
                                                 exact)
        placed_ms, plain_ms = med_ms(out["step_s"]), med_ms(ref["step_s"])
        log(f"phase 3 ok: train_loop({TRAIN_ARCH!r}, mesh={shape}) under {policy} "
            f"({overrides}): {run_cfg.n_layers} layers, {run_cfg.param_dtype} parameters "
            f"placed as DTensors ({type(leaf).__name__}, e.g. {leaf.placements}); losses "
            f"{[round(x, 4) for x in out['losses']]} vs unplaced "
            f"{[round(x, 4) for x in ref['losses']]}: largest relative difference {ldiff:.4e}, "
            f"parameters within {worst:.4e} of a leaf's largest |value| ({where}); held "
            f"{held}; no kernel launched")
        log(f"phase 5 [{card}] placed training {TRAIN_ARCH} under {policy}, {tokens} tokens a "
            f"step: placed median of the last {TRAIN_TIMED} steps {placed_ms:.4f} ms = "
            f"{tokens / placed_ms * 1e3:.3f} tokens/s, peak {peak / 1e9:.3f} GB; unplaced "
            f"{plain_ms:.4f} ms = {tokens / plain_ms * 1e3:.3f} tokens/s, peak "
            f"{ref['peak'] / 1e9:.3f} GB (host wall, each step ending in the loss's read; the "
            f"difference is DTensor's host cost: {placed_ms - plain_ms:.4f} ms a step)")
        del out, pl, leaf, ref
        torch.cuda.empty_cache()
        lap(f"train_loop {policy}")
    unplaced.pop("params")

    # -- prefill and decode steps at the depth-2 cut ------------------------
    cut = replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    model = build_model(cut)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 80), device)
    toks = torch.from_numpy(np.random.default_rng(SEED + 81).integers(
        0, cut.vocab, (4, 64)).astype(np.int32)).to(device)
    with use_mesh(mesh):
        pp = T._placed(shr.param_shardings(params, cut, mesh), params)
        prompt = {"tokens": toks}
        pb = T._placed(shr.batch_shardings(prompt, cut, mesh), prompt)
        (got, calls["make_prefill_step (placed)"]) = counted(
            "make_prefill_step", lambda: S.make_prefill_step(model)(pp, pb), {})
        got = got.to_local()
    plain_prefill = S.make_prefill_step(model)(params, prompt)
    with torch.no_grad():
        h, _ = model._backbone(params, model._embed_in(params, prompt), prompt)
        want = model._head(params, rms_norm(h, params["ln_f"]["scale"], cut.norm_eps))[:, -1]
    pdiff = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    pplain = float((got.float() - plain_prefill.float()).abs().max())
    if not pdiff <= tol[0] or (exact and not same_bits(got, plain_prefill)):
        raise PhaseError(f"make_prefill_step: placed vs unplaced {pplain:.4e} (held {held}), "
                         f"vs the forward's last position {pdiff:.4e} (<= {tol[0]}?)")
    decoded = {}
    for masked in (False, True):
        m = build_model(replace(cut, decode_masked_update=masked))
        step = S.make_decode_step(m)
        cache = m.init_cache(4, PLACED_DECODE_SLOTS, torch.bfloat16, device)
        ref_cache = m.init_cache(4, PLACED_DECODE_SLOTS, torch.bfloat16, device)
        with use_mesh(mesh):
            pc = T._placed(shr.cache_shardings(cache, cut, mesh), cache)
            for i in range(PLACED_DECODE_SLOTS + 2):  # the last two past the end: the ring wraps
                logits, pc = step(pp, toks[:, i], pc, i)
                decoded.setdefault(masked, []).append(logits.to_local())
        for i in range(PLACED_DECODE_SLOTS + 2):
            logits, _ = m.decode_step(params, toks[:, i], ref_cache, i)
            decoded.setdefault(("ref", masked), []).append(logits)
    same = all(same_bits(a, b) for a, b in zip(decoded[False], decoded[True]))
    ddiff = max(max_abs_err(a, b) for k in (False, True)
                for a, b in zip(decoded[k], decoded[("ref", k)]))
    if exact:
        dheld = all(same_bits(a, b) for k in (False, True)
                    for a, b in zip(decoded[k], decoded[("ref", k)]))
    else:
        dheld = ddiff <= tol[0] * float(decoded[("ref", False)][0].float().abs().max())
    if not same or not dheld:
        raise PhaseError(f"make_decode_step: masked == slice write {same}, placed vs unplaced "
                         f"{ddiff:.4e} (held {held})")
    log(f"phase 3 ok: at the depth-{TRAIN_CUT_LAYERS} cut, full width, on the {shape} mesh: "
        f"make_prefill_step's last-position logits (batch 4 x 64) vs the unplaced step's "
        f"within {pplain:.4e} (held {held}), vs the forward's within {pdiff:.4e} of the "
        f"largest |logit| (<= {tol[0]}); make_decode_step, {PLACED_DECODE_SLOTS + 2} steps on "
        f"a placed bfloat16 cache of {PLACED_DECODE_SLOTS} slots (the last two past the end), "
        f"decode_masked_update on == off bit for bit ({same}), placed vs unplaced logits "
        f"within {ddiff:.4e} (held {held}); no kernel launched")
    del params, pp, pc, decoded, cache, ref_cache
    torch.cuda.empty_cache()
    lap("prefill and decode")
    return {"calls": calls, "errs": errs}


def placements_of(tree):
    """A tree of ``runtime.sharding.Placed`` like ``tree``'s placed leaves."""
    from repro_torch.core import api
    from repro_torch.runtime import sharding as shr

    flat = dict(api.flatten_with_keys(tree, "::"))
    return api.unflatten_like(
        tree, lambda k: shr.Placed(flat[k].device_mesh, tuple(flat[k].placements), shr.P()),
        "::")


def vlm_positions(b: int, s: int, image_at: int = VLM_IMAGE_AT,
                  grid: tuple = VLM_GRID) -> "np.ndarray":
    """(b, s, 3) int32 M-RoPE positions: text tokens t = h = w = their
    index; an image of ``grid`` patches from ``image_at`` on at t =
    image_at, h and w over the grid (offset by image_at); the text after it
    resumes past the grid."""
    import numpy as np

    pos = np.repeat(np.arange(s, dtype=np.int32)[:, None], 3, axis=1)
    gh, gw = grid
    n = gh * gw
    pos[image_at:image_at + n, 0] = image_at
    pos[image_at:image_at + n, 1] = image_at + np.arange(n) // gw
    pos[image_at:image_at + n, 2] = image_at + np.arange(n) % gw
    pos[image_at + n:] = pos[image_at + n:] - n + max(gh, gw)
    return np.broadcast_to(pos, (b, s, 3)).copy()


def phase_ssm_training(device, api, card: str) -> dict:
    """Phase 3 and 5, the ssm family trained: ``train_loop("mamba2-370m",
    smoke=False, steps=6, batch=8, seq=1024)`` at full width and depth (48
    layers, 368M float32 parameters from the seed, bfloat16 compute, float32
    moments; 8 SSD chunks a sequence), with its step times, tokens/s,
    model-FLOP share and peak memory, no kernel launched; a depth-2
    full-width step on the card against the CPU (float32 and bfloat16, two
    chunks); and a bit-exact resume at depth 4 from exact checkpoints, every
    save and restore counted exactly with the entropy kernels held to their
    plain versions inside the call on the embedding's first 128 MiB chunk."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model, load_params
    from repro_torch.runtime import roofline

    calls, errs = {}, {}
    cfg = get_config(SSM_ARCH)
    model = build_model(cfg)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(model.param_shapes()))
    reset_peak(f"train_loop {SSM_ARCH}")
    t0 = time.perf_counter()
    what = f"train_loop {SSM_ARCH} (full, {TRAIN_STEPS} steps)"
    out, calls[what] = counted(what, lambda: T.train_loop(
        SSM_ARCH, steps=TRAIN_STEPS, batch=SSM_BATCH, seq=SSM_SEQ, smoke=False, log_every=1), {})
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, finite = out["losses"], out["finite"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses) or not all(finite):
        raise PhaseError(f"train_loop {SSM_ARCH} (full): losses {losses}, finite {finite}")
    step_s = statistics.median(out["step_s"][-TRAIN_TIMED:])
    tokens = SSM_BATCH * SSM_SEQ
    counts = roofline.count_params(model.param_shapes())
    flops = roofline.model_flops(cfg, ShapeConfig("train", SSM_SEQ, SSM_BATCH, "train"),
                                 counts)["model_flops"]
    log(f"phase 3 ok: train_loop({SSM_ARCH!r}, smoke=False, steps={TRAIN_STEPS}, "
        f"batch={SSM_BATCH}, seq={SSM_SEQ}): {cfg.n_layers} layers, {n_params} float32 "
        f"parameters, {cfg.dtype} compute, float32 moments, {SSM_SEQ // cfg.ssm.chunk} SSD chunks "
        f"a sequence; losses {[round(x, 4) for x in losses]} all finite, every step's update "
        "applied; no kernel launched")
    log(f"phase 5 [{card}] training {SSM_ARCH} full width and depth, {tokens} tokens a step: "
        f"step times {[round(x * 1e3, 2) for x in out['step_s']]} ms (host wall, each ending in "
        f"the loss's read); median of the last {TRAIN_TIMED} {step_s * 1e3:.4f} ms = "
        f"{tokens / step_s:.3f} tokens/s; model FLOPs (6·N·D, N = {counts['other']} without the "
        f"embedding; no attention) {flops:.6e} a step = {flops / step_s / 1e12:.4f} TFLOP/s, "
        f"{flops / step_s / roofline.PEAK_FLOPS:.4f} of {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; "
        f"peak torch.cuda.max_memory_allocated {peak} bytes; the run {wall_s:.2f} s with init")
    del out
    torch.cuda.empty_cache()

    # -- a depth-2 full-width step on the card against the CPU (two chunks) --
    cut = replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    params = build_model(cut).init(torch.Generator(device=device).manual_seed(SEED + 80), device)
    cpu = torch.device("cpu")
    cpu_params = load_params(params, cpu)
    window = torch.from_numpy(np.random.default_rng(SEED + 81).integers(
        0, cfg.vocab, (SSM_CHECK_BATCH, SSM_CHECK_SEQ + 1)).astype(np.int32))
    batches = {dev: {"tokens": window[:, :-1].to(dev), "labels": window[:, 1:].to(dev)}
               for dev in (device, cpu)}
    diffs = check_step_vs_cpu(f"train step {SSM_ARCH}", cut, params, cpu_params, batches, device)
    del params, cpu_params
    torch.cuda.empty_cache()
    log(f"phase 3 ok: a {SSM_ARCH} train step (loss and every gradient), depth-{TRAIN_CUT_LAYERS} "
        f"cut at full width, batch {SSM_CHECK_BATCH} x {SSM_CHECK_SEQ} ({SSM_CHECK_SEQ // cfg.ssm.chunk}"
        f" chunks), card vs CPU (no TF32): " + step_diffs_text(diffs))

    # -- resume at depth 4, bit for bit, from exact checkpoints --------------
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-ssm-train-")
    timings: list = []
    c, summary = check_resume(
        T, SSM_ARCH, replace(cfg, n_layers=SSM_RESUME_LAYERS), calls, errs, timings, device,
        "params::embed::table", Path(tmp.name) / "ck", "M", batch=SSM_BATCH, seq=SSM_SEQ)
    log(f"phase 3 ok: resume at depth {SSM_RESUME_LAYERS}, full width, batch {SSM_BATCH} x "
        f"{SSM_SEQ}, " + summary)
    log(f"phase 5 [{card}] exact checkpoints of the depth-{SSM_RESUME_LAYERS} {SSM_ARCH} training "
        "state (host wall, synchronised, one run each; the entropy probes after each call not "
        "included): " + ", ".join(
            f"{name} {s:.3f} s ({raw} bytes -> {comp}, {raw / s / 1e9:.3f} GB/s of the state)"
            for name, s, raw, comp in timings))
    del c
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def park_served_cache(arch: str, cache, calls: dict, errs: dict, times: dict) -> str:
    """A served cache (any tree of the family's leaves; ``None`` stacks
    skipped) parked in a ``KVPageStore`` at zfp rate SSM_PARK_RATE, fetched
    and restored once resident and once after a spill: the same container
    bytes both ways, every restored leaf within the rate's bound, every
    ZFP launch counted exactly and held to its plain version (tolerance 0).
    Each call's host wall ms goes into ``times``; returns the log line's
    tail."""
    import tempfile

    import torch

    from repro_torch.core import api
    from repro_torch.serving import KVPageStore
    from repro_torch.serving import engine as serving_engine

    tmp = tempfile.TemporaryDirectory(prefix="hpdr-kv-")
    store = KVPageStore(spill_dir=Path(tmp.name) / "kv", rate=SSM_PARK_RATE)
    nb = zfp_buckets(api, cache, serving_engine._kv_select(SSM_PARK_RATE))
    zfp = ("zfp_block.compress_blocks", "zfp_block.decompress_blocks")
    key = store._key(arch)
    worst, blobs = 0.0, {}

    def timed(what, fn, want):
        t0 = time.perf_counter()
        out, calls[f"{what} ({arch})"] = counted(f"{what} ({arch})", fn, want)
        times[what] = (time.perf_counter() - t0) * 1e3
        return out

    with held_to_plain(zfp) as held:
        pstats = timed("KVPageStore.park (served cache)", lambda: store.park(arch, cache),
                       {"zfp_block.compress_blocks": nb})
        for where in ("resident", "spilled"):
            if where == "spilled":
                store.cache.evict(key)
            flat = timed(f"KVPageStore.fetch ({where})", lambda: store.fetch(arch), {})
            blobs[where] = {k: c.to_bytes() if hasattr(c, "to_bytes") else
                            (c.cpu().numpy() if isinstance(c, torch.Tensor) else c).tobytes()
                            for k, c in flat.items()}
            restored = timed(f"KVPageStore.restore ({where})", lambda: store.restore(arch, cache),
                             {"zfp_block.decompress_blocks": nb})
            worst = max(worst, check_kv_restored(f"{arch} restore ({where})", restored, cache))
            del restored
    for k, want in (("zfp_block.compress_blocks", nb), ("zfp_block.decompress_blocks", 2 * nb)):
        n, e = held[k]
        if n != want or e:
            raise PhaseError(f"{arch} KV parking: {k} held to its plain version in {n} calls, "
                             f"max |kernel - plain| {e}")
        errs[k] = max(errs.get(k, 0.0), e)
    st = store.stats()
    if blobs["resident"] != blobs["spilled"] or st["spills"] < 1 or st["loads"] < 1:
        raise PhaseError(f"{arch} KV parking: spilled containers differ from the resident "
                         f"ones, or no spill / load ({st})")
    store.release(arch)
    tmp.cleanup()
    leaves = dict(api.flatten_with_keys(cache))
    raw = sum(x.numel() * x.element_size() for x in leaves.values())
    torch.cuda.empty_cache()
    return (f"{', '.join(f'{k} {tuple(x.shape)}' for k, x in leaves.items())}; {raw} bytes) "
            f"parked at zfp rate {SSM_PARK_RATE} in {nb} bucket launches (ratio "
            f"{pstats['ratio']:.6f}), fetched and restored resident and after a spill (the same "
            f"container bytes; {st['spills']} spill, {st['loads']} load): restored within "
            f"{worst:.3e} of each leaf's largest |value| (<= {KV_ERR_TOL}); every "
            "compress_blocks / decompress_blocks launch == its plain version (tolerance 0)")


def phase_ssm_serving(device, api, card: str) -> dict:
    """Phase 3 and 5, the ssm family served: mamba2-370m at full width and
    depth through ``ServingEngine`` (4 slots, float32 cache, bfloat16
    compute): 8 requests of 32 prompt and 16 new tokens (two waves: the
    refill path; prefill steps advance every slot's state, as in the
    reference); the same requests on a depth-2 cut in float32 on the card
    and on the CPU path (the same tokens) and three decode steps against
    the CPU (float32 and bfloat16); decode against the forward at full
    depth in float32 (the last position's logits of a 200-token prompt,
    two SSD chunks); the served cache (state and conv) parked in a
    ``KVPageStore``, fetched and restored once resident and once spilled,
    every ZFP launch held to its plain version, the restored state within
    the rate-12 bound; and the decode step, tokens/s and park / fetch /
    restore times."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, load_params
    from repro_torch.models.layers import rms_norm
    from repro_torch.serving import Request, ServingEngine

    calls, errs = {}, {}
    cfg = get_config(SSM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 82), device)
    rng = np.random.default_rng(SEED + 83)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]

    def serve(m, p, what):
        # the state is O(1): max_len bounds only the slots' lengths, which
        # the engine does not reset at a refill (as the reference)
        eng_s = ServingEngine(m, p, SERVE_BATCH, SERVE_MAX_LEN, torch.float32)
        reqs = [Request(uid=i, prompt=q, max_new_tokens=SERVE_NEW) for i, q in enumerate(prompts)]
        stats, calls[what] = counted(what, lambda: eng_s.serve(reqs), {})
        toks = [r.out_tokens for r in reqs]
        if not all(r.done and len(r.out_tokens) == SERVE_NEW for r in reqs) or any(
                not 0 <= t < cfg.vocab for r in toks for t in r):
            raise PhaseError(f"{what}: tokens {toks}")
        return eng_s, stats, toks

    engine, stats, tokens = serve(model, params, f"ServingEngine.serve {SSM_ARCH} (full)")
    decode_ms = decode_step_ms(engine)
    log(f"phase 3 ok: serve {SSM_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, state "
        f"{tuple(engine.cache['state'].shape)} float32, conv {tuple(engine.cache['conv'].shape)}): "
        f"{SERVE_REQUESTS} requests x ({SERVE_PROMPT} prompt + {SERVE_NEW} new tokens) on "
        f"{SERVE_BATCH} slots, {stats['decode_steps']} decode steps after prefill, "
        f"{stats['new_tokens']} tokens in the vocabulary (first request {tokens[0]}); no kernel "
        "launched")

    # the same requests on a depth-2 cut, card and CPU, float32
    cut = {"embed": params["embed"], "ln_f": params["ln_f"],
           "layers": _layer_of(params["layers"], slice(0, SERVE_CHECK_LAYERS))}
    cpu_cut = load_params(cut, torch.device("cpu"))
    cut_cfg = replace(cfg, n_layers=SERVE_CHECK_LAYERS)
    m32 = build_model(replace(cut_cfg, dtype="float32"))
    _, _, on_card = serve(m32, cut, f"ServingEngine.serve {SSM_ARCH} (depth 2, float32)")
    t0 = time.perf_counter()
    _, _, on_cpu = serve(m32, cpu_cut, f"ServingEngine.serve {SSM_ARCH} (depth 2, float32, CPU)")
    cpu_s = time.perf_counter() - t0
    if on_card != on_cpu:
        raise PhaseError(f"serve {SSM_ARCH} depth {SERVE_CHECK_LAYERS}: card tokens {on_card} vs "
                         f"CPU {on_cpu}")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, SERVE_BATCH).astype(np.int32))
    diffs = check_decode_vs_cpu("decode_step", cut_cfg, cut, cpu_cut, toks, device)
    del cpu_cut
    log(f"phase 3 ok: the same {SERVE_REQUESTS} requests on a depth-{SERVE_CHECK_LAYERS} cut in "
        f"float32, card and CPU ({cpu_s:.1f} s): the same tokens; 3 decode steps, card vs CPU: "
        + ", ".join(f"{k} max |logit difference| {d:.4e} <= {b:.4e} ({SERVE_CHECK_TOL[k]} x (1 + "
                    f"max |logit|))" for k, (d, b) in diffs.items()))

    # decode against the forward, full depth, float32 compute
    full32 = build_model(replace(cfg, dtype="float32"))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, SSM_IDENTITY_PROMPT))
                              .astype(np.int32)).to(device)

    def decode_over_prompt():
        cache = full32.init_cache(SERVE_BATCH, SERVE_MAX_LEN, torch.float32, device)
        for i in range(SSM_IDENTITY_PROMPT):
            logits, cache = full32.decode_step(params, prompt[:, i], cache, i)
        return logits

    def forward_last():
        with torch.no_grad():
            h, _ = full32._backbone(params, full32._embed_in(params, {"tokens": prompt}), {})
            h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
            return full32._head(params, h[:, -1:])[:, 0]

    by_decode, calls["decode steps over a prompt"] = counted(
        "decode steps over a prompt", decode_over_prompt, {})
    by_forward, calls["forward over the prompt"] = counted(
        "forward over the prompt", forward_last, {})
    diff = float((by_decode - by_forward).abs().max())
    bound = SSM_IDENTITY_TOL * (1.0 + float(by_forward.abs().max()))
    if not diff <= bound:
        raise PhaseError(f"{SSM_ARCH}: decode over a {SSM_IDENTITY_PROMPT}-token prompt vs the "
                         f"forward's last logits: max |difference| {diff:.4e} > {bound:.4e}")
    log(f"phase 3 ok: {SSM_ARCH} at full depth, float32: {SSM_IDENTITY_PROMPT} decode steps over a "
        f"prompt (batch {SERVE_BATCH}) give the forward's last-position logits ("
        f"{-(-SSM_IDENTITY_PROMPT // cfg.ssm.chunk)} SSD chunks) within {diff:.4e} <= {bound:.4e} "
        f"({SSM_IDENTITY_TOL} x (1 + max |logit|))")
    del by_decode, by_forward

    # -- the served cache parked, fetched and restored, resident and spilled --
    times: dict = {}
    park = park_served_cache(SSM_ARCH, engine.cache, calls, errs, times)
    log(f"phase 3 ok: {SSM_ARCH}'s served cache (state and conv, " + park)
    log(f"phase 5 [{card}] serving {SSM_ARCH} full width and depth: decode step (batch "
        f"{SERVE_BATCH}, {cfg.dtype} compute) median of {TIMED_RUNS} {decode_ms:.4f} ms (host wall, "
        f"synchronised) = {SERVE_BATCH / decode_ms * 1e3:.3f} tokens/s; serve "
        f"{stats['new_tokens']} new tokens in {stats['wall_s']:.3f} s = "
        f"{stats['tokens_per_s']:.3f} tokens/s with prefill; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
        + " (host wall, one run each, the held plain versions included)")
    del engine, params
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_vlm(device, api, card: str) -> dict:
    """Phase 3 and 5, the vlm family: qwen2-vl-72b at full width (d_model
    8192, 64 heads, 8 KV heads, d_ff 29568, vocab 152064, QKV bias) cut to
    2 of its 80 layers (4.25B float32 parameters from the seed, the untied
    head included): ``value_and_grad`` on an ``embeds`` batch (8, 128, 8192)
    whose M-RoPE positions mix text tokens and an 8 x 8 image grid, loss
    and every gradient finite, no optimizer (its moments would not fit
    beside the parameters and gradients); the same computation on the smoke
    cut held to the CPU path; ``ServingEngine`` decode on tokens at depth 2;
    times and peak memory."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, load_params
    from repro_torch.serving import Request, ServingEngine

    calls = {}
    cfg = replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    model = build_model(cfg)
    reset_peak(f"{VLM_ARCH} at depth {VLM_LAYERS}")
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 90), device)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(params))
    g = torch.Generator(device=device).manual_seed(SEED + 91)
    batch = {"embeds": torch.randn((VLM_BATCH, VLM_SEQ, cfg.d_model), generator=g, device=device),
             "positions_3d": torch.from_numpy(vlm_positions(VLM_BATCH, VLM_SEQ)).to(device),
             "labels": torch.randint(0, cfg.vocab, (VLM_BATCH, VLM_SEQ), generator=g,
                                     device=device, dtype=torch.int32)}
    (loss, _), grads = model.value_and_grad(params, batch)   # warm-up
    del grads
    t0 = time.perf_counter()
    ((loss, _), grads), calls["value_and_grad (depth 2)"] = counted(
        "value_and_grad (depth 2)", lambda: model.value_and_grad(params, batch), {})
    grad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, x in api.flatten_with_keys(grads) if not bool(torch.isfinite(x).all())]
    if not math.isfinite(float(loss)) or bad:
        raise PhaseError(f"{VLM_ARCH} value_and_grad: loss {float(loss)}, non-finite gradients "
                         f"{bad[:5]}")
    text = {**batch, "positions_3d": torch.from_numpy(vlm_positions(
        VLM_BATCH, VLM_SEQ, image_at=VLM_SEQ, grid=(0, 0))).to(device)}
    with torch.no_grad():
        as_text = float(model.loss(params, text)[0])
    if as_text == float(loss):
        raise PhaseError(f"{VLM_ARCH}: the image grid's positions left the loss unchanged")
    del grads
    log(f"phase 3 ok: {VLM_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"QKV bias, M-RoPE sections {cfg.mrope_sections}), {VLM_LAYERS} of 80 layers, {n_params} "
        f"float32 parameters from the seed: value_and_grad on embeds ({VLM_BATCH}, {VLM_SEQ}, "
        f"{cfg.d_model}) with an {VLM_GRID[0]} x {VLM_GRID[1]} image grid at t = {VLM_IMAGE_AT} "
        f"among text positions: loss {float(loss):.6f} (as text positions {as_text:.6f}) and every "
        "gradient finite; no kernel launched")

    # the same computation on the smoke cut, card against CPU, float32
    small = get_config(VLM_ARCH).smoke()
    sp = build_model(small).init(torch.Generator(device=device).manual_seed(SEED + 92), device)
    cpu = torch.device("cpu")
    sp_cpu = load_params(sp, cpu)
    rng = np.random.default_rng(SEED + 93)
    sb = {"embeds": torch.from_numpy(rng.normal(size=(2, 96, small.d_model)).astype(np.float32)),
          "positions_3d": torch.from_numpy(vlm_positions(2, 96, 8, (4, 6))),
          "labels": torch.from_numpy(rng.integers(0, small.vocab, (2, 96)).astype(np.int32))}
    ltol, gtol = TRAIN_CHECK_TOL["float32"]
    sm = build_model(small)
    (l_card, _), g_card = sm.value_and_grad(sp, {k: v.to(device) for k, v in sb.items()})
    (l_cpu, _), g_cpu = sm.value_and_grad(sp_cpu, sb)
    ldiff = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    if not ldiff <= ltol:
        raise PhaseError(f"{VLM_ARCH} smoke cut: card loss {float(l_card)} vs CPU "
                         f"{float(l_cpu)}: {ldiff:.4e} > {ltol}")
    gflat = dict(api.flatten_with_keys(g_card, "::"))
    if gflat["embed::table"].any():
        raise PhaseError(f"{VLM_ARCH} smoke cut: the embedding, unread under embeds, has a "
                         "non-zero gradient")
    worst = check_grads_close(f"{VLM_ARCH} smoke cut", gflat,
                              dict(api.flatten_with_keys(g_cpu, "::")), gtol)
    log(f"phase 3 ok: {VLM_ARCH}'s smoke cut on embeds (2, 96, {small.d_model}) with a 4 x 6 image "
        f"grid, card vs CPU in float32: loss within {ldiff:.4e} (<= {ltol}), gradients within "
        f"{worst:.4e} of each leaf's largest |gradient| (<= {gtol}; the unread embedding's zero)")

    # decode on tokens at depth 2 through ServingEngine
    prompts = [rng.integers(0, cfg.vocab, VLM_SERVE_PROMPT).astype(np.int32)
               for _ in range(VLM_SERVE_REQUESTS)]
    eng_v = ServingEngine(model, params, SERVE_BATCH, VLM_SERVE_MAX_LEN, torch.float32)
    reqs = [Request(uid=i, prompt=q, max_new_tokens=VLM_SERVE_NEW) for i, q in enumerate(prompts)]
    stats, calls["ServingEngine.serve (depth 2)"] = counted(
        "ServingEngine.serve (depth 2)", lambda: eng_v.serve(reqs), {})
    toks = [r.out_tokens for r in reqs]
    if not all(r.done and len(t) == VLM_SERVE_NEW for r, t in zip(reqs, toks)) or any(
            not 0 <= t < cfg.vocab for r in toks for t in r):
        raise PhaseError(f"{VLM_ARCH} serve: tokens {toks}")
    decode_ms = decode_step_ms(eng_v)
    peak_all = torch.cuda.max_memory_allocated()
    log(f"phase 3 ok: {VLM_ARCH} depth {VLM_LAYERS} served on tokens (plain RoPE at cache_len, as "
        f"the reference): {VLM_SERVE_REQUESTS} requests x ({VLM_SERVE_PROMPT} + {VLM_SERVE_NEW}) "
        f"on {SERVE_BATCH} slots, tokens in the vocabulary (first request {toks[0]}); no kernel "
        "launched")
    log(f"phase 5 [{card}] {VLM_ARCH} full width, depth {VLM_LAYERS}: value_and_grad on "
        f"{VLM_BATCH * VLM_SEQ} embedded positions {grad_s * 1e3:.3f} ms (host wall, synchronised, "
        f"after a warm-up); peak torch.cuda.max_memory_allocated {peak} bytes through the "
        f"gradients, {peak_all} with serving; decode step (batch {SERVE_BATCH}, {cfg.dtype} "
        f"compute over {cfg.param_dtype} weights) median of {TIMED_RUNS} {decode_ms:.4f} ms (host wall, "
        f"synchronised); serve {stats['new_tokens']} tokens in {stats['wall_s']:.3f} s")
    del eng_v, params, batch, sp, sp_cpu
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": {}}


@contextlib.contextmanager
def recorded_routes():
    """While the block runs, every ``moe.route`` call's routing (top-k
    indices, capacity positions, keep mask) is recorded on the host, by
    device type: yields ``{"cuda": [...], "cpu": [...]}``."""
    from repro_torch.models import moe as moe_mod

    route = moe_mod.route
    seen: dict = {"cuda": [], "cpu": []}

    def spy(x, *args, **kwargs):
        out = route(x, *args, **kwargs)
        seen[x.device.type].append(tuple(t.cpu() for t in out[2:5]))
        return out

    moe_mod.route = spy
    try:
        yield seen
    finally:
        moe_mod.route = route


def check_routes(what: str, seen: dict) -> int:
    """The card's routing decisions equal the CPU's, call for call (a
    flipped expert or capacity slot fails); returns the calls compared."""
    import torch

    card, cpu = seen["cuda"], seen["cpu"]
    if not card or len(card) != len(cpu):
        raise PhaseError(f"{what}: {len(card)} routing calls on the card, {len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise PhaseError(f"{what}: routing call {i} differs between the card and the CPU "
                             "(top-k index, capacity position or keep mask)")
    return len(card)


def serve_requests(what: str, model, params, max_len: int, calls: dict, rng, vocab: int):
    """SERVE_REQUESTS requests of SERVE_PROMPT + SERVE_NEW tokens on
    SERVE_BATCH slots (two waves: the refill path), float32 cache, counted
    (no kernel launches); returns the engine, its stats and the tokens."""
    import numpy as np
    import torch

    from repro_torch.serving import Request, ServingEngine

    prompts = [rng.integers(0, vocab, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    eng = ServingEngine(model, params, SERVE_BATCH, max_len, torch.float32)
    reqs = [Request(uid=i, prompt=q, max_new_tokens=SERVE_NEW) for i, q in enumerate(prompts)]
    stats, calls[what] = counted(what, lambda: eng.serve(reqs), {})
    toks = [r.out_tokens for r in reqs]
    if not all(r.done and len(t) == SERVE_NEW for r, t in zip(reqs, toks)) or any(
            not 0 <= t < vocab for r in toks for t in r):
        raise PhaseError(f"{what}: tokens {toks}")
    return eng, stats, toks


def phase_moe_deepseek(device, api, card: str) -> dict:
    """Phase 3 and 5, the moe family at deepseek-v3-671b's full width
    (d_model 7168, 128 MLA heads: q_lora 1536, kv_lora 512, rope 64; 256
    routed experts top-8 of width 2048 plus 1 shared; dense FFN 18432;
    vocab 129280; the MTP head) cut to 4 of its 61 layers (its 3 dense
    layers and 1 MoE layer, 15.8B float32 parameters from the seed):
    ``loss`` under ``no_grad`` on tokens (4, 128), ``ce``, ``aux`` and
    ``mtp_ce`` finite, ``aux`` > 0; ``ServingEngine`` with 4 slots x 1024
    positions and the float32 MLA cache (8 requests of 32 + 16 tokens);
    the served cache parked through ZFP, resident and spilled, every launch
    held to plain; times and peak memory."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    calls, errs, times = {}, {}, {}
    cfg = replace(get_config(DS_ARCH), n_layers=DS_LAYERS)
    model = build_model(cfg)
    reset_peak(f"{DS_ARCH} at depth {DS_LAYERS}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 100), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(params))
    toks = torch.randint(0, cfg.vocab, (DS_BATCH, DS_SEQ + 1), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(SEED + 101))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        (_loss, met), calls["loss (depth 4)"] = counted(
            "loss (depth 4)", lambda: model.loss(params, batch), {})
        loss_ms = median_wall_ms(lambda: model.loss(params, batch), runs=3, warmup=0)
    peak_loss = torch.cuda.max_memory_allocated()
    vals = {k: float(v) for k, v in met.items()}
    if set(vals) != {"ce", "aux", "mtp_ce", "loss"} or not all(
            math.isfinite(v) for v in vals.values()) or not vals["aux"] > 0:
        raise PhaseError(f"{DS_ARCH} loss: {vals}")
    m, e = cfg.mla, cfg.moe
    log(f"phase 3 ok: {DS_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} MLA heads: "
        f"q_lora {m.q_lora_rank}, kv_lora {m.kv_lora_rank}, rope {m.qk_rope_head_dim}; "
        f"{e.n_experts} routed experts top-{e.top_k} of width {e.d_ff_expert} + {e.n_shared} "
        f"shared; dense FFN {e.d_ff_dense}; vocab {cfg.vocab}; MTP), {DS_LAYERS} of 61 layers "
        f"({e.first_dense_layers} dense, {DS_LAYERS - e.first_dense_layers} MoE), {n_params} "
        f"float32 parameters from the seed: loss under no_grad on tokens ({DS_BATCH}, {DS_SEQ}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in vals.items()) + " (all finite, aux > 0); no "
        "kernel launched")

    rng = np.random.default_rng(SEED + 102)
    eng, stats, tokens = serve_requests(f"ServingEngine.serve {DS_ARCH}", model, params,
                                        DS_SERVE_MAX_LEN, calls, rng, cfg.vocab)
    decode_ms = decode_step_ms(eng)
    peak_serve = torch.cuda.max_memory_allocated()
    log(f"phase 3 ok: serve {DS_ARCH} depth {DS_LAYERS} (the float32 MLA cache, c_kv and k_rope "
        f"of the dense stack {tuple(eng.cache['dense']['c_kv'].shape)}, "
        f"{tuple(eng.cache['dense']['k_rope'].shape)} and of the MoE stack): {SERVE_REQUESTS} "
        f"requests x ({SERVE_PROMPT} + {SERVE_NEW}) on "
        f"{SERVE_BATCH} slots, {stats['decode_steps']} decode steps after prefill, tokens in the "
        f"vocabulary (first request {tokens[0]}); no kernel launched")
    park = park_served_cache(DS_ARCH, eng.cache, calls, errs, times)
    log(f"phase 3 ok: {DS_ARCH}'s served MLA cache (" + park)
    log(f"phase 5 [{card}] {DS_ARCH} full width, depth {DS_LAYERS}: init {init_s:.3f} s; loss "
        f"(no_grad, {DS_BATCH * DS_SEQ} tokens, {cfg.dtype} compute) median of 3 {loss_ms:.3f} ms "
        f"(host wall, synchronised, after one run); peak torch.cuda.max_memory_allocated "
        f"{peak_loss} bytes through the loss, {peak_serve} with serving; decode step (batch "
        f"{SERVE_BATCH}, {DS_SERVE_MAX_LEN} positions) median of {TIMED_RUNS} {decode_ms:.4f} ms "
        f"(host wall, synchronised) = {SERVE_BATCH / decode_ms * 1e3:.3f} tokens/s; serve "
        f"{stats['new_tokens']} new tokens in {stats['wall_s']:.3f} s with prefill; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
        + " (host wall, one run each, the held plain versions included)")
    del eng, params, batch, toks
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_moe_llama4(device, api, card: str) -> dict:
    """Phase 3 and 5, the moe family at llama4-scout-17b-a16e's full width
    (d_model 5120, 40 heads, 8 KV heads of 128, 16 routed experts top-1 of
    width 8192 plus 1 shared, vocab 202048) cut to 2 of its 48 layers
    (6.47B float32 parameters from the seed): ``value_and_grad`` on tokens
    (8, 128) with no optimizer (AdamW's moments do not fit at full width),
    loss and every gradient finite, the router's gradient non-zero; served
    (4 slots x 8192 positions, float32 GQA cache, the ``None`` dense
    stack) and the cache parked through ZFP as deepseek-v3's; times and
    peak memory."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    calls, errs, times = {}, {}, {}
    cfg = replace(get_config(L4_ARCH), n_layers=L4_LAYERS)
    model = build_model(cfg)
    reset_peak(f"{L4_ARCH} at depth {L4_LAYERS}")
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 110), device)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(params))
    toks = torch.randint(0, cfg.vocab, (L4_BATCH, L4_SEQ + 1), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(SEED + 111))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (_loss, _met), grads = model.value_and_grad(params, batch)   # warm-up
    del grads
    t0 = time.perf_counter()
    ((loss, met), grads), calls["value_and_grad (depth 2)"] = counted(
        "value_and_grad (depth 2)", lambda: model.value_and_grad(params, batch), {})
    grad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, x in api.flatten_with_keys(grads) if not bool(torch.isfinite(x).all())]
    router = float(grads["moe_layers"]["moe"]["router"].abs().max())
    if not math.isfinite(float(loss)) or bad or not router > 0 or not float(met["aux"]) > 0:
        raise PhaseError(f"{L4_ARCH} value_and_grad: loss {float(loss)}, aux {float(met['aux'])}, "
                         f"non-finite gradients {bad[:5]}, router max |gradient| {router}")
    del grads
    e = cfg.moe
    log(f"phase 3 ok: {L4_ARCH} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, {e.n_experts} routed experts "
        f"top-{e.top_k} of width {e.d_ff_expert} + {e.n_shared} shared, every layer MoE, vocab "
        f"{cfg.vocab}, RoPE theta {cfg.rope_theta}), {L4_LAYERS} of 48 layers, {n_params} float32 "
        f"parameters from the seed: value_and_grad on tokens ({L4_BATCH}, {L4_SEQ}): loss "
        f"{float(loss):.6f} (ce {float(met['ce']):.6f} + aux {float(met['aux']):.6e}) and every "
        f"gradient finite, the router's max |gradient| {router:.4e} > 0; no kernel launched")

    rng = np.random.default_rng(SEED + 112)
    eng, stats, tokens = serve_requests(f"ServingEngine.serve {L4_ARCH}", model, params,
                                        SERVE_MAX_LEN, calls, rng, cfg.vocab)
    if eng.cache["dense"] is not None:
        raise PhaseError(f"{L4_ARCH}: a dense cache stack {eng.cache['dense']}")
    decode_ms = decode_step_ms(eng)
    peak_serve = torch.cuda.max_memory_allocated()
    log(f"phase 3 ok: serve {L4_ARCH} depth {L4_LAYERS} (GQA cache k, v "
        f"{tuple(eng.cache['moe']['k'].shape)} float32, no dense stack): {SERVE_REQUESTS} requests "
        f"x ({SERVE_PROMPT} + {SERVE_NEW}) on {SERVE_BATCH} slots, {stats['decode_steps']} decode "
        f"steps after prefill, tokens in the vocabulary (first request {tokens[0]}); no kernel "
        "launched")
    park = park_served_cache(L4_ARCH, eng.cache, calls, errs, times)
    log(f"phase 3 ok: {L4_ARCH}'s served cache (" + park)
    log(f"phase 5 [{card}] {L4_ARCH} full width, depth {L4_LAYERS}: value_and_grad on "
        f"{L4_BATCH * L4_SEQ} tokens {grad_s * 1e3:.3f} ms (host wall, synchronised, after a "
        f"warm-up; remat {cfg.remat}); peak torch.cuda.max_memory_allocated {peak} bytes through "
        f"the gradients, {peak_serve} with serving; decode step (batch {SERVE_BATCH}, "
        f"{SERVE_MAX_LEN} positions) median of {TIMED_RUNS} {decode_ms:.4f} ms (host wall, "
        f"synchronised) = {SERVE_BATCH / decode_ms * 1e3:.3f} tokens/s; serve "
        f"{stats['new_tokens']} new tokens in {stats['wall_s']:.3f} s with prefill; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
        + " (host wall, one run each, the held plain versions included)")
    del eng, params, batch, toks
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_moe_vs_cpu(device, api) -> dict:
    """Phase 3, the moe family's smoke cuts (deepseek-v3: MLA, a dense layer,
    3 MoE layers, MTP; llama4-scout: 4 GQA MoE layers), float32, no TF32,
    card against CPU on the same weights: one train step (loss and every
    gradient within the training phase's float32 tolerances) and the same
    8 requests served (the same tokens); every routing decision of both
    (top-k indices, capacity positions, keep masks) equal call for call: a
    flip fails, whatever the tolerance would let through."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, load_params

    calls = {}
    cpu = torch.device("cpu")
    for i, arch in enumerate((DS_ARCH, L4_ARCH)):
        cut = get_config(arch).smoke()
        model = build_model(cut)
        params = model.init(torch.Generator(device=device).manual_seed(SEED + 120 + i), device)
        cpu_params = load_params(params, cpu)
        window = torch.from_numpy(np.random.default_rng(SEED + 125 + i).integers(
            0, cut.vocab, (4, 65)).astype(np.int32))
        batches = {dev: {"tokens": window[:, :-1].to(dev), "labels": window[:, 1:].to(dev)}
                   for dev in (device, cpu)}
        with recorded_routes() as seen:
            diffs = check_step_vs_cpu(f"train step {arch} (smoke)", cut, params, cpu_params,
                                      batches, device, dtypes=("float32",))
        n_step = check_routes(f"train step {arch} (smoke)", seen)
        with recorded_routes() as seen:
            # 128 positions: the slots' lengths reach 96 over the two waves
            _e, _s, on_card = serve_requests(f"ServingEngine.serve {arch} (smoke)", model, params,
                                             128, calls, np.random.default_rng(SEED + 127),
                                             cut.vocab)
            _e, _s, on_cpu = serve_requests(f"ServingEngine.serve {arch} (smoke, CPU)", model,
                                            cpu_params, 128, calls,
                                            np.random.default_rng(SEED + 127), cut.vocab)
        if on_card != on_cpu:
            raise PhaseError(f"serve {arch} (smoke): card tokens {on_card} vs CPU {on_cpu}")
        n_serve = check_routes(f"serve {arch} (smoke)", seen)
        log(f"phase 3 ok: {arch}'s smoke cut ({cut.n_layers} layers, d_model {cut.d_model}, "
            f"{cut.moe.n_experts} experts top-{cut.moe.top_k}, attention {cut.attn_type}), card vs "
            f"CPU (no TF32): a train step on tokens (4, 64), " + step_diffs_text(diffs)
            + f"; {SERVE_REQUESTS} requests served to the same tokens; routing equal in all "
            f"{n_step} + {n_serve} MoE calls (top-k indices, capacity positions, keep masks)")
        del params, cpu_params
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": {}}


def phase_moe_resume(device, api, card: str) -> dict:
    """Phase 3 and 5, a bit-exact resume of ``train_loop("deepseek-v3-671b")``
    at the reference's smoke cut (MLA, MTP, the aux loss, the dense layer
    before the MoE stack), as the training phase's: runs A, A, B failing
    at step 4 after the step-3 exact save, C restarting; every save and
    restore counted exactly with the entropy kernels held to plain on the
    embedding's keys."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    calls, errs, timings = {}, {}, []
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-moe-train-")
    c, summary = check_resume(T, DS_ARCH, get_config(DS_ARCH).smoke(), calls, errs, timings,
                              device, "params::embed::table", Path(tmp.name) / "ck", "D")
    log(f"phase 3 ok: resume at the smoke cut, " + summary)
    log(f"phase 5 [{card}] exact checkpoints of {DS_ARCH}'s smoke-cut training state (host wall, "
        "synchronised, one run each; the entropy probes after each call not included): "
        + ", ".join(f"{name} {s:.3f} s ({raw} bytes -> {comp})"
                    for name, s, raw, comp in timings))
    del c
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def ckpt_policy(cfg):
    """The checkpoint policy a model config names: ``ckpt_compress`` at
    ``ckpt_rate`` (zfp), the rest the defaults."""
    from repro_torch.checkpoint import CheckpointPolicy

    return CheckpointPolicy(float_method=cfg.ckpt_compress, zfp_rate=cfg.ckpt_rate)


def check_state_checkpoint(what: str, policy, state: dict, calls: dict, errs: dict,
                           timings: list, device, ckpt_dir: Path, places=None) -> str:
    """A training state saved under ``policy`` and restored: every launch of
    both calls counted exactly and every launch of LOSSY_KERNELS inside them
    held to its plain version on the same inputs (tolerance 0); each
    restored leaf on the card in its dtype and shape and bit for bit the
    one-shot or streamed decode of its containers (an exact leaf: itself),
    compared a stream chunk at a time, since a state and its restore may
    fill most of the card; the lossy leaves within STATE_ERR_TOL of the
    leaf's largest |value|.  With ``places`` (a tree of placements like
    ``state``'s) the restore puts every leaf onto its placement and each
    leaf's local block is compared.  Returns the log line's tail."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import api

    mgr = CheckpointManager(ckpt_dir, policy)
    before = len(timings)
    torch.cuda.reset_peak_memory_stats()
    with counted_checkpoints(calls, errs, timings, device, hold=LOSSY_KERNELS):
        manifest = mgr.save(TRAIN_STEPS, state)
        if places is None:
            restored, _ = mgr.restore(TRAIN_STEPS)
        else:  # onto the placements: every leaf a DTensor, its block compared
            tree, _ = mgr.restore(TRAIN_STEPS, target=state, shardings=places)
            restored = local_leaves(tree)
            del tree
    worst, kinds = 0.0, {"streamed": 0, "zfp": 0, "huffman-bytes": 0}
    for k, x in local_leaves(state).items():
        e, got = manifest["leaves"][k], restored.pop(k)
        if got.device != device or got.dtype != x.dtype or got.shape != x.shape:
            raise PhaseError(f"{what} checkpoint {k}: restored {got.device} {got.dtype} "
                             f"{tuple(got.shape)}")
        if e.get("tuned"):
            kind = "streamed"
            parts = ((got.narrow(a, s, r), x.narrow(a, s, r), want)
                     for a, s, r, want in streamed_parts(api, x, e["tuned"], device,
                                                         policy.zfp_rate))
        elif x.dtype.is_floating_point and x.numel() >= policy.lossless_small:
            kind = "zfp"
            parts = [(got, x, api.decompress_leaf(api.compress_leaf(x, "zfp",
                                                                    rate=policy.zfp_rate)))]
        else:
            kind, parts = "huffman-bytes", [(got, x, x)]
        kinds[kind] += 1
        scale = max(float(x.abs().max()), 1e-30) if kind != "huffman-bytes" else 0.0
        for g, xs, want in parts:
            if not same_bits(g, want):
                raise PhaseError(f"{what} checkpoint {k} ({kind}): restored values differ from "
                                 "the decode of the same containers")
            if scale:
                worst = max(worst, float((g - xs).abs().max()) / scale)
    if not worst <= STATE_ERR_TOL:
        raise PhaseError(f"{what} checkpoint: max |error| {worst:.3e} of a leaf's largest "
                         f"|value| > {STATE_ERR_TOL}")
    raw, comp = manifest["raw_bytes"], manifest["compressed_bytes"]
    peak = torch.cuda.max_memory_allocated()
    del restored
    torch.cuda.empty_cache()
    held = ", ".join(f"{name} {s:.3f} s" for name, s, _r, _c in timings[before:])
    return (f"saved ({policy.float_method} rate {policy.zfp_rate}: {raw} bytes -> {comp}) and "
            f"restored: {kinds} leaves, each == the one-shot or streamed decode of its "
            f"containers (max |error| {worst:.3e} of a leaf's largest |value|, <= "
            f"{STATE_ERR_TOL}), "
            f"launches exact; inside both calls every launch of {', '.join(LOSSY_KERNELS)} == "
            f"its plain version on the same inputs (tolerance 0); {held} (host wall, the held "
            f"plain versions included); peak torch.cuda.max_memory_allocated {peak} bytes")


def phase_hybrid_serving(device, api, card: str) -> dict:
    """Phase 3 and 5, the hybrid family served at recurrentgemma-9b's full
    width and depth (38 layers: 12 ``(rec, rec, attn)`` superblocks and a
    2-layer tail; d_model 4096, lru_width 4096, 16 heads of 256 with one KV
    head, local window 2048, d_ff 12288, vocab 256000; 9.40B float32
    parameters from the seed, bfloat16 compute): ``ServingEngine`` with 4
    slots x 4096 positions (float32 cache: the RG-LRU ``h`` and conv
    buffers, the attention cache a 2048-slot ring), 8 requests of 32 + 16
    tokens; the served cache parked in a ``KVPageStore`` at zfp rate 12,
    fetched and restored resident and after a spill, every ZFP launch held
    to plain; then the window at full width: the first superblock (3
    layers, float32 compute), HYB_WINDOW_STEPS decode steps over a prompt
    (the ring wraps at 2048) against the forward's last-position logits
    under ``local_causal_mask``; times."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import rms_norm

    calls, errs, times = {}, {}, {}
    cfg = get_config(HYB_ARCH)
    model = build_model(cfg)
    reset_peak(f"{HYB_ARCH} serving")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 130), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(params))
    rng = np.random.default_rng(SEED + 131)
    eng, stats, tokens = serve_requests(f"ServingEngine.serve {HYB_ARCH}", model, params,
                                        HYB_SERVE_MAX_LEN, calls, rng, cfg.vocab)
    ring = tuple(eng.cache["attn"]["k"].shape)
    if ring[2] != cfg.hybrid.window or len(params["tail"]) != cfg.n_layers % 3:
        raise PhaseError(f"{HYB_ARCH}: attention cache {ring}, tail {len(params['tail'])}")
    decode_ms = decode_step_ms(eng)
    peak_serve = torch.cuda.max_memory_allocated()
    h = cfg.hybrid
    log(f"phase 3 ok: serve {HYB_ARCH} at full width and depth ({cfg.n_layers} layers: "
        f"{cfg.n_layers // 3} (rec, rec, attn) superblocks + {cfg.n_layers % 3} rec; d_model "
        f"{cfg.d_model}, lru_width {h.lru_width}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.n_kv_heads} KV head, window {h.window}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}; {n_params} float32 parameters from the seed, {cfg.dtype} compute): "
        f"{SERVE_REQUESTS} requests x ({SERVE_PROMPT} + {SERVE_NEW}) on {SERVE_BATCH} slots of "
        f"{HYB_SERVE_MAX_LEN} positions (float32 cache: h {tuple(eng.cache['rec_a']['h'].shape)}, "
        f"conv {tuple(eng.cache['rec_a']['conv'].shape)}, the attention ring {ring}, tail "
        f"{tuple(eng.cache['tail']['h'].shape)}), {stats['decode_steps']} decode steps after "
        f"prefill, tokens in the vocabulary (first request {tokens[0]}); no kernel launched")
    park = park_served_cache(HYB_ARCH, eng.cache, calls, errs, times)
    log(f"phase 3 ok: {HYB_ARCH}'s served cache (" + park)
    del eng

    # -- the window at full width: decode past the ring against the forward --
    cut = replace(cfg, n_layers=3, dtype="float32")
    m32 = build_model(cut)
    sub = {"embed": params["embed"], "ln_f": params["ln_f"], "tail": [],
           "super": _layer_of(params["super"], slice(0, 1))}
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (HYB_WINDOW_BATCH, HYB_WINDOW_STEPS))
                              .astype(np.int32)).to(device)

    def decode_over_prompt():
        cache = m32.init_cache(HYB_WINDOW_BATCH, HYB_WINDOW_STEPS, torch.float32, device)
        for i in range(HYB_WINDOW_STEPS):
            logits, cache = m32.decode_step(sub, prompt[:, i], cache, i)
        return logits, tuple(cache["attn"]["k"].shape)

    def forward_last():
        with torch.no_grad():
            hid, _ = m32._backbone(sub, m32._embed_in(sub, {"tokens": prompt}), {})
            hid = rms_norm(hid, sub["ln_f"]["scale"], cut.norm_eps)
            return m32._head(sub, hid[:, -1:])[:, 0]

    t0 = time.perf_counter()
    (by_decode, ring), calls["decode steps past the window"] = counted(
        "decode steps past the window", decode_over_prompt, {})
    window_s = time.perf_counter() - t0
    by_forward, calls["forward under the local mask"] = counted(
        "forward under the local mask", forward_last, {})
    diff = float((by_decode - by_forward).abs().max())
    bound = HYB_WINDOW_TOL * (1.0 + float(by_forward.abs().max()))
    if not diff <= bound or ring[2] != h.window:
        raise PhaseError(f"{HYB_ARCH}: {HYB_WINDOW_STEPS} decode steps (ring {ring}) vs the "
                         f"forward's last logits: max |difference| {diff:.4e} > {bound:.4e}")
    log(f"phase 3 ok: {HYB_ARCH}'s first superblock at full width, float32: {HYB_WINDOW_STEPS} "
        f"decode steps over a prompt (batch {HYB_WINDOW_BATCH}; the {h.window}-slot ring wraps at "
        f"step {h.window}) give the forward's last-position logits under local_causal_mask "
        f"within {diff:.4e} <= {bound:.4e} ({HYB_WINDOW_TOL} x (1 + max |logit|)); no kernel "
        "launched")
    log(f"phase 5 [{card}] {HYB_ARCH} full width and depth: init {init_s:.3f} s; decode step "
        f"(batch {SERVE_BATCH}, {cfg.dtype} compute, float32 cache) median of {TIMED_RUNS} "
        f"{decode_ms:.4f} ms (host wall, synchronised) = {SERVE_BATCH / decode_ms * 1e3:.3f} "
        f"tokens/s; serve {stats['new_tokens']} new tokens in {stats['wall_s']:.3f} s with "
        f"prefill; peak torch.cuda.max_memory_allocated {peak_serve} bytes; " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items())
        + " (host wall, one run each, the held plain versions included); the window check's "
        f"{HYB_WINDOW_STEPS} float32 decode steps of 3 layers {window_s:.3f} s")
    del params, sub, by_decode, by_forward
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_hybrid_training(device, api, card: str) -> dict:
    """Phase 3 and 5, the hybrid family trained: ``train_loop
    ("recurrentgemma-9b", smoke=False, steps=6, batch=8, seq=128)`` at full
    width cut to HYB_TRAIN_LAYERS of 38 layers (1 superblock and the
    2-layer tail: the superblock's shape and the tail kept; float32
    parameters from the seed, bfloat16 compute, float32 AdamW moments);
    step times, tokens/s, model-FLOP share and peak memory, no kernel
    launched; then the whole state (parameters and AdamW moments) saved with the config's zfp policy and restored
    (:func:`check_state_checkpoint`)."""
    import tempfile
    from dataclasses import replace

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.runtime import roofline

    calls, errs, timings = {}, {}, []
    cfg = replace(get_config(HYB_ARCH), n_layers=HYB_TRAIN_LAYERS)
    model = build_model(cfg)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(model.param_shapes()))
    reset_peak(f"train_loop {HYB_ARCH} at depth {HYB_TRAIN_LAYERS}")
    what = f"train_loop {HYB_ARCH} (depth {HYB_TRAIN_LAYERS}, {TRAIN_STEPS} steps)"
    t0 = time.perf_counter()
    with resized(T, cfg):
        out, calls[what] = counted(what, lambda: T.train_loop(
            HYB_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, smoke=False,
            log_every=1), {})
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, finite = out["losses"], out["finite"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses) or not all(finite):
        raise PhaseError(f"{what}: losses {losses}, finite {finite}")
    step_s = statistics.median(out["step_s"][-TRAIN_TIMED:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    counts = roofline.count_params(model.param_shapes())
    flops = roofline.model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                 counts)["model_flops"]
    log(f"phase 3 ok: train_loop({HYB_ARCH!r}, smoke=False, steps={TRAIN_STEPS}, "
        f"batch={TRAIN_BATCH}, seq={TRAIN_SEQ}) at full width, {HYB_TRAIN_LAYERS} of 38 layers "
        f"({cfg.n_layers // 3} superblocks + {cfg.n_layers % 3} rec), {n_params} float32 "
        f"parameters, {cfg.dtype} compute, float32 moments; losses "
        f"{[round(x, 4) for x in losses]} all finite, every step's update applied; no kernel "
        "launched")
    log(f"phase 5 [{card}] training {HYB_ARCH} full width, depth {HYB_TRAIN_LAYERS}, {tokens} "
        f"tokens a step: step times {[round(x * 1e3, 2) for x in out['step_s']]} ms (host wall, "
        f"each ending in the loss's read); median of the last {TRAIN_TIMED} {step_s * 1e3:.4f} "
        f"ms = {tokens / step_s:.3f} tokens/s; model FLOPs (6·N·D + local attention, N = "
        f"{counts['other']} without the embedding) {flops:.6e} a step = "
        f"{flops / step_s / 1e12:.4f} TFLOP/s, {flops / step_s / roofline.PEAK_FLOPS:.4f} of "
        f"{roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; peak torch.cuda.max_memory_allocated {peak} "
        f"bytes; the run {wall_s:.2f} s with init")
    state = out.pop("state")
    del out
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-hybrid-train-")
    summary = check_state_checkpoint(HYB_ARCH, ckpt_policy(cfg), state, calls, errs, timings,
                                     device, Path(tmp.name) / "ck")
    del state
    log(f"phase 3 ok: {HYB_ARCH}'s depth-{HYB_TRAIN_LAYERS} training state, with the config's "
        "policy, " + summary)
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_hybrid_smoke(device, api, card: str) -> dict:
    """Phase 3 and 5, the hybrid family's smoke cut (one superblock and a
    1-layer tail, window 32), float32, no TF32: a train step on the card
    against the CPU on tokens (4, 64) (past the window; the training
    phase's float32 tolerances), the same 8 requests served to the same
    tokens on both, and a bit-exact resume of ``train_loop
    ("recurrentgemma-9b")`` at the cut (runs A, A, B, C as the training
    phase's), every exact save and restore counted with the entropy kernels
    held to plain on the embedding's keys."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model, load_params

    calls, errs, timings = {}, {}, []
    cpu = torch.device("cpu")
    cut = get_config(HYB_ARCH).smoke()
    model = build_model(cut)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 135), device)
    cpu_params = load_params(params, cpu)
    window = torch.from_numpy(np.random.default_rng(SEED + 136).integers(
        0, cut.vocab, (4, 65)).astype(np.int32))
    batches = {dev: {"tokens": window[:, :-1].to(dev), "labels": window[:, 1:].to(dev)}
               for dev in (device, cpu)}
    diffs = check_step_vs_cpu(f"train step {HYB_ARCH} (smoke)", cut, params, cpu_params, batches,
                              device, dtypes=("float32",))
    _e, _s, on_card = serve_requests(f"ServingEngine.serve {HYB_ARCH} (smoke)", model, params,
                                     128, calls, np.random.default_rng(SEED + 137), cut.vocab)
    _e, _s, on_cpu = serve_requests(f"ServingEngine.serve {HYB_ARCH} (smoke, CPU)", model,
                                    cpu_params, 128, calls, np.random.default_rng(SEED + 137),
                                    cut.vocab)
    if on_card != on_cpu:
        raise PhaseError(f"serve {HYB_ARCH} (smoke): card tokens {on_card} vs CPU {on_cpu}")
    log(f"phase 3 ok: {HYB_ARCH}'s smoke cut ({cut.n_layers} layers, d_model {cut.d_model}, "
        f"lru_width {cut.hybrid.lru_width}, window {cut.hybrid.window}), card vs CPU (no TF32): "
        "a train step on tokens (4, 64), " + step_diffs_text(diffs)
        + f"; {SERVE_REQUESTS} requests served to the same tokens")
    del params, cpu_params
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-hybrid-resume-")
    c, summary = check_resume(T, HYB_ARCH, cut, calls, errs, timings, device,
                              "params::embed::table", Path(tmp.name) / "ck", "H")
    log("phase 3 ok: resume at the smoke cut, " + summary)
    log(f"phase 5 [{card}] exact checkpoints of {HYB_ARCH}'s smoke-cut training state (host "
        "wall, synchronised, one run each; the entropy probes after each call not included): "
        + ", ".join(f"{name} {s:.3f} s ({raw} bytes -> {comp})"
                    for name, s, raw, comp in timings))
    del c
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def encdec_batch(cfg, b: int, s_enc: int, s_dec: int, device, seed: int) -> dict:
    """``{"enc_embeds": (b, s_enc, D) N(0, 1) float32, "tokens", "labels":
    (b, s_dec)}`` made on ``device`` from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s_dec + 1), device=device, dtype=torch.int32,
                         generator=gen)
    return {"enc_embeds": torch.randn((b, s_enc, cfg.d_model), device=device, generator=gen),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def encdec_decode(model, params, enc_embeds, steps: int, first) -> tuple:
    """``encode`` of ``enc_embeds`` (in the compute dtype), ``precompute_cross``
    into a float32 cache of ``steps`` positions, then ``steps`` greedy
    ``decode_step``s from the tokens ``first``: returns (cache, the tokens
    fed at each step, each step's logits)."""
    import torch

    from repro_torch.models import encdec

    cfg = model.cfg
    with torch.no_grad():
        memory = encdec.encode(params, enc_embeds.to(getattr(torch, cfg.dtype)), cfg)
        cache = model.init_cache(enc_embeds.shape[0], steps, torch.float32, enc_embeds.device)
        cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(params, memory, cfg)
    tok, fed, logits = first, [], []
    for i in range(steps):
        fed.append(tok)
        out, cache = model.decode_step(params, tok, cache, i)
        logits.append(out)
        tok = torch.argmax(out, dim=-1).to(torch.int32)
    return cache, fed, logits


def phase_encdec(device, api, card: str) -> dict:
    """Phase 3 and 5, the encdec family at seamless-m4t-medium's full width
    and depth (12 encoder and 12 decoder layers, d_model 1024, 16 heads of
    64, d_ff 4096, vocab 256206, an untied head; 0.88B float32 parameters
    from the seed, bfloat16 compute; the audio frontend a stub, as in the
    reference): 6 steps of ``value_and_grad`` + ``apply_updates_`` (AdamW,
    float32 moments) on ``enc_embeds`` (8, 512, 1024) and tokens (8, 128)
    (the reference's ``train_loop`` has no ``enc_embeds``); ``encode`` of 4
    x 512 frames, ``precompute_cross`` and ED_DECODE_STEPS greedy
    ``decode_step``s; the self-attention cache parked through ZFP,
    resident and spilled; the training state saved with the config's zfp
    policy and restored (:func:`check_state_checkpoint`); times and peak
    memory."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedule

    calls, errs, times, timings = {}, {}, {}, []
    cfg = get_config(ED_ARCH)
    model = build_model(cfg)
    reset_peak(f"{ED_ARCH} training")
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 140), device)
    n_params = sum(x.numel() for _k, x in api.flatten_with_keys(params))
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(params, opt_cfg)
    step_fn = T.make_train_step(model, opt_cfg, schedule.cosine, 3e-4, TRAIN_STEPS)
    batch = encdec_batch(cfg, ED_BATCH, ED_ENC_SEQ, ED_DEC_SEQ, device, SEED + 141)

    def train():
        losses, finite, step_s = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            met = step_fn(params, opt, batch)
            losses.append(float(met["loss"]))
            step_s.append(time.perf_counter() - t0)
            finite.append(bool(met["finite"]))
        return losses, finite, step_s

    what = f"value_and_grad + apply_updates_ {ED_ARCH} ({TRAIN_STEPS} steps)"
    (losses, finite, step_s), calls[what] = counted(what, train, {})
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or not all(finite):
        raise PhaseError(f"{what}: losses {losses}, finite {finite}")
    log(f"phase 3 ok: {ED_ARCH} at full width and depth ({cfg.n_enc_layers} encoder + "
        f"{cfg.n_dec_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} float32 "
        f"parameters from the seed, {cfg.dtype} compute): {TRAIN_STEPS} steps of "
        f"value_and_grad + apply_updates_ (AdamW, float32 moments) on enc_embeds "
        f"{tuple(batch['enc_embeds'].shape)} and tokens {tuple(batch['tokens'].shape)}: losses "
        f"{[round(x, 4) for x in losses]} all finite; no kernel launched")
    del batch

    frames = torch.randn((ED_SERVE_BATCH, ED_ENC_SEQ, cfg.d_model), device=device,
                         generator=torch.Generator(device=device).manual_seed(SEED + 142))
    first = torch.zeros(ED_SERVE_BATCH, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    (cache, fed, logits), calls["encode + precompute_cross + decode"] = counted(
        "encode + precompute_cross + decode",
        lambda: encdec_decode(model, params, frames, ED_DECODE_STEPS, first), {})
    decode_s = time.perf_counter() - t0
    toks = torch.stack(fed, dim=1)
    if not all(bool(torch.isfinite(x).all()) for x in logits) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise PhaseError(f"{ED_ARCH} decode: non-finite logits or tokens out of the vocabulary")
    step_ms = median_wall_ms(lambda: model.decode_step(params, fed[-1], cache,
                                                       ED_DECODE_STEPS - 1))
    log(f"phase 3 ok: {ED_ARCH}: encode of {ED_SERVE_BATCH} x {ED_ENC_SEQ} frames, "
        f"precompute_cross (cross K/V {tuple(cache['cross_k'].shape)} {cache['cross_k'].dtype}) "
        f"and {ED_DECODE_STEPS} greedy decode steps (self-attention cache "
        f"{tuple(cache['k'].shape)} float32): logits finite, tokens in the vocabulary (first "
        f"sequence {toks[0, 1:9].tolist()}...); no kernel launched")
    park = park_served_cache(ED_ARCH, {"k": cache["k"], "v": cache["v"]}, calls, errs, times)
    log(f"phase 3 ok: {ED_ARCH}'s self-attention cache (the bfloat16 cross K/V stay: the store "
        "passes them raw and a spilled raw bfloat16 leaf does not restore; " + park)
    del cache, fed, logits, frames
    log(f"phase 5 [{card}] {ED_ARCH} full width and depth: a step of {ED_BATCH} x ({ED_ENC_SEQ} "
        f"frames + {ED_DEC_SEQ} tokens) {[round(x * 1e3, 2) for x in step_s]} ms (host wall, "
        f"each ending in the loss's read), median of the last {TRAIN_TIMED} "
        f"{statistics.median(step_s[-TRAIN_TIMED:]) * 1e3:.4f} ms; peak "
        f"torch.cuda.max_memory_allocated {peak} bytes; encode + precompute_cross + "
        f"{ED_DECODE_STEPS} decode steps {decode_s:.3f} s, one decode step (batch "
        f"{ED_SERVE_BATCH}) median of {TIMED_RUNS} {step_ms:.4f} ms (host wall, synchronised); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + " (host wall, one run each, the held plain versions included)")
    tmp = tempfile.TemporaryDirectory(prefix="hpdr-encdec-train-")
    state = {"params": params, "opt": opt}
    del params, opt
    summary = check_state_checkpoint(ED_ARCH, ckpt_policy(cfg), state, calls, errs, timings,
                                     device, Path(tmp.name) / "ck")
    del state
    log(f"phase 3 ok: {ED_ARCH}'s training state, with the config's policy, " + summary)
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs}


def phase_encdec_vs_cpu(device, api) -> dict:
    """Phase 3, seamless-m4t-medium's smoke cut (2 + 2 layers), float32, no
    TF32, card against CPU on the same weights: the loss and every gradient
    on enc_embeds (4, 32) and tokens (4, 16) (the training phase's float32
    tolerances), and ED_CHECK_STEPS decode steps' logits over the same fed
    tokens after ``encode`` and ``precompute_cross`` (within
    SERVE_CHECK_TOL["float32"] of 1 + max |logit|)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec, load_params

    calls = {}
    cpu = torch.device("cpu")
    cut = get_config(ED_ARCH).smoke()
    model = build_model(cut)
    params = model.init(torch.Generator(device=device).manual_seed(SEED + 145), device)
    cpu_params = load_params(params, cpu)
    batch = encdec_batch(cut, 4, 32, 16, device, SEED + 146)
    batches = {device: batch, cpu: {k: v.to(cpu) for k, v in batch.items()}}
    diffs = check_step_vs_cpu(f"train step {ED_ARCH} (smoke)", cut, params, cpu_params, batches,
                              device, dtypes=("float32",))
    first = batch["tokens"][:, 0].contiguous()
    _c, fed, on_card = encdec_decode(model, params, batch["enc_embeds"], ED_CHECK_STEPS, first)
    worst = 0.0
    with torch.no_grad():
        cache = model.init_cache(4, ED_CHECK_STEPS, torch.float32, cpu)
        memory = encdec.encode(cpu_params, batches[cpu]["enc_embeds"], cut)
        cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(cpu_params, memory, cut)
        for i in range(ED_CHECK_STEPS):
            ref, cache = model.decode_step(cpu_params, fed[i].to(cpu), cache, i)
            diff = float((on_card[i].cpu() - ref).abs().max())
            bound = SERVE_CHECK_TOL["float32"] * (1.0 + float(ref.abs().max()))
            if not diff <= bound:
                raise PhaseError(f"{ED_ARCH} (smoke) decode step {i}: card vs CPU max |logit "
                                 f"difference| {diff:.4e} > {bound:.4e}")
            worst = max(worst, diff / bound)
    log(f"phase 3 ok: {ED_ARCH}'s smoke cut ({cut.n_enc_layers} + {cut.n_dec_layers} layers, "
        f"d_model {cut.d_model}), card vs CPU (no TF32): a train step on enc_embeds (4, 32) and "
        "tokens (4, 16), " + step_diffs_text(diffs) + f"; {ED_CHECK_STEPS} decode steps' logits "
        f"after encode and precompute_cross within {worst:.4f} of their bound "
        f"({SERVE_CHECK_TOL['float32']} x (1 + max |logit|))")
    del params, cpu_params
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": {}}


# ---------------------------------------------------------------------------
# abstractions and examples: the paper's parallel abstractions, the
# standalone ZFP and MGARD API, the engine's data mesh, the four examples
# ---------------------------------------------------------------------------


def held_run(what: str, fn, calls: dict, errs: dict, want: dict | None = None,
             must: tuple[str, ...] = ()):
    """:func:`counted` with every kernel launch inside held to its plain
    version on the same inputs (:func:`held_to_plain` over ``HELD_KERNELS``):
    each kernel that launched was held in at least as many calls, at
    tolerance 0, and each kernel of ``must`` launched at least once.
    Returns ``(result, host wall seconds)``, the plain runs included."""
    t0 = time.perf_counter()
    with held_to_plain(HELD_KERNELS) as held:
        out, counts = counted(what, fn, want)
    seconds = time.perf_counter() - t0
    for k in must:
        if not counts[k]:
            raise PhaseError(f"{what}: {k} launched no time ({counts})")
    for k, n in counts.items():
        got = held.get(k, [0, None])
        if n and (got[0] < n or got[1]):
            raise PhaseError(f"{what}: {k} launched {n} times, held to its plain version in "
                             f"{got[0]} calls, max |kernel - plain| {got[1]}")
        if n:
            errs[k] = max(errs.get(k, 0.0), got[1])
    calls[what] = counts
    return out, seconds


def phase_abstractions(device, api, card: str) -> dict:
    """Phases 3 and 5, the paper's parallel abstractions and the standalone
    codec API on the 512^3 field (SDRBench Nyx size): ``locality`` with 4^3
    blocks and an elementwise ``fn`` (card == the same call on a CPU copy,
    bit for bit), with ``halo=1`` on a 128^3 cut (a stencil of shifted
    slices), ``iterative`` as a prefix sum along axis 0 (512 steps, forward
    and reversed, a tuple carry), ``map_and_process`` with MGARD's 513^3
    level map as subset ids (== ``map_and_process_param``), a
    ``global_pipeline`` and ``jitted_dem``; ``zfp.compress_jit`` at rate 16
    (``adapter="cuda"`` == ``adapter="torch"``), ``zfp.compress``/
    ``decompress`` (the kernel on the card tensor, == ``compress_jit`` and
    the ``zfp`` codec container's sections); ``mgard.compress``/
    ``decompress`` at the absolute bound 1e-2 (the ``tridiag`` and
    ``quantize_map`` kernels; the stream's words, offsets, length table,
    outliers and bins == the ``mgard`` codec container's, the decode == the
    codec's, within the bound); an ``ExecutionEngine(mesh=make_data_mesh())``
    (a world-size-1 NCCL group, ended after) whose ``compress_pytree``
    bytes == the ``devices=`` engine's.  Every launch counted and held to
    its plain version; timings with CUDA events (median of 5)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import abstractions as ab
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import machine, mgard, zfp

    calls, errs, times = {}, {}, {}
    cpu = torch.device("cpu")
    field = main_field(FIELD_EDGE, device)
    on_cpu = field.cpu()

    def same(what: str, a, b) -> None:
        if not same_bits(a, b):
            raise PhaseError(f"{what}: the card's result differs from the reference's bits")

    # locality: elementwise over 4^3 blocks, then a stencil with a halo of 1
    def elementwise(b):
        return b * 2.0 + torch.abs(b)

    out, _ = held_run("locality (512^3)", lambda: ab.locality(field, elementwise, ABS_BLOCK),
                      calls, errs, want={})
    same("locality (512^3) vs CPU", out, ab.locality(on_cpu, elementwise, ABS_BLOCK))
    times["locality, 4^3 blocks, 512^3"] = median_ms(
        lambda: ab.locality(field, elementwise, ABS_BLOCK), ABS_TIMED_RUNS)
    del out

    def stencil(p):
        inner = p[1:-1, 1:-1, 1:-1]
        return inner * 3.0 - p[:-2, 1:-1, 1:-1] + p[1:-1, 2:, 1:-1] - p[1:-1, 1:-1, :-2]

    cut = field[:ABS_HALO_EDGE, :ABS_HALO_EDGE, :ABS_HALO_EDGE].contiguous()
    out, _ = held_run("locality (halo 1, 128^3)",
                      lambda: ab.locality(cut, stencil, ABS_BLOCK, halo=1), calls, errs, want={})
    same("locality (halo 1) vs CPU", out, ab.locality(cut.cpu(), stencil, ABS_BLOCK, halo=1))
    times["locality, halo 1, 128^3"] = median_ms(
        lambda: ab.locality(cut, stencil, ABS_BLOCK, halo=1), ABS_TIMED_RUNS)

    # iterative: a prefix sum along axis 0, with its running maximum in the carry
    def step(carry, s):
        total, peak = carry
        total = total + s
        return (total, torch.maximum(peak, total)), total

    def scan(x, reverse):
        init = (torch.zeros_like(x[0]), torch.full_like(x[0], -math.inf))
        return ab.iterative(x, step, init, 0, reverse=reverse)

    for reverse in (False, True):
        name = f"iterative (512 steps{', reversed' if reverse else ''})"
        ((tot, peak), ys), _ = held_run(name, lambda: scan(field, reverse), calls, errs, want={})
        (ctot, cpeak), cys = scan(on_cpu, reverse)
        for a, b in ((tot, ctot), (peak, cpeak), (ys, cys)):
            same(f"{name} vs CPU", a, b)
        times[name] = median_ms(lambda: scan(field, reverse), ABS_TIMED_RUNS)
        del tot, peak, ys, ctot, cpeak, cys

    # map & process over MGARD's level map (10 subsets of the 513^3 grid)
    padded = tuple(mgard.padded_dim(n) for n in field.shape)
    grid = mgard.pad_to_dyadic(field)
    lmap = mgard.level_map(padded, device)
    bins = torch.tensor(mgard.level_bins(ABS_MGARD_EB, mgard.total_levels(padded)),
                        dtype=torch.float32, device=device)
    # each level's bin as a 0-d tensor on the card: a Python scalar divisor
    # would be applied as a multiplication by its reciprocal there
    fns = [lambda v, b=b: torch.round(v / b) for b in bins]
    out, _ = held_run("map_and_process (513^3, 10 levels)",
                      lambda: ab.map_and_process(grid, lmap, fns), calls, errs, want={})
    same("map_and_process vs map_and_process_param", out, ab.map_and_process_param(
        grid, lmap.long(), lambda v, b: torch.round(v / b), bins))
    times["map_and_process, 10 levels, 513^3"] = median_ms(
        lambda: ab.map_and_process(grid, lmap, fns), ABS_TIMED_RUNS)
    del out, grid, lmap

    # global pipeline (DEM) and its cached fused program
    stages = (lambda x: x - x.mean(), lambda x: x * 0.5)
    out, _ = held_run("global_pipeline (512^3)", lambda: ab.global_pipeline(*stages)(field),
                      calls, errs, want={})
    same("global_pipeline", out, (field - field.mean()) * 0.5)
    prog = machine.DEMProgram(stages=stages, name="centre")
    if machine.jitted_dem(prog) is not machine.jitted_dem(prog):
        raise PhaseError("jitted_dem built its program twice")
    same("jitted_dem", machine.jitted_dem(prog)(field), out)
    del out

    # zfp: the kernel against the plain block path, both against the codec
    shape = tuple(field.shape)
    (p1, e1), _ = held_run("zfp.compress_jit (cuda)",
                           lambda: zfp.compress_jit(field, RATE, 3, shape, adapter="cuda"),
                           calls, errs, want={"zfp_block.compress_blocks": 1})
    (p0, e0), _ = held_run("zfp.compress_jit (plain)",
                           lambda: zfp.compress_jit(field, RATE, 3, shape, adapter="torch"),
                           calls, errs, want={})
    same("zfp.compress_jit payload, cuda vs plain", p1, p0)
    same("zfp.compress_jit emax, cuda vs plain", e1, e0)
    z, _ = held_run("zfp.compress", lambda: zfp.compress(field, RATE), calls, errs,
                    want={"zfp_block.compress_blocks": 1})
    same("zfp.compress payload vs compress_jit (cuda)", z.payload, p1)
    same("zfp.compress emax vs compress_jit (cuda)", z.emax, e1)
    c = api.compress(field, "zfp", rate=RATE)
    if not (np.array_equal(c.arrays["payload"], z.payload.cpu().numpy().view(np.uint32))
            and np.array_equal(c.arrays["emax"], z.emax.cpu().numpy())):
        raise PhaseError("zfp.compress differs from the zfp codec container's sections")
    d1, _ = held_run("zfp.decompress", lambda: zfp.decompress(z), calls, errs,
                     want={"zfp_block.decompress_blocks": 1})
    same("zfp.decompress vs decompress_jit (plain)",
         d1, zfp.decompress_jit(p1, e1, RATE, 3, shape, adapter="torch"))
    same("zfp.decompress vs the codec's decode", d1, api.decompress(c))
    ratio = zfp.compression_ratio(z)
    err = float((d1 - field).abs().max()) / float(field.max() - field.min())
    if ratio != c.ratio() or not err <= ERR_TOL:
        raise PhaseError(f"zfp standalone: ratio {ratio} (codec {c.ratio()}), error {err}")
    times["zfp.compress"] = median_ms(lambda: zfp.compress(field, RATE), ABS_TIMED_RUNS)
    times["api.compress zfp (codec, host wall)"] = median_wall_ms(
        lambda: api.compress(field, "zfp", rate=RATE), ABS_TIMED_RUNS, warmup=0)
    times["zfp.decompress"] = median_ms(lambda: zfp.decompress(z), ABS_TIMED_RUNS)
    times["api.decompress zfp (codec, host wall)"] = median_wall_ms(
        lambda: api.decompress(c), ABS_TIMED_RUNS, warmup=0)
    del p0, e0, p1, e1, z, d1, c

    # mgard: the standalone path against the codec on the same card
    solves = mgard_solves(tuple(field.shape))
    m, msec = held_run("mgard.compress (512^3)", lambda: mgard.compress(field, ABS_MGARD_EB),
                       calls, errs, want={"tridiag.solve_mass": solves, "quantize_map.quantize": 1,
                                          "histogram.histogram": 1,
                                          "huffman_encode.encode_lookup": 1})
    c = api.compress(field, "mgard", error_bound=ABS_MGARD_EB, relative=False)
    sections = {"words": (c.arrays["words"].view(np.int32), m.entropy.words),
                "chunk_offsets": (c.arrays["chunk_offsets"], m.entropy.chunk_offsets),
                "outlier_idx": (c.arrays["outlier_idx"], m.outlier_idx),
                "outlier_val": (c.arrays["outlier_val"], m.outlier_val)}
    for name, (want_arr, got) in sections.items():
        if not np.array_equal(want_arr, got.cpu().numpy()):
            raise PhaseError(f"mgard.compress {name} differs from the mgard codec container's")
    if not (np.array_equal(c.arrays["length_table"], m.entropy.length_table)
            and np.array_equal(c.arrays["bins"], m.bins)
            and c.meta["total_bits"] == m.entropy.total_bits):
        raise PhaseError("mgard.compress length table, bins or bit total differ from the codec's")
    out, dsec = held_run("mgard.decompress (512^3)", lambda: mgard.decompress(m), calls, errs,
                         want={"tridiag.solve_mass": solves, "quantize_map.dequantize": 1,
                               "huffman_decode.decode_chunks": 1})
    same("mgard.decompress vs the codec's decode", out, api.decompress(c))
    merr = float((out - field).abs().max())
    if not merr <= ABS_MGARD_EB:
        raise PhaseError(f"mgard standalone: max |error| {merr} > {ABS_MGARD_EB}")
    # each was run once above: no warm-up runs
    times["mgard.compress (host wall)"] = median_wall_ms(
        lambda: mgard.compress(field, ABS_MGARD_EB), ABS_TIMED_RUNS, warmup=0)
    times["api.compress mgard (codec, host wall)"] = median_wall_ms(
        lambda: api.compress(field, "mgard", error_bound=ABS_MGARD_EB, relative=False),
        ABS_TIMED_RUNS, warmup=0)
    times["mgard.decompress (host wall)"] = median_wall_ms(lambda: mgard.decompress(m),
                                                           ABS_TIMED_RUNS, warmup=0)
    times["api.decompress mgard (codec, host wall)"] = median_wall_ms(
        lambda: api.decompress(c), ABS_TIMED_RUNS, warmup=0)
    log(f"phase 3 ok: mgard.compress of the 512^3 field at the absolute bound {ABS_MGARD_EB}: "
        f"ratio {mgard.compression_ratio(m):.2f}, {m.outlier_idx.numel()} outliers, max |error| "
        f"{merr:.3e}; its stream == the mgard codec container's section for section, its "
        f"decode == the codec's bit for bit; held runs {msec:.2f} s / {dsec:.2f} s (with the "
        "plain versions)")
    del m, c, out

    # the engine on a ("data",) mesh against the devices= engine
    started = not dist.is_initialized()
    mesh = engine_mod.make_data_mesh()
    g = torch.Generator(device=device).manual_seed(SEED + 201)
    tree = {"layers": [{"w": torch.randn((4096, 4096), generator=g, device=device) * 0.02,
                        "scale": torch.ones(4096, device=device)} for _ in range(4)]}
    try:
        with engine_mod.ExecutionEngine(mesh=mesh) as on_mesh, \
                engine_mod.ExecutionEngine(devices=[device]) as plain_eng:
            if on_mesh.devices != [device] or on_mesh.mesh is not mesh:
                raise PhaseError(f"the mesh engine's ring is {on_mesh.devices}, not [{device}]")
            (fm, _st), _ = held_run("ExecutionEngine(mesh=).compress_pytree",
                                    lambda: on_mesh.compress_pytree(tree), calls, errs,
                                    must=("zfp_block.compress_blocks",))
            fd, _ = plain_eng.compress_pytree(tree)
    finally:
        if started:
            dist.destroy_process_group()
    for key, cm in fm.items():
        cd = fd[key]
        equal = (cm.to_bytes() == cd.to_bytes()) if hasattr(cm, "to_bytes") \
            else same_bits(cm, cd)
        if not equal:
            raise PhaseError(f"ExecutionEngine(mesh=): leaf {key} differs from the devices= "
                             "engine's")
    log(f"phase 3 ok: ExecutionEngine(mesh=make_data_mesh()) on a ('data',) mesh of "
        f"{engine_mod.data_devices(mesh)}: compress_pytree of {len(fm)} leaves == the devices= "
        "engine's bytes")
    del tree, fm, fd, field, on_cpu, cut
    torch.cuda.empty_cache()
    log(f"phase 5: {card}: abstractions and the standalone codec API (CUDA events, median of "
        f"{ABS_TIMED_RUNS}; host wall where named): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()))
    log(f"phase 3 ok: locality (4^3 blocks; halo 1 on 128^3), iterative (512 steps, both "
        "directions, tuple carry), map_and_process (MGARD's level map), global_pipeline and "
        "jitted_dem on the card == the CPU or their parameter form bit for bit; "
        "zfp.compress_jit (cuda) == (torch), zfp.compress (kernel) == the zfp codec "
        "container, decode bit for bit; "
        f"launches {json.dumps({k: {n: c for n, c in v.items() if c} for k, v in calls.items()})}")
    return {"calls": calls, "errs": errs, "times": times}


def phase_api_gaps(device, api, card: str) -> dict:
    """Phases 3 and 5, the reference's API as the port now takes it: a 64 MiB
    cut of the 512^3 field from host memory through the single-phase
    ``ChunkedPipeline(lambda c: api.compress(c, "zfp", rate=16), mode=
    "fixed", ...)`` (chunk bytes == the two-phase stream's at the same
    chunking, ``decompress_chunked`` == the stream's decode); standalone
    ``zfp.compress``/``mgard.compress`` of a numpy float64 array (the record
    "float64" as on the CPU, the ratio twice the float32 input's, the
    payload, stream and decode == the float32 input's); ``pad_to_blocks``
    in every mode on card tensors == on the CPU; ``iterative`` over an axis
    of length 0 (both directions, axis 0 and 1) == on the CPU; and
    ``ExecutionEngine(make_data_mesh())`` given positionally (a world-size-1
    NCCL group, ended after), its bytes == the ``devices=`` engine's, a
    device list there raising ``TypeError``.  Every launch counted exactly
    and held to its plain version; the phase's seconds printed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import abstractions as ab
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import mgard, zfp
    from repro_torch.core import pipeline as pl

    t_phase = time.perf_counter()
    calls, errs = {}, {}
    cpu = torch.device("cpu")

    def same(what: str, a, b) -> None:
        if not same_bits(a, b):
            raise PhaseError(f"{what}: the results differ")

    # the single-phase pipeline against the two-phase stream on the same chunking
    host = main_field(FIELD_EDGE, device)[:GAP_CUT_PLANES].cpu()
    pipe = pl.ChunkedPipeline(lambda c: api.compress(c, "zfp", rate=RATE), mode="fixed",
                              c_fixed_elems=GAP_CHUNK_ELEMS, devices=[device])
    n_chunks = -(-host.numel() // GAP_CHUNK_ELEMS)
    one, _ = held_run("ChunkedPipeline(compress_fn).run (64 MiB)", lambda: pipe.run(host), calls,
                      errs, want={"zfp_block.compress_blocks": n_chunks})
    stream = api.CompressorStream("zfp", mode="fixed", c_fixed_elems=GAP_CHUNK_ELEMS, rate=RATE)
    two, _ = held_run("CompressorStream.compress (64 MiB)", lambda: stream.compress(host), calls,
                      errs, want={"zfp_block.compress_blocks": n_chunks})
    if len(one.chunks) != n_chunks or (one.axis, one.boundaries) != (two.axis, two.boundaries):
        raise PhaseError(f"single-phase pipeline: {len(one.chunks)} chunks at {one.boundaries} "
                         f"on axis {one.axis}, the stream's {two.boundaries} on axis {two.axis}")
    for i, (a, b) in enumerate(zip(one.chunks, two.chunks)):
        if a.to_bytes() != b.to_bytes():
            raise PhaseError(f"single-phase pipeline: chunk {i} differs from the two-phase "
                             "stream's")
    out, _ = held_run("decompress_chunked (64 MiB)",
                      lambda: pl.decompress_chunked(one, api.decompress), calls, errs,
                      want={"zfp_block.decompress_blocks": n_chunks})
    same("decompress_chunked vs the stream's decode", out,
         api.CompressorStream.decompress(two))
    err = float((out.cpu() - host).abs().max()) / float(host.max() - host.min())
    if not err <= ERR_TOL:
        raise PhaseError(f"single-phase pipeline: error {err} of the value range > {ERR_TOL}")
    log(f"phase 3 ok: ChunkedPipeline(compress_fn) on a {tuple(host.shape)} cut: {n_chunks} "
        f"chunks on axis {one.axis} == the two-phase stream's bytes, decode == the stream's, "
        f"error {err:.2e} of the range")
    del host, one, two, out, pipe, stream

    # the standalone API on a numpy float64 array: the record keeps float64
    x64 = np.random.default_rng(SEED + 301).normal(size=(GAP_WIDE_EDGE,) * 3) * 10
    x32 = x64.astype(np.float32)
    z64, _ = held_run("zfp.compress (float64 array)", lambda: zfp.compress(x64, RATE), calls,
                      errs, want={"zfp_block.compress_blocks": 1})
    z32, zcpu = zfp.compress(x32, RATE), zfp.compress(x64, RATE, device=cpu)
    same("zfp.compress payload, float64 vs float32 input", z64.payload, z32.payload)
    same("zfp.compress emax, float64 vs float32 input", z64.emax, z32.emax)
    zr = zfp.compression_ratio(z64)
    if (z64.dtype, zcpu.dtype) != ("float64", "float64") or not (
            zr == zfp.compression_ratio(zcpu) == 2 * zfp.compression_ratio(z32)):
        raise PhaseError(f"zfp.compress of float64: record {z64.dtype} (CPU {zcpu.dtype}), "
                         f"ratio {zr} (CPU {zfp.compression_ratio(zcpu)}, float32 input "
                         f"{zfp.compression_ratio(z32)})")
    d64, _ = held_run("zfp.decompress (float64 record)", lambda: zfp.decompress(z64), calls,
                      errs, want={"zfp_block.decompress_blocks": 1})
    same("zfp.decompress of the float64 record vs the float32 input's", d64, zfp.decompress(z32))
    shape = tuple(x64.shape)
    solves = mgard_solves(shape)
    m64, _ = held_run("mgard.compress (float64 array)",
                      lambda: mgard.compress(x64, ABS_MGARD_EB), calls, errs,
                      want={"tridiag.solve_mass": solves, "quantize_map.quantize": 1,
                            "histogram.histogram": 1, "huffman_encode.encode_lookup": 1})
    m32, mcpu = mgard.compress(x32, ABS_MGARD_EB), mgard.compress(x64, ABS_MGARD_EB, device=cpu)
    same("mgard.compress words, float64 vs float32 input", m64.entropy.words, m32.entropy.words)
    mr, mcr = mgard.compression_ratio(m64), mgard.compression_ratio(mcpu)
    # the CPU runs the plain versions: its stream may differ by a word where a
    # coefficient rounds the other way, so its ratio is held within 1e-3
    if (m64.dtype, mcpu.dtype) != ("float64", "float64") or mr != 2 * mgard.compression_ratio(
            m32) or not abs(mr - mcr) <= 1e-3 * mcr:
        raise PhaseError(f"mgard.compress of float64: record {m64.dtype} (CPU {mcpu.dtype}), "
                         f"ratio {mr} (CPU {mcr}, float32 input {mgard.compression_ratio(m32)})")
    o64, _ = held_run("mgard.decompress (float64 record)", lambda: mgard.decompress(m64), calls,
                      errs, want={"tridiag.solve_mass": solves, "quantize_map.dequantize": 1,
                                  "huffman_decode.decode_chunks": 1})
    same("mgard.decompress of the float64 record vs the float32 input's", o64,
         mgard.decompress(m32))
    merr = float((o64.cpu() - torch.from_numpy(x32)).abs().max())
    if o64.dtype != torch.float32 or not merr <= ABS_MGARD_EB:
        raise PhaseError(f"mgard.decompress of float64: {o64.dtype}, max |error| {merr}")
    log(f"phase 3 ok: zfp/mgard.compress of a numpy float64 {shape} array record 'float64' as "
        f"on the CPU, ratios {zr:.4f} / {mr:.4f} (CPU {mcr:.4f}) twice the float32 input's, "
        f"payload, stream and float32 decode == the float32 input's; mgard max |error| "
        f"{merr:.3e}")

    # pad_to_blocks in every mode and iterative over an empty axis: card == CPU
    def pads_and_scans():
        rng = np.random.default_rng(SEED + 302)
        inputs = []
        for shp in GAP_PAD_SHAPES:
            inputs.append(torch.from_numpy(rng.normal(size=shp).astype(np.float32) * 100))
            inputs.append(torch.from_numpy(rng.integers(-1000, 1000, shp).astype(np.int32)))
        for x in inputs:
            for mode in PAD_MODES:
                got = ab.pad_to_blocks(x.to(device), ABS_BLOCK, mode=mode)
                if got.device != torch.device(device):
                    raise PhaseError(f"pad_to_blocks({mode!r}) left the card")
                same(f"pad_to_blocks({mode!r}) {tuple(x.shape)} {x.dtype}, card vs CPU", got,
                     ab.pad_to_blocks(x, ABS_BLOCK, mode=mode))

        def step(carry, s):
            total, count = carry
            return (total + s, count + 1), total * 2.0 + s

        for axis in (0, 1):
            for reverse in (False, True):
                shp = [64, 64, 64]
                shp[axis] = 0
                rest = tuple(n for a, n in enumerate(shp) if a != axis)
                init = (torch.arange(math.prod(rest), dtype=torch.float32).reshape(rest),
                        torch.zeros(()))
                (tc, nc), yc = ab.iterative(torch.zeros(shp), step, init, axis, reverse=reverse)
                dev_init = tuple(t.to(device) for t in init)
                (td, nd), yd = ab.iterative(torch.zeros(shp, device=device), step, dev_init,
                                            axis, reverse=reverse)
                if td is not dev_init[0] or nd is not dev_init[1] or yd.device != td.device:
                    raise PhaseError("iterative over an empty axis: the carry or ys moved")
                same(f"iterative over an empty axis {axis}, card vs CPU", yd, yc)
                if tuple(yd.shape) != tuple(shp):
                    raise PhaseError(f"iterative over an empty axis: ys {tuple(yd.shape)}")
        return len(inputs)

    n_inputs, _ = held_run("pad_to_blocks and iterative (no kernel)", pads_and_scans, calls, errs,
                           want={})
    log(f"phase 3 ok: pad_to_blocks in {len(PAD_MODES)} modes on {n_inputs} card tensors "
        f"({GAP_PAD_SHAPES}, float32 and int32) == the CPU's bit for bit; iterative over an "
        "empty axis (axes 0 and 1, both directions) == the CPU's, carry unchanged")

    # the engine given its mesh positionally, the reference's order
    try:
        engine_mod.ExecutionEngine([device])
    except TypeError as e:
        if "devices=" not in str(e):
            raise PhaseError(f"ExecutionEngine([device]) raised {e!r}, naming no devices=")
    else:
        raise PhaseError("ExecutionEngine([device]) took a device list as its mesh")
    started = not dist.is_initialized()
    mesh = engine_mod.make_data_mesh()
    g = torch.Generator(device=device).manual_seed(SEED + 303)
    tree = {"w": torch.randn((2048, 2048), generator=g, device=device) * 0.02,
            "b": torch.ones(2048, device=device)}
    try:
        with engine_mod.ExecutionEngine(mesh) as on_mesh, \
                engine_mod.ExecutionEngine(devices=[device]) as plain_eng:
            if on_mesh.mesh is not mesh or on_mesh.devices != [device]:
                raise PhaseError(f"ExecutionEngine(mesh): mesh {on_mesh.mesh}, ring "
                                 f"{on_mesh.devices}")
            (fm, _st), _ = held_run("ExecutionEngine(mesh) positional .compress_pytree",
                                    lambda: on_mesh.compress_pytree(tree), calls, errs,
                                    must=("zfp_block.compress_blocks",))
            fd, _ = plain_eng.compress_pytree(tree)
    finally:
        if started:
            dist.destroy_process_group()
    for key, cm in fm.items():
        equal = (cm.to_bytes() == fd[key].to_bytes()) if hasattr(cm, "to_bytes") \
            else same_bits(cm, fd[key])
        if not equal:
            raise PhaseError(f"ExecutionEngine(mesh): leaf {key} differs from the devices= "
                             "engine's")
    seconds = time.perf_counter() - t_phase
    log(f"phase 3 ok: ExecutionEngine(make_data_mesh()) given positionally: compress_pytree of "
        f"{len(fm)} leaves == the devices= engine's bytes; a device list there raises TypeError")
    log(f"phase 5: {card}: the closed API gaps took {seconds:.2f} s (host wall, the plain "
        f"versions' runs included); launches "
        f"{json.dumps({k: {n: c for n, c in v.items() if c} for k, v in calls.items()})}")
    del tree, fm, fd
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs, "seconds": seconds}


def load_example(name: str):
    """``examples/<name>_torch.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def quickstart_want(n: int) -> dict:
    """The launches of the quickstart example on an ``n``^3 field: two MGARD
    round trips, two ZFP round trips and the re-encode, one huffman-bytes
    round trip."""
    solves = mgard_solves((n, n, n))
    return {"tridiag.solve_mass": 4 * solves, "quantize_map.quantize": 2,
            "quantize_map.dequantize": 2, "histogram.histogram": 3,
            "huffman_encode.encode_lookup": 3, "huffman_decode.decode_chunks": 3,
            "zfp_block.compress_blocks": 3, "zfp_block.decompress_blocks": 2}


def phase_examples(device, api, card: str) -> dict:
    """Phases 3 and 5, the four examples through their ``main`` at the
    reference's own settings, on the card: quickstart on the 64^3 field
    (launches exact; MGARD within its relative bounds, the lossless round
    trip exact, the re-encode a CMM hit), serve_batched on qwen2.5-3b's
    smoke cut (5 requests on 2 slots, the cache parked at zfp rate 12 and
    resumed; the same tokens as the CPU's run on the same weights),
    compressed_checkpoint_io on qwen1.5-4b's smoke cut (four policies saved
    and restored: lossless exact, zfp and MGARD within their bounds), and
    train_lm ``--preset small`` for its 200 steps and ``--preset 100m`` for
    20 (every loss finite, the exact checkpoints' report).  Every launch
    inside each example held to its plain version."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, load_params

    calls, errs, times = {}, {}, {}
    cpu = torch.device("cpu")

    ex = load_example("quickstart")
    out, sec = held_run(f"examples/quickstart_torch.py ({EXAMPLE_EDGE}^3)",
                        lambda: ex.main(EXAMPLE_EDGE), calls, errs,
                        want=quickstart_want(EXAMPLE_EDGE))
    for row in out["methods"]:
        bound = row["params"].get("error_bound", 0.0 if row["method"] == "huffman-bytes"
                                  else ERR_TOL * 2 ** (16 - row["params"].get("rate", 16)))
        if not row["max_rel_err"] <= bound:
            raise PhaseError(f"quickstart {row['method']} {row['params']}: relative error "
                             f"{row['max_rel_err']} > {bound}")
    if out["reencode_hits"] != 1:
        raise PhaseError(f"quickstart: the re-encode made {out['reencode_hits']} CMM hits")
    times[f"quickstart ({EXAMPLE_EDGE}^3)"] = sec

    ex = load_example("serve_batched")
    cfg = get_config("qwen2.5-3b").smoke()
    params = build_model(cfg).init(torch.Generator(device=device).manual_seed(0), device)
    out, sec = held_run("examples/serve_batched_torch.py", lambda: ex.main(params=params), calls,
                        errs, must=("zfp_block.compress_blocks", "zfp_block.decompress_blocks"))
    on_cpu = ex.main(device="cpu", params=load_params(params, cpu))
    if out["tokens"] != on_cpu["tokens"]:
        raise PhaseError(f"serve_batched: the card's tokens {out['tokens']} differ from the "
                         f"CPU's {on_cpu['tokens']}")
    if any(len(t) != 8 or not all(0 <= x < cfg.vocab for x in t) for t in out["tokens"].values()):
        raise PhaseError(f"serve_batched: tokens {out['tokens']}")
    for key, want_arr in on_cpu["cache"].items():
        if isinstance(want_arr, torch.Tensor) and want_arr.is_floating_point():
            got = out["cache"][key].cpu()
            if not float((got - want_arr).abs().max()) <= 0.05 * max(
                    1e-6, float(want_arr.abs().max())):
                raise PhaseError(f"serve_batched: the resumed cache's {key} is off the CPU's")
    times["serve_batched"] = sec
    del params

    ex = load_example("compressed_checkpoint_io")
    out, sec = held_run("examples/compressed_checkpoint_io_torch.py", ex.main, calls, errs,
                        must=HELD_KERNELS)
    rows = {r["policy"]: r for r in out["policies"]}
    params = build_model(get_config("qwen1.5-4b").smoke()).init(
        torch.Generator(device=device).manual_seed(0), device)
    leaves = ex.leaves(params)
    span = max(float(x.max() - x.min()) for x in leaves)
    checks = {"lossless (huffman-bytes)": 0.0, "zfp rate-28 (~1e-6 rel)": 1e-5 * span,
              "zfp rate-16 (transport)": 5e-3 * span, "mgard eb 1e-4": 1e-4 * span}
    for name, bound in checks.items():
        if not rows[name]["max_abs_err"] <= bound or not rows[name]["ratio"] > 0:
            raise PhaseError(f"compressed_checkpoint_io {name}: max |error| "
                             f"{rows[name]['max_abs_err']} > {bound} or ratio {rows[name]['ratio']}")
    times["compressed_checkpoint_io"] = sec
    del params, leaves

    ex = load_example("train_lm")
    for preset, steps in EXAMPLE_TRAIN.items():
        with tempfile.TemporaryDirectory() as d:
            argv = ["--preset", preset, "--steps", str(steps), "--ckpt-dir", d]
            out, sec = held_run(f"examples/train_lm_torch.py --preset {preset}",
                                lambda: ex.main(argv), calls, errs,
                                must=("histogram.histogram", "huffman_encode.encode_lookup"))
        r = out["ckpt_report"]
        if not (out["finite"] and out["result"]["steps_run"] == steps and r
                and r["step"] == steps):
            raise PhaseError(f"train_lm --preset {preset}: {out['result']}, finite "
                             f"{out['finite']}, checkpoint {r and r['step']}")
        step_ms = statistics.median(out["step_s"][-max(1, steps // 4):]) * 1e3
        times[f"train_lm --preset {preset}"] = sec
        log(f"phase 5: {card}: train_lm --preset {preset}: {steps} steps, "
            f"{out['n_params']} parameters, loss {out['result']['first_loss']:.4f} -> "
            f"{out['result']['last_loss']:.4f}, median step of the last quarter {step_ms:.2f} ms, "
            f"last exact checkpoint {r['raw_bytes']} -> {r['compressed_bytes']} bytes "
            f"(ratio {r['ratio']:.3f}) in {r['save_s']:.2f} s")
    log(f"phase 5: {card}: examples, host wall s with every launch held to its plain version: "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    log("phase 3 ok: the four examples at the reference's settings; launches "
        + json.dumps({k: {n: c for n, c in v.items() if c} for k, v in calls.items()}))
    torch.cuda.empty_cache()
    return {"calls": calls, "errs": errs, "times": times}



def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    # cuBLAS's deterministic workspace, read when its handle is made: the
    # training phase resumes a run bit for bit under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # keep what the report below reads; the served model, the trees and the
    # fields go before training needs the card's memory
    prog, pyt, st, ckpt, srv = ({"calls": r["calls"], "errs": r["errs"]}
                                for r in (prog, pyt, st, ckpt, srv))
    huff_runs = [{"counts": r["counts"], "errs": r["errs"]} for r in huff_runs]
    mgard_run = {"counts": mgard_run["counts"], "errs": mgard_run["errs"]}
    del field, c, out, main_res, tables, again
    from repro_torch.core.context import GLOBAL_CMM

    GLOBAL_CMM.clear()  # cached plans' device tables (the MGARD level map: 540 MB)
    torch.cuda.empty_cache()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(1, 1, device)  # a world-size-1 NCCL group, ended below
    train = phase_training(device, api, card, mesh)
    lap("phase 3 and 5, training")
    placed = phase_placed(device, api, card, mesh, train.pop("unplaced"))
    dist.destroy_process_group()
    del mesh
    lap("phase 3 and 5, placed path")
    GLOBAL_CMM.clear()  # the lossy checkpoint's plans: mamba2's step peaks at ~74 GB
    torch.cuda.empty_cache()
    ssm_train = phase_ssm_training(device, api, card)
    lap("phase 3 and 5, mamba2 training")
    ssm_serve = phase_ssm_serving(device, api, card)
    lap("phase 3 and 5, mamba2 serving")
    vlm = phase_vlm(device, api, card)
    lap("phase 3 and 5, qwen2-vl")
    GLOBAL_CMM.clear()  # the parked caches' plans: deepseek-v3's forward peaks at ~71 GB
    torch.cuda.empty_cache()
    ds = phase_moe_deepseek(device, api, card)
    lap("phase 3 and 5, deepseek-v3")
    l4 = phase_moe_llama4(device, api, card)
    lap("phase 3 and 5, llama4-scout")
    moe_cpu = phase_moe_vs_cpu(device, api)
    lap("phase 3, moe card vs CPU")
    moe_resume = phase_moe_resume(device, api, card)
    lap("phase 3 and 5, moe resume")
    GLOBAL_CMM.clear()  # the moe caches' plans: recurrentgemma-9b holds 37.6 GB of parameters
    torch.cuda.empty_cache()
    hyb_serve = phase_hybrid_serving(device, api, card)
    lap("phase 3 and 5, recurrentgemma-9b serving")
    hyb_train = phase_hybrid_training(device, api, card)
    lap("phase 3 and 5, recurrentgemma-9b training")
    hyb_smoke = phase_hybrid_smoke(device, api, card)
    lap("phase 3 and 5, hybrid smoke cut")
    ed = phase_encdec(device, api, card)
    lap("phase 3 and 5, seamless-m4t-medium")
    ed_cpu = phase_encdec_vs_cpu(device, api)
    lap("phase 3, encdec card vs CPU")
    GLOBAL_CMM.clear()  # the encdec state's plans, before the 512^3 fields
    torch.cuda.empty_cache()
    abst = phase_abstractions(device, api, card)
    lap("phase 3 and 5, abstractions and the standalone codec API")
    gaps = phase_api_gaps(device, api, card)
    lap("phase 3 and 5, the closed API gaps")
    exs = phase_examples(device, api, card)
    lap("phase 3 and 5, examples")
    calibrate.set_calibration_dir(None)
    cal_dir.cleanup()
    for k in huff_kernels:  # the entropy tail runs on the Huffman and the MGARD paths
        runs = huff_runs + [mgard_run]
        k["launches"] = sum(r["counts"][k["name"]] for r in runs)
        k["max_abs_err"] = max(r["errs"][k["name"]] for r in runs)
    # the progressive, pytree, stream, checkpoint, serving and training paths'
    # launches and checks join every kernel's
    new_paths = {"progressive": prog, "pytree": pyt, "stream": st, "checkpoint": ckpt,
                 "serving": srv, "training": train, "placed path": placed,
                 "mamba2 training": ssm_train,
                 "mamba2 serving": ssm_serve, "qwen2-vl": vlm, "deepseek-v3": ds,
                 "llama4-scout": l4, "moe card vs CPU": moe_cpu, "moe resume": moe_resume,
                 "recurrentgemma-9b serving": hyb_serve, "recurrentgemma-9b training": hyb_train,
                 "hybrid smoke cut": hyb_smoke, "seamless-m4t-medium": ed,
                 "encdec card vs CPU": ed_cpu, "abstractions and codec API": abst,
                 "closed API gaps": gaps, "examples": exs}
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
