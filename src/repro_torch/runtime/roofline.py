"""Roofline model (counterpart of ``repro.runtime.roofline``): the
model-FLOP half with the H100's datasheet constants, and the
measured-machine stream model.

Model FLOPs (training side)
---------------------------
    compute    = FLOPs per device / peak FLOP/s
    memory     = bytes per device / HBM bandwidth
    collective = link bytes per device / link bandwidth

:func:`model_flops` uses 6·N·D (dense train), 6·N_active·D (MoE) and the
matching analytic forms for prefill and decode (attention and KV-read
bytes included); :func:`analytic_memory_bytes` the analytic HBM traffic.
The constants are NVIDIA's H100 SXM datasheet figures (dense, no
sparsity, at the full 700 W power limit); the reference's are a TPU's and
do not carry over.  :func:`terms_from_analysis` takes the reference's
``cost`` dict (``{"flops", "bytes accessed"}``); PyTorch has no
counterpart of XLA's ``cost_analysis``, so the caller gives the bytes and
usually ``flops_override`` (:func:`model_flops`).

Measured-machine stream model (HPDR §V-C auto-tuner substrate)
--------------------------------------------------------------
:func:`simulate_stream` and :func:`stream_lane_seconds` take *calibrated*
per-stage cost functions from ``runtime/calibrate.py`` and replay the
lane-overlapped ``ChunkedPipeline`` schedule (main-thread H2D staging,
compute lane, io lane, in-flight ``window`` anti-dependency) through the
event-driven ``TimelineSimulator`` to predict a stream's makespan for a
candidate (chunk size, window) — the solver substrate of ``core/tuner.py``.
No datasheet constant enters this half: every rate is measured on the card
at hand.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 SXM datasheet (dense, no sparsity, 700 W)
PEAK_FLOPS = 989e12     # bfloat16 FLOP/s a card
HBM_BW = 3.35e12        # B/s a card
NVLINK_BW = 450e9       # B/s a card, each way (900 GB/s both ways)
HBM_PER_CHIP = 80e9     # B


@dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    bytes_accessed: float
    link_bytes: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "link_bytes_per_device": self.link_bytes,
        }


def terms_from_analysis(
    cost: dict | None, link_bytes: float, flops_override: float | None = None
) -> RooflineTerms:
    """Roofline terms from ``{"flops", "bytes accessed"}`` (per device) and
    the link bytes; ``flops_override`` replaces the cost's FLOPs."""
    flops = float(flops_override if flops_override is not None
                  else (cost or {}).get("flops", 0.0))
    nbytes = float((cost or {}).get("bytes accessed", 0.0))
    return RooflineTerms(
        t_compute=flops / PEAK_FLOPS,
        t_memory=nbytes / HBM_BW,
        t_collective=link_bytes / NVLINK_BW,
        flops=flops,
        bytes_accessed=nbytes,
        link_bytes=link_bytes,
    )


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def count_params(params_shape) -> dict:
    """Split parameter counts: embedding / expert / other, from a tree whose
    leaves have ``.shape`` (``Model.param_shapes()``: tensors on the
    ``meta`` device)."""
    from ..core import api

    counts = {"embed": 0, "expert": 0, "other": 0}
    for key, leaf in api.flatten_with_keys(params_shape, "\0"):
        names = key.split("\0")
        n = math.prod(leaf.shape)
        if "table" in names or ("head" in names):
            counts["embed"] += n
        elif "moe" in names and names[-1] in {"wg", "wu", "wd"}:
            counts["expert"] += n
        else:
            counts["other"] += n
    return counts


def active_params(cfg: ModelConfig, counts: dict) -> float:
    """N_active: experts scaled by (top_k + shared-equivalent)/n_experts."""
    n = counts["other"]
    if cfg.moe is not None and counts["expert"]:
        frac = cfg.moe.top_k / max(cfg.moe.n_experts, 1)
        n += counts["expert"] * frac
        # shared experts are inside "other" via the shared swiglu params
    return float(n)


def model_flops(cfg: ModelConfig, shape: ShapeConfig, counts: dict) -> dict:
    """Analytic FLOPs for the whole (global) step + useful-compute ratio base."""
    hd = cfg.resolved_head_dim
    n_act = active_params(cfg, counts)
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    attn_layers = cfg.n_layers
    if cfg.family == "ssm":
        attn_layers = 0
    if cfg.family == "hybrid":
        attn_layers = cfg.n_layers // 3  # 1-in-3 local attention
        s_eff = min(s, cfg.hybrid.window)
    else:
        s_eff = s

    if shape.kind == "train":
        mm = 6.0 * n_act * tokens
        # fwd ≈ 2·B·S·S_eff·H·hd (causal ≈ /2 folded in), ×3 with the backward
        attn = 3.0 * attn_layers * 2.0 * b * s * s_eff * cfg.n_heads * hd
        return {"model_flops": mm + attn, "matmul_flops": mm, "attn_flops": attn}
    if shape.kind == "prefill":
        mm = 2.0 * n_act * tokens
        attn = attn_layers * 2.0 * b * s * s_eff * cfg.n_heads * hd
        return {"model_flops": mm + attn, "matmul_flops": mm, "attn_flops": attn}
    # decode: one token per sequence; S is the cache length
    mm = 2.0 * n_act * b
    attn = attn_layers * 4.0 * b * min(s, s_eff if cfg.family == "hybrid" else s) * \
        cfg.n_heads * hd
    kv_bytes = _decode_state_bytes(cfg, b, s)
    return {
        "model_flops": mm + attn, "matmul_flops": mm, "attn_flops": attn,
        "state_read_bytes": kv_bytes,
    }


def analytic_memory_bytes(
    cfg: ModelConfig, shape: ShapeConfig, counts: dict,
    bytes_per_device: int, chips: int,
) -> float:
    """Per-device HBM traffic estimate.

    train:   params f32 read(fwd)+read(bwd)+write + m/v read+write (f32)
             + layer-carry activations write+read (bf16) + logits traffic
    prefill: params read + activations write
    decode:  active params read + state read/write
    """
    p_local = float(bytes_per_device)  # param bytes per device (param_dtype)
    b, s = shape.global_batch, shape.seq_len
    tokens_local = b * (s if shape.kind != "decode" else 1) / chips
    d = cfg.d_model
    act_carry = tokens_local * d * 2.0 * 2.0 * cfg.n_layers  # bf16 write+read
    vocab_local = cfg.vocab / chips
    if shape.kind == "train":
        logits = tokens_local * vocab_local * 4.0 * 3.0 * chips / max(chips, 1)
        return 8.0 * p_local + act_carry + logits
    if shape.kind == "prefill":
        return p_local + act_carry
    # decode
    n_total = max(counts["other"] + counts["expert"], 1)
    active_frac = active_params(cfg, counts) / n_total
    state = _decode_state_bytes(cfg, b, s) / chips
    return p_local * active_frac + 2.0 * state


def simulate_stream(
    chunk_sizes,
    h2d_time,
    compute_time,
    serialize_time,
    window: int,
    window_overhead_s: float = 0.0,
):
    """Predict the lane-overlapped ``ChunkedPipeline`` makespan.

    Mirrors the real scheduler (three lanes): chunk *i* is ``I_i``
    (main-thread slice + staging copy) → ``R_i`` (compute lane) → ``S_i``
    (io lane: D2H fetch + container serialization), with the bounded-window
    anti-dependency ``I_i ← S_{i-window}``.  ``window=1`` reproduces the
    fully serial schedule.  ``window_overhead_s`` is the calibrated
    per-chunk scheduling cost the pipelined schedule pays over serial; it
    is charged on the staging task only when ``window > 1``.

    ``h2d_time``/``compute_time``/``serialize_time`` map chunk bytes →
    seconds.  Returns ``(makespan_seconds, schedule_dict)``.
    """
    from ..core import pipeline as pl  # lazy: keep layering acyclic

    window = max(1, int(window))
    ov = float(window_overhead_s) if window > 1 else 0.0
    tasks = []
    for i, c in enumerate(chunk_sizes):
        deps = (f"S{i - window}",) if i >= window else ()
        tasks.append(pl.Task(f"I{i}", pl.H2D, h2d_time(c) + ov, deps))
        tasks.append(pl.Task(f"R{i}", pl.COMPUTE, compute_time(c), (f"I{i}",)))
        tasks.append(pl.Task(f"S{i}", pl.D2H, serialize_time(c), (f"R{i}",)))
    sched = pl.TimelineSimulator().run(tasks)
    return pl.TimelineSimulator.makespan(sched), sched


def stream_lane_seconds(
    chunk_sizes, h2d_time, compute_time, serialize_time
) -> dict:
    """Per-lane serial-sum seconds for a chunk schedule (the no-overlap
    bound the measured ``ChunkedResult.lane_seconds()`` is compared to)."""
    return {
        "h2d": sum(h2d_time(c) for c in chunk_sizes),
        "compute": sum(compute_time(c) for c in chunk_sizes),
        "serialize": sum(serialize_time(c) for c in chunk_sizes),
    }


def _decode_state_bytes(cfg: ModelConfig, batch: int, s: int) -> float:
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        ssm = cfg.ssm
        d_inner = ssm.expand * cfg.d_model
        h = d_inner // ssm.head_dim
        return cfg.n_layers * batch * h * ssm.head_dim * ssm.d_state * 4.0
    if cfg.family == "hybrid":
        nsuper = cfg.n_layers // 3
        w = cfg.hybrid.lru_width or cfg.d_model
        rec = 2 * nsuper * batch * w * 4.0
        attn_cache = nsuper * batch * min(s, cfg.hybrid.window) * cfg.n_kv_heads * hd * 2 * 2.0
        return rec + attn_cache
    if cfg.attn_type == "mla":
        m = cfg.mla
        return cfg.n_layers * batch * s * (m.kv_lora_rank + m.qk_rope_head_dim) * 2.0
    return cfg.n_layers * batch * s * cfg.n_kv_heads * hd * 2 * 2.0


def device_label(device) -> str:
    """What a printed rate was measured on: ``"CPU"``, or the card's name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives
    them (a card may run below its 700 W maximum, and slower under load)."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "CPU"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
