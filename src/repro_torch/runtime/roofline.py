"""Measured-machine stream model — the tuner's half of the reference's
``repro.runtime.roofline`` (HPDR §V-C auto-tuner substrate).

:func:`simulate_stream` and :func:`stream_lane_seconds` take *calibrated*
per-stage cost functions from ``runtime/calibrate.py`` and replay the
lane-overlapped ``ChunkedPipeline`` schedule (main-thread H2D staging,
compute lane, io lane, in-flight ``window`` anti-dependency) through the
event-driven ``TimelineSimulator`` to predict a stream's makespan for a
candidate (chunk size, window) — the solver substrate of ``core/tuner.py``.
No datasheet constant enters the model: every rate is measured on the card
at hand.  The reference's model-FLOP half (training-side roofline terms) is
not part of the port yet.
"""

from __future__ import annotations


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
