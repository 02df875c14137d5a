#!/usr/bin/env python3
"""Cost of one of the port's spans (``repro_torch.runtime.trace.span``).

Run from the root of a checkout:

    python3 scripts/span_cost.py

Prints microseconds a span, best of five loops, the empty loop's time taken
off: ``off`` with no profile running (one read of the profiler's flag),
``on`` under a ``torch.profiler`` profile of the CPU and, where there is
one, the CUDA card (a ``record_function`` range), and ``ungated_off``, a
``record_function`` entered with no profile running, which is what a span
without the flag would cost.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.runtime.trace import span  # noqa: E402


def per_span(loop, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        loop(n)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def empty(n):
    for _ in range(n):
        pass


def gated(n):
    for _ in range(n):
        with span("bench"):
            pass


def ungated(n):
    for _ in range(n):
        with torch.profiler.record_function("repro_torch.bench"):
            pass


def main() -> None:
    base = per_span(empty, 1_000_000)
    off = per_span(gated, 1_000_000) - base
    raw = per_span(ungated, 100_000) - base
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities):
        on = per_span(gated, 20_000) - base
    print(f"span_cost_us off {off:.4f} on {on:.3f} ungated_off {raw:.3f} (loop {base:.4f})")


if __name__ == "__main__":
    main()
