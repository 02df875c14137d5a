"""The benchmark's arithmetic: rates, tails, spreads and roofline byte counts.

Every function here takes plain numbers, so the tests hold it on synthetic
timings.
"""

from __future__ import annotations

import math
import statistics


def phase_rate_gbps(field_bytes: list[int], phase_seconds: list[float]) -> float:
    """All field bytes of the window's phases over all their time, in GB/s
    (10^9 bytes).  A phase runs from its first call's start to its last
    output's completion, so the gaps between its calls count."""
    total = sum(phase_seconds)
    if total <= 0:
        raise ValueError("no phase time to divide by")
    return sum(field_bytes) / total / 1e9


def p95(values: list[float]) -> tuple[float, int, int]:
    """``(95th percentile by nearest rank, samples, samples above it)``."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = math.ceil(0.95 * len(ordered))
    return ordered[rank - 1], len(ordered), len(ordered) - rank


def spread(values: list[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def compress_roofline_bytes(field_bytes: int, stored_bytes: int) -> int:
    """The least traffic of a compress call: the field read once, the stored
    form written once, whatever implements the work."""
    return field_bytes + stored_bytes


def decompress_roofline_bytes(field_bytes: int, stored_bytes: int) -> int:
    """The least traffic of a decompress call: the stored form read once,
    the field written once."""
    return stored_bytes + field_bytes


def roofline_pct(least_bytes: int, peak_bytes_per_s: float, device_seconds: float) -> float | None:
    """Least time at the peak bandwidth over the device time, in %; None
    without device time (a share of a roofline is never reported as 0)."""
    if device_seconds <= 0 or least_bytes <= 0:
        return None
    return 100.0 * (least_bytes / peak_bytes_per_s) / device_seconds


def union_seconds(intervals: list[tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of ``[lo, hi]`` (ns) covered by any of the ns ``intervals``."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    covered, end = 0, lo
    for a, b in clipped:
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return covered / 1e9


def gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The ns intervals of ``[lo, hi]`` that no interval covers."""
    out, end = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out
