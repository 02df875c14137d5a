"""The program's own spans in a traced window, and the device time they caused.

The program names its steps as ``record_function`` ranges,
``repro_torch.<name>`` (API calls, pipeline stages, steps of the standalone
ZFP API), while a profile runs; ``tracing.collect`` keeps them among the host
operations.  Spans of one thread nest, so a device operation launched while a
span was open was launched while that span, or a span nested in it, was the
innermost open program span: the span caused it.  A program without such
spans gives every reader here nothing, never an error.

A device operation is linked to the runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...) by
order, not by time: the profiler's device timestamps sit off the host's clock
by an amount that drifts within a run, so a host span is compared only with
host times.  The one-shot paths the cells run enqueue from one thread onto
one stream, which runs its work in the order given: the n-th launch of a kind
(kernel, copy, fill), by host start, enqueued the n-th device operation of
that kind, by device start.  Where the two counts of a kind differ, nothing
of that kind is linked.  Where a correction of the device clock puts two
operations out of order, the launches of those between them shift by one:
adjacent launches, almost always inside the same span.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from itertools import accumulate

PREFIX = "repro_torch."


def program_spans(trace) -> list[tuple[str, int, int]]:
    """``(name without the prefix, start ns, end ns)`` of every program span,
    by start."""
    n = len(PREFIX)
    return sorted(((h[0][n:], h[1], h[2]) for h in trace.host_ops if h[0].startswith(PREFIX)),
                  key=lambda s: s[1])


def per_call(trace, name: str, phase: str) -> list[list[tuple[int, int]]]:
    """For each call of ``phase`` (its harness span), the host intervals of the
    program span ``name`` that start inside it.  Empty where the window has
    no such span at all."""
    found = [(a, b) for s, a, b in program_spans(trace) if s == name]
    if not found:
        return []
    starts = [a for a, _ in found]
    return [found[bisect_left(starts, lo):bisect_right(starts, hi)]
            for _, lo, hi in trace.phase_spans(phase)]


def self_ns(trace, name: str, phase: str) -> list[int]:
    """For each call of ``phase``: the summed self time of span ``name``, its
    duration less what the program spans nested in it cover."""
    spans = program_spans(trace)
    starts = [a for _, a, _ in spans]
    out = []
    for intervals in per_call(trace, name, phase):
        total = 0
        for lo, hi in intervals:
            covered, end = 0, lo
            # nested spans start inside [lo, hi]; the span itself is skipped
            for _, a, b in spans[bisect_left(starts, lo):bisect_right(starts, hi)]:
                if (a, b) == (lo, hi) or b > hi:
                    continue
                if b > end:
                    covered += b - max(a, end)
                    end = b
            total += hi - lo - covered
        out.append(total)
    return out


def launch_kind(name: str) -> str | None:
    """The kind of device operation (``tracing.DeviceOp.kind``) that the CUDA
    runtime or driver call ``name`` enqueues; None for a call that enqueues
    none (a synchronise, an event, an allocation, an attribute query)."""
    if not name.startswith("cu"):
        return None
    if "Launch" in name and "Kernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "memcpy"
    if "Memset" in name:
        return "memset"
    return None


def launch_calls(trace) -> list[tuple[int, str]]:
    """``(host start ns, kind)`` of every runtime call that enqueued device
    work, by start."""
    calls = []
    for name, start, _ in trace.host_ops:
        kind = launch_kind(name)
        if kind is not None:
            calls.append((start, kind))
    calls.sort()
    return calls


def launch_times(trace, calls: list[tuple[int, str]] | None = None) -> list[int | None]:
    """For each of ``trace.device_ops``, the host start (ns) of the runtime
    call that launched it (among ``calls``, by default ``launch_calls``);
    None for every operation of a kind whose launches and operations differ
    in number."""
    calls = launch_calls(trace) if calls is None else calls
    out: list[int | None] = [None] * len(trace.device_ops)
    for kind in {k for _, k in calls}:
        starts = [t for t, k in calls if k == kind]
        ops = sorted((i for i, o in enumerate(trace.device_ops) if o.kind == kind),
                     key=lambda i: (trace.device_ops[i].start, trace.device_ops[i].end))
        if len(ops) == len(starts):
            for i, t in zip(ops, starts):
                out[i] = t
    return out


class Launches:
    """The device operations by the time their launch began: device ns of the
    operations launched inside a host interval, and the first launch there."""

    def __init__(self, trace):
        calls = launch_calls(trace)
        linked = sorted((t, o.end - o.start) for t, o in
                        zip(launch_times(trace, calls), trace.device_ops) if t is not None)
        self.times = [t for t, _ in linked]
        self.cumulative = [0, *accumulate(d for _, d in linked)]
        self.calls = [t for t, _ in calls]

    def device_ns(self, lo: int, hi: int) -> int:
        i, j = bisect_left(self.times, lo), bisect_right(self.times, hi)
        return self.cumulative[j] - self.cumulative[i]

    def first_launch(self, lo: int, hi: int) -> int | None:
        i = bisect_left(self.calls, lo)
        return self.calls[i] if i < len(self.calls) and self.calls[i] <= hi else None


def device_ms_per_call(trace, name: str, phase: str) -> float | None:
    """Milliseconds of device time launched inside span ``name`` (or a span
    nested in it), summed over the window's calls of ``phase`` and divided by
    their count; None where the program emits no such span or no device
    operation is linked to its launch."""
    calls = per_call(trace, name, phase)
    if not calls:
        return None
    launches = Launches(trace)
    if not launches.times:
        return None
    total = sum(launches.device_ns(a, b) for intervals in calls for a, b in intervals)
    return total / len(calls) / 1e6


def self_ms_per_call(trace, name: str, phase: str) -> float | None:
    """Milliseconds of self time of span ``name`` a call of ``phase``."""
    found = self_ns(trace, name, phase)
    return sum(found) / len(found) / 1e6 if found else None


def lead_ms_per_call(trace, name: str, phase: str) -> float | None:
    """Milliseconds from the start of span ``name`` to the start of the first
    runtime call inside it that launched device work, a call of ``phase``:
    host time before the card is given work, on the host's clock.  Calls
    whose span launched nothing are left out; None where nothing was
    launched."""
    calls = per_call(trace, name, phase)
    if not calls:
        return None
    launches = Launches(trace)
    leads = []
    for intervals in calls:
        for a, b in intervals[:1]:
            first = launches.first_launch(a, b)
            if first is not None:
                leads.append(first - a)
    return sum(leads) / len(leads) / 1e6 if leads else None
