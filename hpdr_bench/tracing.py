"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result line need.

The harness wraps every call of the window in a ``record_function`` span of
its own, ``hpdr_bench.<phase>#<call index>``, and each call ends with its
output complete (synchronised), so the device work of a call lies inside its
span's host interval: a device operation belongs to the span that holds its
midpoint.  Device operations are the profiler's device events (kernels,
copies, fills), without its device-side annotations.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass, field as dfield
from pathlib import Path

from . import stats

SPAN_PREFIX = "hpdr_bench."
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


@dataclass
class Call:
    index: int
    phase: str           # "compress" | "decompress"
    field: int
    round: int
    seconds: float       # start mark to completion
    field_bytes: int
    stored_bytes: int


@dataclass
class DeviceOp:
    name: str
    start: int           # ns
    end: int
    kind: str            # "kernel" | "memcpy" | "memset"


@dataclass
class TraceData:
    calls: list[Call]
    spans: dict[int, tuple[int, int]] = dfield(default_factory=dict)  # call index -> host ns
    device_ops: list[DeviceOp] = dfield(default_factory=list)
    host_ops: list[tuple[str, int, int]] = dfield(default_factory=list)
    plan_misses: int | None = None
    stage_seconds: list[dict] | None = None
    device_name: str = ""

    @property
    def window(self) -> tuple[int, int] | None:
        if not self.spans:
            return None
        return min(a for a, _ in self.spans.values()), max(b for _, b in self.spans.values())

    def peak(self, key: str) -> float | None:
        """The card's published peak ``key`` (``peaks.json``), None for a card it lacks."""
        return json.loads(PEAKS_FILE.read_text()).get(self.device_name, {}).get(key)

    def phase_spans(self, phase: str) -> list[tuple[Call, int, int]]:
        by_index = {c.index: c for c in self.calls}
        return [(by_index[i], a, b) for i, (a, b) in sorted(self.spans.items())
                if i in by_index and by_index[i].phase == phase]

    def seconds_in(self, phase: str, kind: str = "kernel", name_has: str = "") -> float:
        """Summed time of the device operations of ``kind`` (whose name holds
        ``name_has``) inside ``phase``'s spans."""
        spans = sorted((a, b) for _, a, b in self.phase_spans(phase))
        starts = [a for a, _ in spans]
        total = 0
        for op in self.device_ops:
            if op.kind != kind or name_has not in op.name:
                continue
            mid = (op.start + op.end) // 2
            i = bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][0] <= mid <= spans[i][1]:
                total += op.end - op.start
        return total / 1e9

    def busy_seconds(self) -> float:
        win = self.window
        if win is None:
            return 0.0
        return stats.union_seconds([(o.start, o.end) for o in self.device_ops], *win)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def collect(prof, calls: list[Call]) -> TraceData:
    """The profiler's events, reduced: spans, device operations, host operations."""
    from torch.autograd import DeviceType

    data = TraceData(calls=calls)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                data.device_ops.append(DeviceOp(name, start, end, _kind(name)))
        elif name.startswith(SPAN_PREFIX) and "#" in name:
            data.spans[int(name.rsplit("#", 1)[1])] = (start, end)
        else:
            data.host_ops.append((name, start, end))
    return data


def _innermost(host: list[tuple[str, int, int]], starts: list[int], t: int) -> str:
    """Name of the latest-starting host operation open at ``t`` (nested
    operations start later than their parents), ``python`` where none is."""
    i = bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "python"


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the card's idle
    time by what the host was doing: the harness phase whose span was open
    and the innermost host operation open at the gap's middle."""
    by_name: dict[str, float] = {}
    for op in data.device_ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start) / 1e9
    idle: dict[str, float] = {}
    win = data.window
    if win is not None:
        spans = sorted((a, b, c.phase) for phase in ("compress", "decompress")
                       for c, a, b in data.phase_spans(phase))
        span_starts = [a for a, _, _ in spans]
        host = sorted(data.host_ops, key=lambda h: h[1])
        host_starts = [h[1] for h in host]
        for lo, hi in stats.gaps([(o.start, o.end) for o in data.device_ops], *win):
            mid = (lo + hi) // 2
            k = bisect_right(span_starts, mid) - 1
            phase = spans[k][2] if k >= 0 and spans[k][1] >= mid else "between calls"
            label = f"{phase}/{_innermost(host, host_starts, mid)}"
            idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e9
    order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order], "idle_gaps": [[k, v] for k, v in gaps]}
