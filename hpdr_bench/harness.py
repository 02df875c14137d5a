"""One run of one cell: set-up, the measured window, the traced reading, the check.

The window is a closed loop with one caller, in rounds (``traffic.py``).
Every call is timed from a mark made just before it to the completion of its
output: on the card, CUDA events on the current stream, which is idle when a
call starts because the previous call's output was waited for; on the CPU
(the tests), the host clock.  A phase (the compress or the decompress calls
of a round) runs from its first call's start mark to its last call's
completion, so the gaps between its calls count.  A configuration's
``resident_snapshots`` (0 where absent) is how many rounds' stored forms stay
held, as a deployment keeps them; set-up fills them.

With ``trace`` the same window runs under ``torch.profiler``, each call in a
span of the harness's own (``tracing.py``), and the per-layer readers
(``metrics/``) reduce it; the program's stage profiler is called after the
window.  The check (``checks/``) runs last, once the program's state is
freed, on the outputs sampled from the window.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import math
import sys
import time
from dataclasses import dataclass, field as dfield

import torch

from . import data, spec, stats, tracing, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, a JAX library's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Clock:
    """Marks on the card's stream (CUDA events) or, on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def complete(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


@dataclass
class Phase:
    name: str
    field_bytes: int
    seconds: float


@dataclass
class Window:
    """What the measured window did: its calls and phases, and set-up."""

    calls: list[tracing.Call] = dfield(default_factory=list)
    phases: list[Phase] = dfield(default_factory=list)
    setup_s: float = 0.0
    failed: int = 0
    errors: list[str] = dfield(default_factory=list)

    def of(self, phase: str) -> list[tracing.Call]:
        return [c for c in self.calls if c.phase == phase]


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: dict | None = None
    notes: list[str] = dfield(default_factory=list)


def scaled(config: dict, scale: dict | None) -> dict:
    """``config`` with ``data`` entries replaced (``shape``, ``fields``): the
    tests' small sizes; a run on the card takes the configuration as it is."""
    config = copy.deepcopy(config)
    for key, value in (scale or {}).items():
        config["data"][key] = value
    return config


def _build_kernels(device: torch.device) -> None:
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # every library at once, in parallel; loaded on first launch


class _Runner:
    def __init__(self, driver, fields, plan, clock, window: Window, resident: int):
        self.driver, self.fields, self.plan = driver, fields, plan
        self.clock, self.w = clock, window
        self.kept: dict[int, list] = {}  # field -> [stored form, reconstruction or None]
        self.held = collections.deque(maxlen=resident) if resident else None
        self.spans = False
        self.count = 0  # call index: names the call's span

    def _span(self, name: str):
        if self.spans:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def round(self, r: int, timed: bool) -> None:
        order = self.plan.order()
        outs = {}
        for phase in self.plan.phases:
            first = last = None
            phase_bytes = 0
            for f in order:
                if phase == "decompress" and f not in outs:
                    continue
                index, self.count = self.count, self.count + 1
                with self._span(f"{tracing.SPAN_PREFIX}{phase}#{index}"):
                    start = self.clock.mark()
                    try:
                        if phase == "compress":
                            result = self.driver.compress(self.fields[f])
                        else:
                            result = self.driver.decompress(outs[f])
                        end = self.clock.mark()
                        self.clock.complete(end)
                    except Exception as exc:  # a failed call is counted, and the run goes on
                        if not timed:
                            raise
                        self.w.failed += 1
                        self.w.errors.append(f"{phase} of field {f}, round {r}: {exc!r}")
                        if self.clock.cuda:
                            torch.cuda.synchronize()
                        continue
                if phase == "compress":
                    outs[f] = result
                    if timed and self.plan.keep(f):
                        self.kept[f] = [result, None]
                elif timed and f in self.kept and self.kept[f][0] is outs[f]:
                    self.kept[f][1] = result
                if not timed:
                    continue
                nbytes = self.fields[f].numel() * self.fields[f].element_size()
                stored = self.driver.stored_bytes(outs[f])
                self.w.calls.append(tracing.Call(index, phase, f, r, self.clock.seconds(start, end),
                                                 nbytes, stored))
                first = start if first is None else first
                last = end
                phase_bytes += nbytes
            if timed and first is not None:
                self.w.phases.append(Phase(phase, phase_bytes, self.clock.seconds(first, last)))
        if self.held is not None:
            self.held.append(outs)  # the oldest round's stored forms are let go


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device, *,
             t0: float | None = None, driver=None, scale: dict | None = None) -> Outcome:
    """One run: set-up from ``t0`` (the process's start), warm-up, ``seconds``
    of rounds, the per-layer reading where ``trace``, then the check."""
    t0 = time.perf_counter() if t0 is None else t0
    config = scaled(cell.config, scale)
    check = spec.module("checks", config["check"])
    if driver is None:
        _build_kernels(device)
        driver = spec.module("drivers", config["driver"]).Driver(config, device)
    fields = data.make_fields(config["data"], seed, device)
    plan = traffic.Rounds(cell.traffic, len(fields), seed)
    clock = Clock(device)
    w = Window()
    resident = int(config.get("resident_snapshots", 0))
    runner = _Runner(driver, fields, plan, clock, w, resident)
    warmup = traffic.WARMUP_ROUNDS + resident  # the held rounds filled, and one more allocated
    for r in range(warmup):
        runner.round(-1 - r, timed=False)
    if clock.cuda:
        torch.cuda.synchronize()
    w.setup_s = time.perf_counter() - t0

    misses0 = driver.plan_misses()
    profiler = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if clock.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        runner.round(-1 - warmup, timed=False)  # the profiler's own start-up
        runner.spans = True
    deadline = time.perf_counter() + seconds
    r = 0
    while r == 0 or time.perf_counter() < deadline:
        runner.round(r, timed=True)
        r += 1
    if profiler is not None:
        runner.spans = False
        profiler.__exit__(None, None, None)
    misses1 = driver.plan_misses()
    peak = torch.cuda.max_memory_allocated(device) if clock.cuda else 0
    dev = {"platform": "gpu" if clock.cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if clock.cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}

    metrics, found = {}, None
    if trace:
        found = tracing.collect(profiler, w.calls)
        found.device_name = dev["kind"]
        if misses0 is not None:
            found.plan_misses = misses1 - misses0
        stage = [driver.stage_seconds(f) for f in fields]
        found.stage_seconds = [s for s in stage if s is not None] or None
        win = found.window
        dev["busy_s"] = found.busy_seconds()
        dev["window_s"] = (win[1] - win[0]) / 1e9 if win else 0.0
        wanted = cell.per_layer
    else:
        wanted = cell.end_to_end
    for m in wanted:
        source = found if trace else w
        value = spec.module("metrics" if trace else "end_to_end", m["name"]).read(source)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.release()
    kept = runner.kept
    del runner
    if clock.cuda:
        torch.cuda.empty_cache()
    checks = judge(check, driver, config, fields, kept, "decompress" in plan.phases, w)
    outcome = Outcome(
        correct=all(v["value"] is not None and v["value"] <= v["limit"] for v in checks.values()),
        attempted=len(w.calls) + w.failed, failed=w.failed, metrics=metrics, device=dev,
        checks=checks, notes=list(w.errors[:5]))
    if trace:
        outcome.breakdown = tracing.breakdown(found)
    if w.of("compress"):
        p95, n, beyond = stats.p95([c.seconds for c in w.of("compress")])
        outcome.notes.append(f"compress_p95_ms over {n} compress calls, {beyond} above it: "
                             f"{p95 * 1e3!r}")
    return outcome


def judge(check, driver, config: dict, fields, kept: dict, with_recon: bool, w: Window) -> dict:
    """Each number the check compares, aggregated over the sampled outputs
    (``check.LIMITS``: a sum or a maximum), beside its limit; with the failed
    calls and the missing samples.  Where the traffic decompresses, a sample
    without its reconstruction is missing; where it does not, the numbers of
    ``check.NEEDS_RECON`` are not compared.  A number with no sample, or not
    finite, is None, which no limit passes."""
    samples = [check.compare(fields[f], driver.sections(out), driver.meta(out), recon, config)
               for f, (out, recon) in sorted(kept.items()) if recon is not None or not with_recon]
    out = {"failed_calls": {"value": w.failed, "limit": 0},
           "samples_missing": {"value": len(fields) - len(samples), "limit": 0}}
    for name, (how, limit) in check.LIMITS.items():
        if not with_recon and name in check.NEEDS_RECON:
            continue
        vals = [s[name] for s in samples if name in s]
        v = {"sum": sum, "max": max}[how](vals) if vals else None
        out[name] = {"value": v if v is not None and math.isfinite(v) else None, "limit": limit}
    return out
