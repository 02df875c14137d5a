"""HDEM — Host-Device Execution Model and the optimized pipeline (HPDR §V),
in PyTorch (counterpart of ``repro.core.pipeline``).

Machine abstraction (paper Fig. 8): one compute engine + two independent DMA
engines (H2D, D2H).  The optimized pipeline (paper Fig. 9) is a depth-3,
two-buffer chunked DAG:

  queue i:   I_i (H2D) → R_i (compute) → O_i (D2H) → S_i (serialize)
  anti-dep:  I_i depends on S_{i-2}   — the (X+2)%3 rule that cuts the
             buffer requirement from 3 sets to 2;
  launch-order inversion (reconstruction): deserialize D_{i+1} is issued
             *before* output copy O_i on the shared DMA so the next
             reconstruction's compute is not delayed.

Two execution surfaces:

  * :class:`TimelineSimulator` — deterministic event-driven schedule for a
    task DAG with per-resource issue order (CUDA-stream semantics), the
    reference's arithmetic unchanged.
  * :class:`ChunkedPipeline` — real chunked execution: each chunk is staged
    on the main thread through a page-locked host buffer of its window slot
    and an asynchronous copy on a dedicated CUDA copy stream
    (:class:`PinnedStager`), computed on the executor's compute lane (whose
    stream waits on the copy's event), and fetched into page-locked memory
    and serialised on the io lane, bounded at ``window`` in-flight chunks.
    Used by ``api.CompressorStream`` and the checkpoint writer.
  * :func:`reconstruct_chunked` — the reconstruction run of Fig. 9 (bottom):
    chunk *i+1*'s sections are staged through its slot's page-locked buffer
    while chunk *i* decodes on the compute lane, and each chunk is written
    into its own slice of one output tensor.
"""

from __future__ import annotations

import ctypes
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..runtime.trace import span
from . import adapters, chunk_model

H2D, D2H, COMPUTE = "h2d", "d2h", "compute"
RESOURCES = (H2D, D2H, COMPUTE)


# ---------------------------------------------------------------------------
# Task DAG + event-driven timeline simulator
# ---------------------------------------------------------------------------


@dataclass
class Task:
    name: str
    resource: str
    duration: float
    deps: tuple[str, ...] = ()


@dataclass
class ScheduledTask:
    name: str
    resource: str
    start: float
    end: float


class TimelineSimulator:
    """Schedule tasks in issue order with per-resource serialization.

    Tasks issue in list order; a task starts at
    ``max(resource_free, max(dep.end))`` — exactly the semantics of enqueueing
    onto per-engine hardware queues (CUDA streams / TPU DMA queues).
    """

    def run(self, tasks: Sequence[Task]) -> dict[str, ScheduledTask]:
        free = {r: 0.0 for r in RESOURCES}
        done: dict[str, ScheduledTask] = {}
        for t in tasks:
            dep_end = max((done[d].end for d in t.deps if d in done), default=0.0)
            start = max(free[t.resource], dep_end)
            end = start + t.duration
            done[t.name] = ScheduledTask(t.name, t.resource, start, end)
            free[t.resource] = end
        return done

    @staticmethod
    def makespan(sched: dict[str, ScheduledTask]) -> float:
        return max((s.end for s in sched.values()), default=0.0)

    @staticmethod
    def overlap_ratio(sched: dict[str, ScheduledTask]) -> float:
        """Paper §V-C: overlapped copy time / total copy time.

        A copy instant counts as overlapped ("hidden") when any *other*
        engine — compute or the opposite-direction DMA — is busy at that
        instant.
        """
        copies = [s for s in sched.values() if s.resource in (H2D, D2H)]
        total = sum(s.end - s.start for s in copies)
        if total == 0:
            return 1.0
        overlapped = 0.0
        for s in copies:
            others = [
                (o.start, o.end)
                for o in sched.values()
                if o.resource != s.resource
            ]
            # merge other-engine busy intervals, intersect with this copy
            others.sort()
            merged: list[tuple[float, float]] = []
            for st, en in others:
                if merged and st <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], en))
                else:
                    merged.append((st, en))
            for cs, ce in merged:
                lo, hi = max(s.start, cs), min(s.end, ce)
                if hi > lo:
                    overlapped += hi - lo
        return overlapped / total


def build_reduction_dag(
    chunk_sizes: Sequence[int],
    h2d_time: Callable[[int], float],
    compute_time: Callable[[int], float],
    d2h_time: Callable[[int], float],
    serialize_time: Callable[[int], float],
    two_buffer_dep: bool = True,
    window: int | None = None,
) -> list[Task]:
    """Reduction pipeline DAG of paper Fig. 9 (top).

    ``window`` generalizes the two-buffer anti-dependency to an arbitrary
    in-flight bound: ``I_i`` waits for ``S_{i-window}`` (``window=2`` is
    the paper's (X+2)%3 rule, ``window=1`` the fully serial schedule).
    ``None`` keeps the legacy ``two_buffer_dep`` behaviour.
    """
    if window is None:
        window = 2 if two_buffer_dep else 0
    window = int(window)
    tasks: list[Task] = []
    for i, c in enumerate(chunk_sizes):
        deps_i = (f"S{i-window}",) if (window > 0 and i >= window) else ()
        tasks.append(Task(f"I{i}", H2D, h2d_time(c), deps_i))
        tasks.append(Task(f"R{i}", COMPUTE, compute_time(c), (f"I{i}",)))
        tasks.append(Task(f"O{i}", D2H, d2h_time(c), (f"R{i}",)))
        tasks.append(Task(f"S{i}", D2H, serialize_time(c), (f"O{i}",)))
    return tasks


def build_reconstruction_dag(
    chunk_sizes: Sequence[int],
    h2d_time: Callable[[int], float],
    compute_time: Callable[[int], float],
    d2h_time: Callable[[int], float],
    deserialize_time: Callable[[int], float],
    two_buffer_dep: bool = True,
    invert_launch_order: bool = True,
) -> list[Task]:
    """Reconstruction DAG of paper Fig. 9 (bottom).

    ``invert_launch_order=True`` applies the red-arrow optimization: the next
    chunk's deserialization is issued before the current chunk's output copy
    on the shared DMA engine, so reconstruction compute i+1 starts earlier
    and O_i overlaps with it.
    """
    per_chunk: list[dict[str, Task]] = []
    for i, c in enumerate(chunk_sizes):
        deps_i = (f"O{i-2}",) if (two_buffer_dep and i >= 2) else ()
        per_chunk.append(
            {
                "I": Task(f"I{i}", H2D, h2d_time(c), deps_i),
                "D": Task(f"D{i}", D2H, deserialize_time(c), (f"I{i}",)),
                "R": Task(f"R{i}", COMPUTE, compute_time(c), (f"D{i}",)),
                "O": Task(f"O{i}", D2H, d2h_time(c), (f"R{i}",)),
            }
        )
    tasks: list[Task] = []
    n = len(per_chunk)
    if invert_launch_order:
        # Issue: I0 D0 R0, then for i>0: I_i D_i (before O_{i-1}) R_i O_{i-1}; tail O_{n-1}.
        for i in range(n):
            tasks.append(per_chunk[i]["I"])
            tasks.append(per_chunk[i]["D"])
            tasks.append(per_chunk[i]["R"])
            if i > 0:
                tasks.append(per_chunk[i - 1]["O"])
        tasks.append(per_chunk[n - 1]["O"])
    else:
        for i in range(n):
            tasks.extend(per_chunk[i][k] for k in ("I", "D", "R", "O"))
    return tasks


@dataclass
class PipelineReport:
    makespan: float
    overlap_ratio: float
    sustained_bps: float
    chunk_sizes: list[int]
    schedule: dict[str, ScheduledTask]


def simulate_pipeline(
    total_bytes: int,
    mode: str,
    phi: chunk_model.PhiModel,
    h2d_bps: float,
    d2h_bps: float,
    output_fraction: float = 0.3,
    serialize_fraction: float = 0.02,
    c_init: int = 16 << 20,
    c_fixed: int = 100 << 20,
    c_limit: int = 2 << 30,
    reconstruction: bool = False,
    invert_launch_order: bool = True,
) -> PipelineReport:
    """End-to-end pipeline model: 'none' | 'fixed' | 'adaptive' (Fig. 13)."""
    theta = chunk_model.ThetaModel(beta=1.0 / h2d_bps)
    if mode == "none":
        sizes = [total_bytes]
        two_buf = False
    elif mode == "fixed":
        sizes = chunk_model.fixed_chunk_schedule(total_bytes, c_fixed)
        two_buf = True
    elif mode == "adaptive":
        sizes = chunk_model.adaptive_chunk_schedule(
            total_bytes, c_init, c_limit, phi, theta
        )
        two_buf = True
    else:
        raise ValueError(f"unknown mode {mode!r}")

    h2d = lambda c: c / h2d_bps
    d2h = lambda c: (c * output_fraction) / d2h_bps
    comp = lambda c: phi.time_for(c)
    ser = lambda c: (c * output_fraction * serialize_fraction) / d2h_bps
    if reconstruction:
        dag = build_reconstruction_dag(
            sizes, lambda c: c * output_fraction / h2d_bps, comp,
            lambda c: c / d2h_bps, ser, two_buf, invert_launch_order
        )
    else:
        dag = build_reduction_dag(sizes, h2d, comp, d2h, ser, two_buf)
    sched = TimelineSimulator().run(dag)
    makespan = TimelineSimulator.makespan(sched)
    return PipelineReport(
        makespan=makespan,
        overlap_ratio=TimelineSimulator.overlap_ratio(sched),
        sustained_bps=total_bytes / makespan if makespan else float("inf"),
        chunk_sizes=list(sizes),
        schedule=sched,
    )


# ---------------------------------------------------------------------------
# Staging: page-locked slot buffers and a copy stream
# ---------------------------------------------------------------------------


def host_tensor(data: Any) -> torch.Tensor:
    """``data`` (an array or tensor) as a tensor, sharing memory where it can
    (a numpy bfloat16 array becomes a torch bfloat16 tensor)."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    arr = arr if arr.flags.writeable else arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


SECTION_ALIGN = 256  # bytes: every staged section starts where any dtype's view may
COPY_THREADS = 4     # threads of a large copy into a page-locked buffer
COPY_SPLIT = 4 << 20  # bytes: a copy at least this long is split over them
_copy_pool: ThreadPoolExecutor | None = None
_copy_pool_lock = threading.Lock()


def copy_to_pinned(dst: int, src: int, nbytes: int) -> None:
    """``nbytes`` from host address ``src`` to host address ``dst`` (a slot's
    page-locked buffer), split over :data:`COPY_THREADS` threads of
    ``ctypes.memmove``, which runs without the GIL.  Torch's own host copy
    runs on the intra-op pool, whose threads the stream's lanes compete
    with; a few dedicated threads copy as fast and more steadily."""
    global _copy_pool
    if nbytes < COPY_SPLIT:
        ctypes.memmove(dst, src, nbytes)
        return
    with _copy_pool_lock:
        if _copy_pool is None:
            _copy_pool = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="hpdr-copy")
    step = -(-nbytes // COPY_THREADS // 4096) * 4096
    parts = [_copy_pool.submit(ctypes.memmove, dst + i, src + i, min(step, nbytes - i))
             for i in range(0, nbytes, step)]
    for p in parts:
        p.result()


class PinnedStager:
    """Stage host chunks onto one device, one page-locked buffer per slot.

    On a CUDA device, :meth:`stage` copies the chunk into the pinned buffer
    of ``slot`` (grown to the largest chunk the slot has seen), issues
    ``copy_(non_blocking=True)`` to the card on the stager's own copy
    stream and records an event there; the caller makes every stream that
    reads the chunk wait on that event.  A slot's buffer is rewritten only
    after the event of the slot's previous copy has completed.  A tensor
    already on the card is taken as it lies (made contiguous on the current
    stream, with an event there too).  On the CPU a chunk is its contiguous
    slice and there is no event.
    """

    def __init__(self, device: torch.device, window: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._bufs: list[torch.Tensor | None] = [None] * max(1, int(window))
        self._events: list[Any] = [None] * len(self._bufs)
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def _slot_buffer(self, slot: int, nbytes: int) -> torch.Tensor:
        """The page-locked buffer of ``slot``, at least ``nbytes`` long, once
        the slot's previous copy has completed."""
        if self._events[slot] is not None:
            self._events[slot].synchronize()  # the slot's previous copy is done
        buf = self._bufs[slot]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            self._bufs[slot] = buf
        return buf

    def stage(self, chunk: torch.Tensor, slot: int) -> tuple[torch.Tensor, Any]:
        """``(chunk on the device, event its copy completes at or None)``."""
        if not self.cuda:
            return chunk.contiguous(), None
        if chunk.is_cuda:
            out = chunk.contiguous()
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(out.device))
            return out, ready
        slot %= len(self._bufs)
        nbytes = chunk.numel() * chunk.element_size()
        buf = self._slot_buffer(slot, nbytes)
        pinned = buf[:nbytes].view(chunk.dtype).view(chunk.shape)
        if chunk.is_contiguous():
            copy_to_pinned(pinned.data_ptr(), chunk.data_ptr(), nbytes)
        else:
            pinned.copy_(chunk)
        with torch.cuda.stream(self.stream):
            out = torch.empty(chunk.shape, dtype=chunk.dtype, device=self.device)
            out.copy_(pinned, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self.stream)
        self._events[slot] = ready
        return out, ready

    def stage_sections(self, sections: dict[str, Any], slot: int) -> tuple[dict, Any]:
        """``(sections on the device, event their copy completes at or None)``.

        On a CUDA device the numpy arrays are packed into the slot's
        page-locked buffer, each at an offset aligned to
        :data:`SECTION_ALIGN` bytes, and go to the card in one copy on the
        copy stream; each comes back as a view of its dtype and shape into
        one device buffer.  On the CPU they are returned as they are.
        """
        if not self.cuda or not sections:
            return dict(sections), None
        slot %= len(self._bufs)
        layout, total = [], 0
        for key, v in sections.items():
            a = np.ascontiguousarray(v)
            total = -(-total // SECTION_ALIGN) * SECTION_ALIGN
            layout.append((key, total, a.reshape(-1).view(np.uint8), a.dtype.name, a.shape))
            total += a.nbytes
        buf = self._slot_buffer(slot, total)
        for _key, off, raw, _dtype, _shape in layout:
            copy_to_pinned(buf.data_ptr() + off, raw.ctypes.data, raw.size)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(buf[:total], non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self.stream)
        self._events[slot] = ready
        return {key: dev[off:off + raw.size].view(getattr(torch, dtype)).view(shape)
                for key, off, raw, dtype, shape in layout}, ready



def wait_staged(chunk: torch.Tensor, ready: Any) -> None:
    """Order the current stream of ``chunk``'s device after its staging copy
    (and keep the chunk's memory from reuse until that stream is done)."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(chunk.device)
    stream.wait_event(ready)
    chunk.record_stream(stream)


# ---------------------------------------------------------------------------
# Real chunked execution (lane-overlapped, double-buffered scheduler)
# ---------------------------------------------------------------------------


@dataclass
class ChunkTiming:
    """Per-chunk lane timings.

    ``spans`` holds the ``(start, end)`` interval of each lane's work for
    this chunk, in seconds relative to the run start.  ``h2d`` is the main
    thread's staging: the copy into the slot's page-locked buffer and the
    launch of the DMA, which the compute lane's stream waits on, not the
    host; ``compute`` ends when the chunk's kernels have completed, and ``serialize`` covers the io lane's one span: the fetch into
    page-locked memory and the container build, which are not timed apart.
    ``d2h`` is the reference's name for that same span, not a second one.
    A reconstruction run (:func:`reconstruct_chunked`) has no io lane: its
    ``serialize`` is 0.
    """

    h2d: float
    compute: float
    nbytes: int
    serialize: float = 0.0
    spans: dict = field(default_factory=dict)

    @property
    def d2h(self) -> float:
        return self.serialize


def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


@dataclass
class ChunkedResult:
    chunks: list                 # list[Compressed]
    boundaries: list[int]        # chunk starts along the split axis
    axis: int
    shape: tuple[int, ...]
    timings: list[ChunkTiming] = field(default_factory=list)
    wall_time: float = 0.0
    max_in_flight: int = 0       # peak staged-but-unserialized chunks
    window: int = 0              # resolved in-flight window of this run
    tuned: dict | None = None    # TunedPlan.to_dict() when auto-resolved

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.chunks)

    def ratio(self) -> float:
        import math

        orig = math.prod(self.shape) * _itemsize(self.chunks[0].meta["dtype"])
        return orig / max(self.nbytes(), 1)

    def lane_seconds(self) -> dict[str, float]:
        """Summed per-lane busy time across chunks (the serial-sum bound)."""
        return lane_seconds(self.timings)

    def overlap_efficiency(self) -> float:
        """Serial sum of lane times / pipelined wall clock (>1 = overlap)."""
        return overlap_efficiency(self.timings, self.wall_time)


def lane_seconds(timings: Sequence[ChunkTiming]) -> dict[str, float]:
    """Each lane's busy seconds summed over a run's chunks."""
    return {"h2d": sum(t.h2d for t in timings), "compute": sum(t.compute for t in timings),
            "serialize": sum(t.serialize for t in timings)}


def overlap_efficiency(timings: Sequence[ChunkTiming], wall: float | None = None) -> float:
    """The lanes' summed busy seconds over the run's ``wall`` seconds (by
    default to the last lane span's end): 1 is a serial run."""
    if wall is None:
        wall = max((end for t in timings for _start, end in t.spans.values()), default=0.0)
    return sum(lane_seconds(timings).values()) / wall if wall else 1.0


class ChunkedPipeline:
    """Lane-overlapped chunked compression over the largest dimension.

    Every chunk flows through three lanes —

      main thread   slice + staging through the slot's page-locked buffer
                    and an asynchronous copy on the copy stream (the H2D
                    DMA, which the host does not wait for)
      compute lane  ``compute_fn`` (R_i), on a CUDA stream of the task's
                    own that first waits on the staging copy's event
      io lane       ``finish_fn``: D2H fetch + container serialization
                    (O_i, S_i)

    — with per-chunk :class:`~repro_torch.runtime.executor.Submission`
    futures chaining compute → serialize, so chunk *i*'s compute runs while
    chunk *i−1* serializes and chunk *i+1* stages.  The in-flight window is
    bounded at ``window`` chunks (default 2, the paper's two-buffer
    anti-dependency): staging chunk *i* waits for chunk *i−window*'s
    serialization, which also bounds host and device memory and frees the
    slot's buffer.

    Two-phase codecs pass ``compute_fn(dev_chunk, slot)``, which must
    return only once its device work is done (honest lane timings depend on
    it), and ``finish_fn(payload, slot)``, which runs on the io lane.  The
    single-phase ``compress_fn(dev_chunk) -> container`` is wrapped into the
    two: the compute lane calls it and waits for its stream, the io lane
    moves every tensor of the container's ``arrays`` to the host.  ``slot``
    is the chunk's window slot (``idx % window``).  ``window=1`` is the
    fully serial schedule.

    ``devices`` is the placement ring (chunk *i* on ``devices[i % n]``);
    by default the current CUDA device, so a pipeline without a card raises
    unless it is given ``[torch.device("cpu")]``.

    ``chunk_size="auto"`` / ``window="auto"`` defer the decision to the
    auto-tuner (``core/tuner.py``) through the injected ``tuner`` callable
    — ``tuner(total_elems, itemsize, dtype_str, chunk_elems_or_None) ->
    TunedPlan`` — or the calibration-free heuristic when none is given or
    it fails.  Auto resolution only picks *values*: the schedule and bytes
    equal those of the resolved numbers passed explicitly.  Without a
    calibrated plan an auto window degrades to 1 when the run has ≤ 2 chunks.
    """

    def __init__(
        self,
        compress_fn: Callable | None = None,   # (tensor chunk) -> Compressed
        mode: str = "adaptive",
        c_init_elems: int = 1 << 20,
        c_fixed_elems: int = 8 << 20,
        c_limit_elems: int = 1 << 28,
        phi: chunk_model.PhiModel | None = None,
        theta: chunk_model.ThetaModel | None = None,
        devices: Sequence | None = None,
        *,
        compute_fn: Callable | None = None,
        finish_fn: Callable | None = None,
        executor=None,
        window: int | str = 2,
        chunk_size: int | str | None = None,
        tuner: Callable | None = None,
    ):
        if compress_fn is None and compute_fn is None:
            raise ValueError("need compress_fn or compute_fn/finish_fn")
        self.compress_fn = compress_fn
        self.compute_fn = compute_fn
        self.finish_fn = finish_fn
        self.mode = mode
        self.c_init = c_init_elems
        self.c_fixed = c_fixed_elems
        self.c_limit = c_limit_elems
        self.phi = phi
        self.theta = theta
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.executor = executor
        self.auto_chunk = chunk_size == "auto"
        if chunk_size is not None and not self.auto_chunk:
            self.mode = "fixed"
            self.c_fixed = int(chunk_size)
        self.auto_window = window == "auto"
        self.window = 2 if self.auto_window else max(1, int(window))
        self.tuner = tuner
        self.tuned = None  # TunedPlan of the most recent auto resolution

    # -- auto (tuner) resolution --------------------------------------------

    def _resolve_auto(self, data: torch.Tensor) -> None:
        """Resolve ``auto`` chunk/window for this payload via the tuner."""
        from . import tuner as tuner_mod
        from ..runtime.calibrate import dtype_name

        fixed_elems = (
            None if self.auto_chunk
            else (int(self.c_fixed) if self.mode == "fixed" else None)
        )
        dtype = dtype_name(data.dtype)
        plan = None
        if self.tuner is not None:
            try:
                plan = self.tuner(int(data.numel()), int(data.element_size()), dtype,
                                  fixed_elems)
            except Exception as e:  # the reference's fallback: the heuristic decides
                warnings.warn(f"stream tuner failed ({e!r}); using the heuristic plan",
                              RuntimeWarning, stacklevel=3)
                plan = None
        if plan is None:
            plan = tuner_mod.heuristic_plan(
                int(data.numel()), int(data.element_size()),
                chunk_elems=fixed_elems, c_limit_elems=self.c_limit,
                default_window=self.window, dtype=dtype,
            )
        if self.auto_chunk:
            self.mode = "fixed"
            self.c_fixed = int(plan.chunk_elems)
        if self.auto_window:
            self.window = max(1, int(plan.window))
        self.tuned = plan

    def _schedule(self, total: int) -> list[int]:
        if self.mode == "none":
            return [total]
        if self.mode == "fixed" or self.phi is None or self.theta is None:
            return chunk_model.fixed_chunk_schedule(total, self.c_fixed)
        return chunk_model.adaptive_chunk_schedule(
            total, self.c_init, self.c_limit, self.phi, self.theta
        )

    # -- chunk schedule ------------------------------------------------------

    def _row_schedule(self, data: torch.Tensor, axis: int) -> list[int]:
        n = data.shape[axis]
        row_elems = data.numel() // n
        rows: list[int] = []
        acc = 0
        for s in self._schedule(data.numel()):
            r = max(1, int(round(s / row_elems)))
            r = min(r, n - acc)
            if r <= 0:
                break
            rows.append(r)
            acc += r
        if acc < n:
            rows.append(n - acc)
        return rows

    # -- phase wrappers ------------------------------------------------------

    def _single_phase_compute(self, chunk: torch.Tensor, slot: int):
        del slot
        comp = self.compress_fn(chunk)
        if chunk.is_cuda:  # the lane's span ends with the chunk's device work
            torch.cuda.current_stream(chunk.device).synchronize()
        return comp

    @staticmethod
    def _single_phase_finish(comp, slot: int):
        del slot
        # D2H: the container's tensors on the host
        arrays = getattr(comp, "arrays", {})
        for k, v in list(arrays.items()):
            if isinstance(v, torch.Tensor):
                arrays[k] = v.cpu()
        return comp

    # -- the scheduler -------------------------------------------------------

    def run(self, data: Any) -> ChunkedResult:
        from ..runtime import executor as ex_mod  # runtime import: peer layer

        data = host_tensor(data)
        axis = int(np.argmax(data.shape))  # paper: LargestDim(u)
        if self.auto_chunk or self.auto_window:
            self._resolve_auto(data)
        rows = self._row_schedule(data, axis)
        if self.auto_window and len(rows) <= 2 and (
                self.tuned is None or self.tuned.source != "calibrated"):
            # heuristic small-payload guard: without a calibration, assume
            # ≤2 chunks cannot amortize pipelining
            self.window = 1
        ring = self.devices or [adapters.device_for(adapters.AUTO)]
        stagers = {d: PinnedStager(d, self.window) for d in dict.fromkeys(ring)}
        compute_fn = self.compute_fn or self._single_phase_compute
        finish_fn = self.finish_fn or self._single_phase_finish

        ex = self.executor
        transient = ex is None
        if transient:
            # one compute worker per ring device — the HDEM restriction
            # (§V-B: one reduction kernel at a time per device); chunk
            # computes overlap the io lane and the main-thread staging,
            # never each other on one device
            ex = ex_mod.DeviceExecutor(ring, max_workers=len(ring), io_workers=1)

        t_wall = time.perf_counter()
        now = lambda: time.perf_counter() - t_wall  # noqa: E731
        lock = threading.Lock()
        state = {"inflight": 0, "max": 0}
        records: list[dict] = [{"nbytes": 0, "spans": {}} for _ in rows]

        def compute_task(idx: int, dev_chunk, ready):
            wait_staged(dev_chunk, ready)
            rec = records[idx]
            t0 = now()
            payload = compute_fn(dev_chunk, idx % self.window)
            rec["spans"]["compute"] = (t0, now())
            return payload

        def serialize_task(idx: int, comp_sub):
            # Cross-lane wait: the io thread blocks on this chunk's compute
            # future (a different pool, so no deadlock).  Serialize tasks
            # are submitted in staging order, which pins the S-engine issue
            # order of Fig. 9.
            payload = comp_sub.result()
            rec = records[idx]
            t0 = now()
            comp = finish_fn(payload, idx % self.window)
            rec["spans"]["serialize"] = (t0, now())
            with lock:
                state["inflight"] -= 1
            return comp

        boundaries: list[int] = []
        subs: list = []
        start = 0
        try:
            for idx, r in enumerate(rows):
                if idx >= self.window:
                    # bounded in-flight window: stage chunk i only once
                    # chunk i−window has fully left the pipeline (which
                    # also frees its slot's staging buffer)
                    with span("pipeline.wait"):
                        subs[idx - self.window].result()
                host_chunk = data.narrow(axis, start, r)
                with lock:
                    state["inflight"] += 1
                    state["max"] = max(state["max"], state["inflight"])
                rec = records[idx]
                rec["nbytes"] = host_chunk.numel() * host_chunk.element_size()
                dev = ring[idx % len(ring)]
                t0 = now()
                with span("pipeline.stage"):  # the DMA runs on: the lane's stream waits on it
                    dev_chunk, ready = stagers[dev].stage(host_chunk, idx % self.window)
                rec["spans"]["h2d"] = (t0, now())
                comp_sub = ex.submit(compute_task, idx, dev_chunk, ready, device=dev)
                del dev_chunk
                subs.append(ex.submit(serialize_task, idx, comp_sub, lane=ex_mod.IO))
                boundaries.append(start)
                start += r
            chunks = [s.result() for s in subs]
        finally:
            if transient:
                ex.shutdown()

        timings = []
        for rec in records:
            sp = rec["spans"]
            dur = lambda k: sp[k][1] - sp[k][0] if k in sp else 0.0  # noqa: E731
            timings.append(ChunkTiming(
                h2d=dur("h2d"), compute=dur("compute"), serialize=dur("serialize"),
                nbytes=rec["nbytes"], spans=sp,
            ))
        wall = now()
        if self.tuned is not None:
            # feed the measured wall back into the tuner's residual so the
            # next prediction for this stream spec starts from reality
            from . import tuner as tuner_mod

            tuner_mod.observe(self.tuned, int(data.numel()), int(data.element_size()), wall)
        return ChunkedResult(
            chunks=chunks,
            boundaries=boundaries,
            axis=axis,
            shape=tuple(int(n) for n in data.shape),
            timings=timings,
            wall_time=wall,
            max_in_flight=state["max"],
            window=self.window,
            tuned=self.tuned.to_dict() if self.tuned is not None else None,
        )


def decompress_chunked(result: ChunkedResult, decompress_fn: Callable) -> torch.Tensor:
    """Every chunk through ``decompress_fn`` in order, on the calling thread,
    concatenated: the serial reconstruction (:func:`reconstruct_chunked`
    gives the same values, pipelined)."""
    parts = [decompress_fn(c) for c in result.chunks]
    return torch.cat(parts, dim=result.axis)


def reconstruct_chunked(
    result: ChunkedResult,
    stage_fn: Callable,
    decode_fn: Callable,
    out: torch.Tensor,
    *,
    window: int = 2,
    timings: list | None = None,
) -> torch.Tensor:
    """The reconstruction DAG of paper Fig. 9 (bottom) run for real: every
    chunk of ``result`` decoded into its own slice of ``out`` along
    ``result.axis``, with no concatenation; returns ``out``.

      main thread   ``stage_fn(container) -> (payload, sections)``: the
                    chunk's deserialisation and host preparation; then its
                    ``sections`` (host arrays) staged through the slot's
                    page-locked buffer in one copy on the copy stream (D_i)
      compute lane  ``decode_fn(payload, staged sections) -> tensor`` (R_i)
                    and its write into ``out`` (O_i), one chunk at a time

    Chunk *i+1* stages while chunk *i* decodes, in
    :func:`build_reconstruction_dag`'s issue order.  Staging chunk *i*
    waits until chunk *i−window* has completed (``window=1`` is the serial
    schedule).  ``stage_fn`` runs with the copy stream current, so a host
    preparation's own copies (decode tables) go there, not behind the decodes.

    On the card the lane works on a stream of its own, ordered after the
    caller's current stream, and keeps one chunk queued ahead: it enqueues
    chunk *i* and then waits for chunk *i−1*, so the card is not left idle
    between chunks and chunk decodes never overlap each other (the HDEM
    rule of one reduction at a time per device).  The run returns once
    the caller's current stream is ordered after every chunk's work; the
    last chunk may still be running.  On the CPU everything is synchronous.

    ``timings``, a list, receives each chunk's :class:`ChunkTiming`:
    ``h2d`` the main thread's staging (host clock, to the copy's launch)
    and ``compute`` the decode and write, on the card from CUDA
    events on the lane's stream measured from one recorded there at the
    run's start (reading them waits for the last chunk's work).
    """
    from ..runtime import executor as ex_mod  # runtime import: peer layer

    device = out.device
    cuda = device.type == "cuda"
    window = max(1, int(window))
    n = len(result.chunks)
    ends = list(result.boundaries[1:]) + [result.shape[result.axis]]
    stager = PinnedStager(device, window)
    t_wall = time.perf_counter()
    now = lambda: time.perf_counter() - t_wall  # noqa: E731
    records: list[dict] = [{"nbytes": 0, "spans": {}} for _ in range(n)]
    done: list[Any] = [None] * n
    if cuda:
        caller = torch.cuda.current_stream(device)
        lane = torch.cuda.Stream(device)
        lane.wait_stream(caller)  # the caller's earlier work on ``out`` comes first
        base = torch.cuda.Event(enable_timing=True)
        base.record(lane)

    def write(idx: int, payload, staged: dict, ready) -> None:
        if ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for t in staged.values():
                t.record_stream(stream)
        part = decode_fn(payload, staged)
        start = result.boundaries[idx]
        target = out.narrow(result.axis, start, ends[idx] - start)
        if part.shape != target.shape or part.dtype != target.dtype:
            raise ValueError(f"chunk {idx} decodes to {tuple(part.shape)} {part.dtype}, its "
                             f"slice of the output is {tuple(target.shape)} {target.dtype}")
        target.copy_(part)

    def compute_task(idx: int, payload, staged: dict, ready) -> None:
        t0 = now()
        if not cuda:
            write(idx, payload, staged, ready)
        else:
            with torch.cuda.device(device), torch.cuda.stream(lane):
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(lane)
                write(idx, payload, staged, ready)
                end = torch.cuda.Event(enable_timing=True)
                end.record(lane)
            records[idx]["events"] = (begin, end)
            done[idx] = end
            if idx > 0 and done[idx - 1] is not None:
                done[idx - 1].synchronize()  # chunk idx is queued behind it
        records[idx]["spans"]["compute"] = (t0, now())

    # one compute worker: chunk decodes never run side by side on the device
    ex = ex_mod.DeviceExecutor([torch.device("cpu")], max_workers=1, io_workers=1)
    subs: list = []
    try:
        for idx, c in enumerate(result.chunks):
            if idx >= window:
                with span("pipeline.wait"):  # chunk idx−window has left the card
                    subs[idx - window].result()
                    if done[idx - window] is not None:
                        done[idx - window].synchronize()
            t0 = now()
            with span("pipeline.restore_stage"):
                with torch.cuda.stream(stager.stream):  # None on the CPU: no-op
                    payload, sections = stage_fn(c)
                staged, ready = stager.stage_sections(sections, idx % window)
            records[idx]["spans"]["h2d"] = (t0, now())
            records[idx]["nbytes"] = sum(int(v.nbytes) for v in sections.values())
            subs.append(ex.submit(compute_task, idx, payload, staged, ready))
            del staged, payload
        for s in subs:
            s.result()
    finally:
        ex.shutdown()
    if cuda:
        caller.wait_stream(lane)  # the caller's next work on ``out`` waits for every chunk
    if timings is not None:
        for rec in records:
            sp = dict(rec["spans"])
            if cuda:
                begin, end = rec["events"]
                end.synchronize()
                sp["compute"] = (base.elapsed_time(begin) / 1e3, base.elapsed_time(end) / 1e3)
            timings.append(ChunkTiming(h2d=sp["h2d"][1] - sp["h2d"][0],
                                       compute=sp["compute"][1] - sp["compute"][0],
                                       nbytes=rec["nbytes"], spans=sp))
    return out
