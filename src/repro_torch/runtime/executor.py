"""Device-aware asynchronous executor — the host side of HDEM fan-out
(counterpart of ``repro.runtime.executor``).

The submission machinery the execution engine (:mod:`repro_torch.core.engine`)
schedules through:

  * :class:`DeviceExecutor` — a thread pool that round-robins work over an
    explicit list of ``torch.device``\\ s.  A compute-lane task for a CUDA
    device runs with that device current and on a CUDA stream of its own
    (``torch.cuda.stream``), first ordered after the device's default
    stream (where the caller made the task's inputs), and synchronises its
    stream before its :class:`Submission` resolves: a resolved result lies
    in memory that is safe to read from any stream.  Host-side stages
    (codebook builds, container packing) overlap on the pool's threads
    while another task's kernels run.  On the CPU (``backend="torch"``)
    the same code runs with no streams.
  * :class:`Submission` — the ``submit()/result()`` future handle; it also
    carries the device the work was placed on.

Two lanes, mirroring the HDEM machine model: ``compute`` (per-device
reduction work, pool sized to the device count) and ``io`` (long-running
orchestration such as an async checkpoint save, single-threaded so saves
serialize against each other and can wait on compute-lane work without
deadlocking the pool).  ``device=MESH`` marks a whole-bucket task (the
engine's batched buckets): it is counted in ``mesh_submitted`` and, on one
process's devices, placed on the next device of the ring.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Sequence

import torch

COMPUTE, IO = "compute", "io"

# Placement sentinel for whole-bucket work (the engine's batched buckets):
# counted apart from per-leaf tasks and placed round-robin like them.
MESH = object()


class Submission:
    """Handle for one submitted task (the engine's future type)."""

    def __init__(self, future: Future, device: Any = None, lane: str = COMPUTE):
        self._future = future
        self.device = device
        self.lane = lane

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None) -> Any:
        return self._future.result(timeout)

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)

    def add_done_callback(self, fn: Callable[["Submission"], None]) -> None:
        """Invoke ``fn(self)`` when the submission resolves (any outcome)."""
        self._future.add_done_callback(lambda _f: fn(self))


def _record_on(result: Any, stream: "torch.cuda.Stream") -> None:
    """Mark every CUDA tensor in ``result`` (nested lists, tuples, dicts)
    as used by ``stream``, so the caching allocator does not hand its
    memory to the task's stream again while the consumer's work on it is
    still queued."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            result.record_stream(stream)
    elif isinstance(result, (list, tuple)):
        for r in result:
            _record_on(r, stream)
    elif isinstance(result, dict):
        for r in result.values():
            _record_on(r, stream)


def run_on(device: Any, fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)`` on ``device``: for a CUDA device, with the
    device current and on a stream of its own, ordered after the device's
    default stream and synchronised before returning; elsewhere, as is."""
    if device is None or torch.device(device).type != "cuda":
        return fn(*args, **kwargs)
    device = torch.device(device)
    with torch.cuda.device(device):
        default = torch.cuda.default_stream(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(default)
        with torch.cuda.stream(stream):
            res = fn(*args, **kwargs)
        stream.synchronize()
        _record_on(res, default)
    return res


class DeviceExecutor:
    """Round-robin device-aware async executor.

    ``devices`` is the placement ring.  Tasks submitted without an explicit
    ``device`` are assigned the next ring slot and run there
    (:func:`run_on`), so the tensors they create, and the kernels those
    feed, land on that device.
    """

    def __init__(
        self,
        devices: Sequence[Any] | None = None,
        max_workers: int | None = None,
        io_workers: int = 1,
    ):
        self.devices = [torch.device(d) for d in devices] if devices else [torch.device("cpu")]
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or max(2, len(self.devices)),
            thread_name_prefix="hpdr-compute",
        )
        self._io_pool = ThreadPoolExecutor(max_workers=io_workers, thread_name_prefix="hpdr-io")
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self.submitted = 0
        self.completed = 0
        self.mesh_submitted = 0  # whole-bucket (device=MESH) tasks
        # per-lane service metrics: queue depth (submitted - started) and
        # cumulative time tasks spent waiting for a pool thread
        self._lane_submitted = {COMPUTE: 0, IO: 0}
        self._lane_started = {COMPUTE: 0, IO: 0}
        self._lane_completed = {COMPUTE: 0, IO: 0}
        self._lane_wait_s = {COMPUTE: 0.0, IO: 0.0}
        # per-priority counters (priority is an opaque caller label)
        self._prio: dict[str, dict[str, float]] = {}

    # ------------------------------------------------------------ submission

    def next_device(self) -> torch.device:
        return self.devices[next(self._rr) % len(self.devices)]

    def submit(
        self,
        fn: Callable,
        /,
        *args: Any,
        device: Any = None,
        lane: str = COMPUTE,
        priority: str | None = None,
        **kwargs: Any,
    ) -> Submission:
        """Schedule ``fn(*args, **kwargs)``; returns a :class:`Submission`.

        ``lane="io"`` routes to the single-threaded orchestration pool, which
        runs tasks as they are (no device, no stream); ``lane="compute"``
        (default) round-robins over the device ring.  ``device=MESH`` counts
        the task as a whole-bucket submission and places it on the next
        ring device.  ``priority`` is an optional caller label accumulated
        into :meth:`priority_stats`.
        """
        if lane == IO:
            pool, dev = self._io_pool, None
        elif device is MESH or device is None:
            pool, dev = self._pool, self.next_device()
        else:
            pool, dev = self._pool, torch.device(device)
        lane_key = IO if lane == IO else COMPUTE
        with self._lock:
            if self._closed:
                raise RuntimeError("DeviceExecutor is shut down: submit after close")
            self.submitted += 1
            self._lane_submitted[lane_key] += 1
            if priority is not None:
                self._prio_entry(priority)["submitted"] += 1
            if device is MESH:
                self.mesh_submitted += 1
        t_sub = time.perf_counter()
        out: Future = Future()
        try:
            pool.submit(self._run, out, dev, lane_key, priority, t_sub, fn, args, kwargs)
        except RuntimeError as e:
            # lost the race with a concurrent shutdown(): undo the counters
            # so drain() still converges, and surface a clear error
            with self._lock:
                self.submitted -= 1
                self._lane_submitted[lane_key] -= 1
                if priority is not None:
                    self._prio_entry(priority)["submitted"] -= 1
                if device is MESH:
                    self.mesh_submitted -= 1
            raise RuntimeError("DeviceExecutor is shut down: submit after close") from e
        return Submission(out, dev, lane)

    def _prio_entry(self, priority: str) -> dict[str, float]:
        # caller holds self._lock
        return self._prio.setdefault(
            priority, {"submitted": 0, "started": 0, "completed": 0, "wait_s": 0.0})

    def submit_after(
        self,
        sub: Submission,
        fn: Callable,
        /,
        *args: Any,
        device: Any = None,
        lane: str = COMPUTE,
        priority: str | None = None,
        **kwargs: Any,
    ) -> Submission:
        """Schedule ``fn(sub.result(), *args, **kwargs)`` once ``sub`` resolves.

        The continuation is *submitted* only when the upstream future
        completes, so it never occupies a pool thread while waiting.
        Upstream failures propagate to the returned :class:`Submission`
        without running ``fn``.
        """
        out: Future = Future()

        def _copy(src: Future) -> None:
            exc = src.exception()
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(src.result())

        def _chain(upstream: Future) -> None:
            exc = upstream.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            try:
                inner = self.submit(fn, upstream.result(), *args,
                                    device=device, lane=lane, priority=priority, **kwargs)
            except BaseException as e:  # e.g. the pool is shut down: done-callbacks
                # swallow exceptions, so surface it on the returned Submission
                out.set_exception(e)
                return
            inner._future.add_done_callback(_copy)

        sub._future.add_done_callback(_chain)
        return Submission(out, device, lane)

    def _run(
        self, out: Future, device: Any, lane: str, priority: str | None,
        t_sub: float, fn: Callable, args: tuple, kwargs: dict,
    ) -> None:
        t_start = time.perf_counter()
        with self._lock:
            self._lane_started[lane] += 1
            self._lane_wait_s[lane] += t_start - t_sub
            if priority is not None:
                e = self._prio_entry(priority)
                e["started"] += 1
                e["wait_s"] += t_start - t_sub
        try:
            try:
                res = run_on(device, fn, *args, **kwargs)
            except BaseException as exc:
                out.set_exception(exc)
            else:
                # resolve BEFORE counting the task complete: done-callbacks
                # (submit_after continuations) run inline here, so drain()
                # cannot return while a callback is still chaining work
                out.set_result(res)
        finally:
            with self._lock:
                self.completed += 1
                self._lane_completed[lane] += 1
                if priority is not None:
                    self._prio_entry(priority)["completed"] += 1
                self._idle.notify_all()

    def map(self, fn: Callable, items: Sequence[Any]) -> list[Any]:
        """Fan ``fn`` over ``items`` across the device ring; ordered results."""
        return [s.result() for s in [self.submit(fn, it) for it in items]]

    # ------------------------------------------------------------- lifecycle

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "devices": len(self.devices),
                "submitted": self.submitted,
                "completed": self.completed,
                "mesh_submitted": self.mesh_submitted,
            }

    def lane_stats(self) -> dict[str, dict[str, float]]:
        """Per-lane service counters: ``depth`` (submitted, not started),
        ``inflight`` (started, not completed) and cumulative ``wait_s`` for
        a pool thread."""
        with self._lock:
            return {
                lane: {
                    "submitted": self._lane_submitted[lane],
                    "started": self._lane_started[lane],
                    "completed": self._lane_completed[lane],
                    "depth": self._lane_submitted[lane] - self._lane_started[lane],
                    "inflight": self._lane_started[lane] - self._lane_completed[lane],
                    "wait_s": self._lane_wait_s[lane],
                }
                for lane in (COMPUTE, IO)
            }

    def priority_stats(self) -> dict[str, dict[str, float]]:
        """Per-priority counters for submissions tagged with ``priority=``,
        mirroring the lane counters."""
        with self._lock:
            return {
                p: {**e, "depth": e["submitted"] - e["started"],
                    "inflight": e["started"] - e["completed"]}
                for p, e in self._prio.items()
            }

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted task has completed; True on quiesce.

        A task counts as complete only after its :class:`Submission`
        resolved and every done-callback ran, so continuations chained with
        :meth:`submit_after` are submitted (and awaited) before the upstream
        task can satisfy drain.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self.completed < self.submitted:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._idle.wait(remaining)
        return True

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work and (optionally) wait for in-flight tasks.
        Idempotent; submissions racing a shutdown either run to completion
        or raise a clear ``RuntimeError`` — they never hang."""
        with self._lock:
            already = self._closed
            self._closed = True
        if already:
            if wait:
                self._pool.shutdown(wait=True)
                self._io_pool.shutdown(wait=True)
            return
        self._pool.shutdown(wait=wait)
        self._io_pool.shutdown(wait=wait)
