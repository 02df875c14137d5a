"""Measured per-machine cost calibration — HPDR §V-C made empirical
(counterpart of ``repro.runtime.calibrate``).

The adaptive-chunking model (``core/chunk_model.py``) and the timeline
simulator (``core/pipeline.py`` + ``runtime/roofline.simulate_stream``)
are only predictive once their inputs are *measured on the machine at
hand*.  This module closes that loop:

  calibrate  — micro-benchmark each pipeline stage over a small chunk-size
               sweep, best-of-N with warm plans:
                 * H2D staging       the stream's own staging: the chunk
                                     through a page-locked slot buffer and
                                     an asynchronous copy on the copy
                                     stream, until the copy has completed
                 * compute lane      two-phase ``encode_begin``, the
                                     task's CUDA stream synchronised
                 * io lane           ``encode_finish`` into page-locked
                                     memory + wire framing
               plus two machine-level scalars: the per-chunk scheduling
               overhead a ``window>1`` pipeline pays over serial, and the
               host framing throughput from ``runtime.io``'s
               ``serialization_probe``.
  fit        — compute throughput → ``PhiModel``; H2D and serialize →
               ``AffineCost`` (t₀ + C/bps).
  persist    — versioned JSON keyed by (device kind, device count, backend)
               under ``$HPDR_CALIBRATION_DIR`` (default ``~/.cache/hpdr``).
               Later runs — including *other processes* — load the file and
               perform **zero** measurement sweeps; ``SWEEPS_RUN`` counts
               sweeps performed by this process.

The JSON layout and :data:`CALIBRATION_VERSION` are the reference's.  The
machine key names the port's backend (``..._torch`` on the CPU,
``cuda_<device name>_x<count>_cuda`` on a card), so a port file never
collides with a reference file in the same directory.

Invalidation: a calibration file is ignored (and re-measured) when its
``version`` differs from :data:`CALIBRATION_VERSION`, or when its machine
key or backend no longer matches the running process.

Every sweep timing reads an injectable ``clock`` (default
``time.perf_counter``), so tests calibrate with a stub clock.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..core import chunk_model

CALIBRATION_VERSION = 3
ENV_DIR = "HPDR_CALIBRATION_DIR"

#: chunk-size sweep (elements) — small enough that a cold calibration is a
#: few plan builds + milliseconds of execution, wide enough (64x) to expose
#: the Φ knee between latency- and throughput-bound chunks
DEFAULT_SWEEP_ELEMS = (4 << 10, 16 << 10, 64 << 10, 256 << 10)

#: process-wide count of measurement sweeps actually executed (method
#: sweeps + machine-overhead probes); a warm process stays at 0
SWEEPS_RUN = 0

_LOCK = threading.RLock()
_STORES: dict[str, "MachineCalibration"] = {}
_DIR_OVERRIDE: str | None = None


# ---------------------------------------------------------------------------
# location + machine identity
# ---------------------------------------------------------------------------


def set_calibration_dir(path: str | Path | None) -> None:
    """Override the calibration directory (tests, docs examples).

    ``None`` restores the default resolution order.  Clears the in-process
    store cache and the tuner's solved plans, which derive from the old
    store.
    """
    global _DIR_OVERRIDE
    from ..core import tuner as _tuner

    with _LOCK:
        _DIR_OVERRIDE = str(path) if path is not None else None
        _STORES.clear()
    _tuner.clear_caches()


def calibration_dir() -> Path:
    if _DIR_OVERRIDE is not None:
        return Path(_DIR_OVERRIDE)
    env = os.environ.get(ENV_DIR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "hpdr"


def machine_key(backend: str | None = None) -> str:
    """Stable identity for *this* machine+backend: what the file is keyed by
    (``cuda_NVIDIA-H100-80GB-HBM3_x1_cuda``, ``cpu_cpu_x1_torch``)."""
    from ..core import adapters

    be = _resolve_backend(backend)
    if be == adapters.CUDA:
        platform = "cuda"
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
        count = torch.cuda.device_count()
    else:
        platform, kind, count = "cpu", "cpu", 1
    slug = "".join(ch if ch.isalnum() else "-" for ch in str(kind)).strip("-")
    return f"{platform}_{slug}_x{count}_{be}"


def calibration_path(backend: str | None = None) -> Path:
    return calibration_dir() / f"calibration_{machine_key(backend)}.json"


def _resolve_backend(backend: str | None) -> str:
    from ..core import adapters

    return adapters.resolve_backend(backend)


def dtype_name(dtype: Any) -> str:
    """numpy's name of ``dtype`` (a torch or numpy dtype or its name)."""
    if isinstance(dtype, torch.dtype):
        return "bfloat16" if dtype == torch.bfloat16 else str(dtype).removeprefix("torch.")
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def method_key(method: str, dtype: Any) -> str:
    return f"{method}:{dtype_name(dtype)}"


def race_key(method: str, dtype: Any, total_elems: int, itemsize: int) -> str:
    """Store key for one tuner candidate race (spec geometry included)."""
    return f"{method}:{dtype_name(dtype)}:{int(total_elems)}:{int(itemsize)}"


# ---------------------------------------------------------------------------
# calibration records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MethodCalibration:
    """Fitted per-stage cost model for one (codec, dtype) on this machine."""

    method: str
    dtype: str
    phi: chunk_model.PhiModel            # compute-lane throughput Φ(C)
    h2d: chunk_model.AffineCost          # staging cost t(C)
    serialize: chunk_model.AffineCost    # io-lane cost t(C): D2H + framing
    output_fraction: float               # compressed bytes / raw bytes
    profile_bytes: tuple = ()            # the sweep, for re-fit / reporting
    profile_bps: tuple = ()
    #: measured/simulated residual on a real mini-stream probe.  The lane
    #: simulator assumes independent resources; on machines where lanes
    #: contend (a CPU backend runs every "lane" on the same cores) the
    #: pipelined prediction is optimistic.  ``overlap_scale`` multiplies
    #: window>1 predictions, ``serial_scale`` window=1 predictions — the
    #: correction that makes the serial-degrade guard honest.
    serial_scale: float = 1.0
    overlap_scale: float = 1.0
    #: fixed per-stream cost (transient executor spin-down, scheduling,
    #: result assembly) — measured as (tiny 1-chunk stream wall − its
    #: simulated lane cost).  Added to every predicted makespan; decisive
    #: for small payloads where it rivals the lane work itself.
    stream_t0: float = 0.0
    #: fixed per-chunk cost inside a stream (dispatch, thread hop, slot
    #: bookkeeping) that the per-stage sweep cannot see — it times the
    #: stage bodies, not the scheduling around them.  Charged once per
    #: chunk; the term that makes over-splitting visibly expensive.
    chunk_t0: float = 0.0

    def to_json(self) -> dict:
        return {
            "method": self.method,
            "dtype": self.dtype,
            "phi": {
                "alpha": self.phi.alpha, "beta0": self.phi.beta0,
                "gamma": self.phi.gamma, "c_threshold": self.phi.c_threshold,
            },
            "h2d": {"t0": self.h2d.t0, "bps": self.h2d.bps},
            "serialize": {"t0": self.serialize.t0, "bps": self.serialize.bps},
            "output_fraction": self.output_fraction,
            "profile_bytes": list(self.profile_bytes),
            "profile_bps": list(self.profile_bps),
            "serial_scale": self.serial_scale,
            "overlap_scale": self.overlap_scale,
            "stream_t0": self.stream_t0,
            "chunk_t0": self.chunk_t0,
        }

    @staticmethod
    def from_json(d: dict) -> "MethodCalibration":
        return MethodCalibration(
            method=str(d["method"]),
            dtype=str(d["dtype"]),
            phi=chunk_model.PhiModel(**d["phi"]),
            h2d=chunk_model.AffineCost(**d["h2d"]),
            serialize=chunk_model.AffineCost(**d["serialize"]),
            output_fraction=float(d["output_fraction"]),
            profile_bytes=tuple(d.get("profile_bytes", ())),
            profile_bps=tuple(d.get("profile_bps", ())),
            serial_scale=float(d.get("serial_scale", 1.0)),
            overlap_scale=float(d.get("overlap_scale", 1.0)),
            stream_t0=float(d.get("stream_t0", 0.0)),
            chunk_t0=float(d.get("chunk_t0", 0.0)),
        )


@dataclass
class MachineCalibration:
    """Everything measured for one (machine, backend), persisted as JSON."""

    machine: str
    backend: str
    window_overhead_s: float | None = None   # per-chunk pipelined-over-serial
    host_frame_bps: float | None = None      # runtime.io serialization probe
    methods: dict[str, MethodCalibration] = field(default_factory=dict)
    #: persisted tuner race winners, keyed by :func:`race_key` — the
    #: ``(chunk_elems, window)`` the candidate race converged on plus its
    #: measured per-element cost.  Additive field (older files load with an
    #: empty dict); rides the same versioning/invalidation as the rest of
    #: the store, so a machine or backend change re-races from scratch.
    races: dict[str, dict] = field(default_factory=dict)
    path: Path | None = None
    loaded_from_disk: bool = False

    def to_json(self) -> dict:
        return {
            "version": CALIBRATION_VERSION,
            "machine": self.machine,
            "backend": self.backend,
            "window_overhead_s": self.window_overhead_s,
            "host_frame_bps": self.host_frame_bps,
            "methods": {k: m.to_json() for k, m in self.methods.items()},
            "races": dict(self.races),
        }

    def save(self) -> None:
        """Atomic write (tmp + rename) so readers never see a torn file."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=self.path.parent, prefix=self.path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def _load_file(path: Path, machine: str, backend: str) -> MachineCalibration | None:
    try:
        d = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    # invalidation rules: version, machine identity, backend must all match
    if d.get("version") != CALIBRATION_VERSION:
        return None
    if d.get("machine") != machine or d.get("backend") != backend:
        return None
    try:
        methods = {
            k: MethodCalibration.from_json(m)
            for k, m in d.get("methods", {}).items()
        }
    except (KeyError, TypeError, ValueError):
        return None
    races = {
        k: r for k, r in d.get("races", {}).items()
        if isinstance(r, dict) and "chunk_elems" in r and "window" in r
    }
    return MachineCalibration(
        machine=machine,
        backend=backend,
        window_overhead_s=d.get("window_overhead_s"),
        host_frame_bps=d.get("host_frame_bps"),
        methods=methods,
        races=races,
        path=path,
        loaded_from_disk=True,
    )


def load_store(backend: str | None = None) -> MachineCalibration:
    """The process-wide calibration store for (this machine, backend).

    Loads the persisted JSON on first access; a missing/invalid file yields
    an empty store that fills (and persists) as methods are measured.
    """
    be = _resolve_backend(backend)
    key = machine_key(be)
    with _LOCK:
        store = _STORES.get(key)
        if store is None:
            path = calibration_path(be)
            store = _load_file(path, key, be) or MachineCalibration(
                machine=key, backend=be, path=path
            )
            _STORES[key] = store
        return store


# ---------------------------------------------------------------------------
# the calibrator
# ---------------------------------------------------------------------------


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class Calibrator:
    """Micro-benchmark per-stage costs and fit the machine cost model.

    ``clock`` is injectable (stub clocks make the tests deterministic and
    sub-second); ``best_of`` guards against scheduler noise;
    ``sweep_elems`` sets the chunk-size sweep in elements.
    """

    def __init__(
        self,
        backend: str | None = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
        best_of: int = 3,
        sweep_elems: tuple = DEFAULT_SWEEP_ELEMS,
    ):
        self.backend = _resolve_backend(backend)
        self.clock = clock
        self.best_of = max(1, int(best_of))
        self.sweep_elems = tuple(int(e) for e in sweep_elems)

    # -- timing helpers ------------------------------------------------------

    def _best_of(self, fn: Callable[[], Any]) -> float:
        best = float("inf")
        for _ in range(self.best_of):
            t0 = self.clock()
            fn()
            t1 = self.clock()
            best = min(best, t1 - t0)
        return max(best, 1e-9)

    @staticmethod
    def _chunk_shape(elems: int) -> tuple[int, int, int]:
        # the stream slices rows off the largest axis; calibrate on the
        # same row-major geometry (1024 elements per row plane)
        return (max(1, int(elems) // 1024), 32, 32)

    @staticmethod
    def _sweep_data(shape: tuple, dtype: Any) -> torch.Tensor:
        """The reference's sweep field, as a host tensor of ``dtype``."""
        rng = np.random.default_rng(12345)
        g = np.linspace(0.0, 4.0 * np.pi, shape[0], dtype=np.float64)
        base = np.sin(g)[:, None, None] + 0.1 * rng.standard_normal(shape)
        name = dtype_name(dtype)
        if name == "bfloat16":  # numpy has no bfloat16 of its own
            return torch.from_numpy(base.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(base.astype(np.dtype(name))))

    # -- per-method sweep ----------------------------------------------------

    def measure_method(
        self, method: str, dtype: Any = "float32", params: dict | None = None
    ) -> MethodCalibration:
        """One chunk-size sweep → fitted :class:`MethodCalibration`."""
        global SWEEPS_RUN
        from ..core import api as core_api
        from ..core.pipeline import PinnedStager

        params = dict(params or {})
        sizes_b: list[int] = []
        t_h2d: list[float] = []
        t_comp: list[float] = []
        t_ser: list[float] = []
        out_frac: list[float] = []
        for elems in self.sweep_elems:
            arr = self._sweep_data(self._chunk_shape(elems), dtype)
            spec = core_api.make_spec(arr, method, backend=self.backend, **params)
            codec = core_api.get_codec(spec.method)
            plan = core_api.get_plan(spec)  # warm plan via the CMM
            stager = PinnedStager(plan.device, 1)

            def stage():  # the stream's staging, until the copy has completed
                dev, ready = stager.stage(arr, 0)
                if ready is not None:
                    ready.synchronize()
                return dev

            dev = stage()
            # warm up one encode and one finish before timing anything
            payload = self._encode_once(codec, plan, dev)
            frame = self._finish_once(codec, plan, payload)
            sizes_b.append(arr.numel() * arr.element_size())
            t_h2d.append(self._best_of(stage))
            t_comp.append(self._best_of(lambda: self._encode_once(codec, plan, dev)))
            t_ser.append(self._best_of(lambda: self._finish_once(codec, plan, payload)))
            out_frac.append(len(frame) / sizes_b[-1])
        SWEEPS_RUN += 1
        sizes_arr = np.asarray(sizes_b, np.float64)
        comp_bps = sizes_arr / np.asarray(t_comp, np.float64)
        phi = chunk_model.fit_phi(sizes_arr, comp_bps)
        h2d = chunk_model.fit_affine(sizes_arr, t_h2d)
        ser = chunk_model.fit_affine(sizes_arr, t_ser)
        stream_t0, chunk_t0, serial_scale, overlap_scale = (
            self._measure_stream_scales(method, dtype, params, phi, h2d, ser)
        )
        return MethodCalibration(
            method=method,
            dtype=dtype_name(dtype),
            phi=phi,
            h2d=h2d,
            serialize=ser,
            output_fraction=float(np.mean(out_frac)),
            profile_bytes=tuple(int(s) for s in sizes_b),
            profile_bps=tuple(float(b) for b in comp_bps),
            serial_scale=serial_scale,
            overlap_scale=overlap_scale,
            stream_t0=stream_t0,
            chunk_t0=chunk_t0,
        )

    def _measure_stream_scales(
        self, method, dtype, params, phi, h2d, ser,
        n_probe: int = 4,
    ) -> tuple[float, float, float, float]:
        """``(stream_t0, chunk_t0, serial_scale, overlap_scale)``.

        Probes through the *actual* ``CompressorStream``: a 1-chunk stream
        isolates the fixed per-stream cost, an ``n_probe``-chunk serial
        stream at the largest sweep size the fixed per-chunk cost, and the
        same stream at window 2 the measured/simulated overlap residual.
        Walls come from the stream's own ``perf_counter`` (not the
        injectable sweep clock); degenerate ratios clamp to [0.2, 50].
        Only arithmetic failures fall back to the neutral scales: a fault
        of the stream itself propagates.
        """
        from ..core import api as core_api
        from . import roofline

        itemsize = self._sweep_data((1, 1, 1), dtype).element_size()

        def wall(window: int, chunk_elems: int, n_chunks: int) -> float:
            rows, y, z = self._chunk_shape(chunk_elems)
            data = self._sweep_data((rows * n_chunks, y, z), dtype)
            stream = core_api.CompressorStream(
                method, mode="fixed", c_fixed_elems=chunk_elems,
                window=window, backend=self.backend, frame=True, **params)
            stream.compress(data)  # warm
            return min(stream.compress(data).wall_time for _ in range(self.best_of))

        def sim(window: int, chunk_elems: int, n_chunks: int) -> float:
            mk, _ = roofline.simulate_stream(
                [chunk_elems * itemsize] * n_chunks,
                h2d.time_for, phi.time_for, ser.time_for, window=window)
            return mk

        tiny = int(self.sweep_elems[0])
        big = int(self.sweep_elems[-1])
        walls = (wall(1, tiny, 1), wall(1, big, n_probe), wall(2, big, n_probe))
        try:
            stream_t0 = max(0.0, walls[0] - sim(1, tiny, 1))
            serial_wall = walls[1]
            chunk_t0 = max(
                0.0,
                (serial_wall - sim(1, big, n_probe) - stream_t0) / n_probe,
            )
            fixed = stream_t0 + n_probe * chunk_t0

            def scale(measured: float, window: int) -> float:
                predicted = sim(window, big, n_probe) + fixed
                if not (np.isfinite(measured) and np.isfinite(predicted)) \
                        or predicted <= 0:
                    return 1.0
                return float(np.clip(measured / predicted, 0.2, 50.0))

            return (stream_t0, chunk_t0, scale(serial_wall, 1), scale(walls[2], 2))
        except (ArithmeticError, ValueError):
            return 0.0, 0.0, 1.0, 1.0

    @staticmethod
    def _encode_once(codec, plan, dev):
        """Phase 1 exactly as the stream's compute lane runs it."""
        if plan.pipeline is None:  # codec without a stage graph: one phase
            return ("container", codec.encode(plan, dev))
        state, env = codec.encode_begin(plan, dev)
        _sync(dev)
        return ("state", state, env)

    @staticmethod
    def _finish_once(codec, plan, payload) -> bytes:
        """Phase 2 (io lane): exact-sized D2H into page-locked memory +
        container wire bytes."""
        if payload[0] == "container":
            c = payload[1]
        else:
            c = codec.encode_finish(plan, payload[1], payload[2], pinned=True)
        return c.to_bytes()

    # -- machine-level probes ------------------------------------------------

    def measure_window_overhead(
        self, chunks: int = 6, chunk_elems: int = 16 << 10
    ) -> float:
        """Per-chunk cost of the pipelined schedule over serial.

        Runs the *real* ``ChunkedPipeline`` (staging included) with trivial
        stage functions at ``window`` 1 and 2; the wall-clock difference per
        chunk is pure scheduling overhead.  Clamped at ≥ 0.
        """
        global SWEEPS_RUN
        from ..core import adapters
        from ..core import pipeline as pl

        rows_per_chunk = 8
        data = torch.zeros((chunks * rows_per_chunk, chunk_elems // rows_per_chunk))

        def compute_fn(chunk, slot):
            del slot
            return chunk

        def finish_fn(payload, slot):
            del payload, slot

        walls = {}
        for w in (1, 2):
            pipe = pl.ChunkedPipeline(
                mode="fixed", c_fixed_elems=chunk_elems,
                devices=[adapters.device_for(self.backend)],
                compute_fn=compute_fn, finish_fn=finish_fn, window=w,
            )
            pipe.run(data)  # warm the lanes
            walls[w] = self._best_of(lambda: pipe.run(data))
        SWEEPS_RUN += 1
        return max(0.0, (walls[2] - walls[1]) / chunks)

    def measure_host_frame_bps(self, nbytes: int = 1 << 20) -> float:
        from . import io as rio

        t = rio.serialization_probe(nbytes, clock=self.clock)
        return float(nbytes) / t


# ---------------------------------------------------------------------------
# the public entry: load-or-measure
# ---------------------------------------------------------------------------


def get_method_calibration(
    method: str,
    dtype: Any = "float32",
    backend: str | None = None,
    *,
    measure: bool = True,
    params: dict | None = None,
    clock: Callable[[], float] = time.perf_counter,
    best_of: int = 3,
    sweep_elems: tuple = DEFAULT_SWEEP_ELEMS,
) -> MethodCalibration | None:
    """Calibration for (method, dtype) on this machine: load, else measure.

    A persisted calibration loads with zero sweeps.  A missing method is
    measured once (``measure=True``), merged into the store, and persisted
    for every later process.  Returns ``None`` when unavailable and
    measurement is disabled or fails.
    """
    store = load_store(backend)
    key = method_key(method, dtype)
    with _LOCK:
        mc = store.methods.get(key)
    if mc is not None or not measure:
        return mc
    cal = Calibrator(
        backend, clock=clock, best_of=best_of, sweep_elems=sweep_elems
    )
    mc = cal.measure_method(method, dtype, params=params)
    with _LOCK:
        store.methods[key] = mc
        if store.window_overhead_s is None:
            store.window_overhead_s = cal.measure_window_overhead()
        if store.host_frame_bps is None:
            store.host_frame_bps = cal.measure_host_frame_bps()
        store.save()
    return mc


def window_overhead_s(backend: str | None = None) -> float:
    """The machine's calibrated per-chunk pipelining overhead (0.0 cold)."""
    store = load_store(backend)
    return float(store.window_overhead_s or 0.0)


# ---------------------------------------------------------------------------
# persisted tuner race winners
# ---------------------------------------------------------------------------


def get_race_winner(
    method: str,
    dtype: Any,
    total_elems: int,
    itemsize: int,
    backend: str | None = None,
) -> dict | None:
    """The persisted race winner for this spec geometry, or ``None``.

    A hit lets a fresh process start its candidate race pre-converged on
    the previously measured winner — zero exploration runs — while
    ``tuner.observe`` feedback can still dethrone it if the machine
    changed behaviour.
    """
    store = load_store(backend)
    with _LOCK:
        r = store.races.get(race_key(method, dtype, total_elems, itemsize))
        return dict(r) if r is not None else None


def record_race_winner(
    method: str,
    dtype: Any,
    total_elems: int,
    itemsize: int,
    backend: str | None,
    *,
    chunk_elems: int,
    window: int,
    measured_s: float,
) -> None:
    """Persist a converged race winner (idempotent; atomic store save)."""
    store = load_store(backend)
    key = race_key(method, dtype, total_elems, itemsize)
    entry = {
        "chunk_elems": int(chunk_elems),
        "window": int(window),
        "measured_s": float(measured_s),
    }
    with _LOCK:
        prev = store.races.get(key)
        if prev is not None and (
            (prev.get("chunk_elems"), prev.get("window"))
            == (entry["chunk_elems"], entry["window"])
            and abs(entry["measured_s"] - prev.get("measured_s", 0.0))
            <= 0.05 * max(entry["measured_s"], 1e-12)
        ):
            return  # same winner within noise: don't rewrite the file
        store.races[key] = entry
        store.save()
