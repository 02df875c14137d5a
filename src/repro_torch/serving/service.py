"""Multi-tenant reduction service — admission, coalescing, backpressure
(counterpart of ``repro.serving.service``).

The engine's headline throughput comes from *aggregated* dispatch: stacked
buckets (one batched pipeline run, one ZFP launch, for a bucket of
same-spec leaves), one plan per spec with every further leaf a CMM hit.
Direct library calls leave that aggregation to the caller; under heavy
concurrent traffic each client request would dispatch its own (often
singleton) buckets and the substrate degenerates to per-request launches.
:class:`ReductionService` is the request layer that restores aggregation
*across* clients:

  * **Admission queue** — a bounded queue in front of the dispatcher; the
    ``overload`` policy decides what happens when it fills: ``"block"``
    (backpressure on the producer, optionally bounded by a timeout),
    ``"reject"`` (fail fast with :class:`ServiceOverloaded`), or
    ``"shed"`` (drop the *oldest* queued request — freshest-first under
    overload, the classic load-shedding rule; bulk is shed before
    interactive).
  * **Priority classes** — admission splits into ``interactive``
    (quicklook, admitted KV fetch) and ``bulk`` (compress/decompress,
    streams, parks) lanes.  The dispatcher's weighted dequeue prefers
    interactive but forces one bulk request through after
    ``starvation_limit`` consecutive interactive pops while bulk waits,
    so neither class starves.  Per-priority wait histograms
    (p50/p99/mean/max) land in :class:`ServiceStats` — and cross-request
    ``decompress_stream`` requests for the SAME stream coalesce per
    dispatch cycle through the container chunk index (each distinct
    chunk decoded once).
  * **Request coalescing** — the dispatcher drains whatever arrives within
    a short ``batch_window`` and merges same-``(spec, shape, dtype)`` leaf
    jobs *from different requests* into ONE stacked bucket submission on
    the engine's existing batched path.  Responses stay bit-identical
    to the direct API because stacked and per-leaf execution agree
    byte-for-byte; when a bucket can't fill (singleton) or specs are
    heterogeneous, jobs degrade gracefully to per-leaf dispatch.
  * **Auto-tuned streams** — :meth:`ReductionService.compress_stream`
    routes one large array through the chunked ``CompressorStream`` with
    ``chunk_size="auto", window="auto"``: the dispatch path consults the
    calibrated chunk/window tuner (``core/tuner.py``) per payload, and the
    chunks ride the engine's compute/io lanes while staging runs on a
    dedicated stream pool.
  * **Per-tenant quotas** — parked KV sessions ride a tenant-scoped
    :class:`~repro_torch.serving.engine.KVPageStore`: each tenant's resident
    bytes are bounded independently (LRU spill within the tenant), so one
    heavy tenant cannot displace another's sessions.
  * **Service metrics** — :meth:`ReductionService.stats` snapshots a
    :class:`ServiceStats`: queue depth, admission wait times, batch fill
    ratio, coalesce hits, shed/reject counts, per-tenant bytes, per-
    priority wait histograms, per-connection byte counters (fed by the
    wire server), and the executor's per-lane and per-priority
    queue-depth/wait-time counters.

Requests take tensors on the card or the host (or numpy arrays); results
are tensors on the engine's device.  Only the wire server turns them into
host numpy, when it serialises a response.

Cross-process clients reach the same service through the wire protocol —
:class:`~repro_torch.serving.server.ReductionServer` /
:class:`~repro_torch.serving.client.ReductionClient` (``serving/protocol.py``
frames; socket results byte-identical to these in-process calls).

Typical use::

    svc = ReductionService(max_queue=64, overload="reject",
                           batch_window=0.002)
    flat, stats = svc.compress(tree, tenant="team-a")   # many client threads
    restored = svc.decompress(flat, tree, tenant="team-a")
    snap = svc.stats()
    svc.close()
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..core import api
from ..core import engine as engine_mod
from ..runtime.executor import Submission
from .engine import KVPageStore

_DEFAULT_TENANT = "default"

OVERLOAD_POLICIES = ("block", "reject", "shed")

# Priority classes: latency-sensitive reads vs bulk reduction.
# ``interactive`` work is answered from metadata-scale or single-pread
# paths (progressive quicklooks, parked-KV fetches); ``bulk`` is the
# engine-bound compress/decompress traffic.  The dispatcher dequeues
# interactive first, with a starvation bound guaranteeing bulk progress.
INTERACTIVE, BULK = "interactive", "bulk"
PRIORITIES = (INTERACTIVE, BULK)

_KIND_PRIORITY = {
    "quicklook": INTERACTIVE,
    "fetch_kv": INTERACTIVE,
    "compress": BULK,
    "decompress": BULK,
    "stream": BULK,
    "decompress_stream": BULK,
    "park_kv": BULK,
}

# bounded reservoir per priority for wait-time histograms: enough samples
# for a stable p99 without unbounded growth on long-lived services
_WAIT_SAMPLES = 4096


class ServiceOverloaded(RuntimeError):
    """Raised when the admission queue is full (``reject``), an admission
    wait times out (``block`` with timeout), or a queued request is dropped
    to make room for a newer one (``shed``)."""


@dataclass
class _Request:
    """One admitted client request, resolved through ``future``."""

    kind: str  # "compress" | "decompress" | "park_kv" | "stream" | "quicklook"
    tenant: str
    future: Future
    t_enqueue: float
    # payload (by kind)
    tree: Any = None
    select: Callable | None = None
    comp: dict | None = None
    like: Any = None
    session_id: str | None = None
    sep: str = "/"
    method: str | None = None      # stream: codec name
    stream_kwargs: dict = field(default_factory=dict)
    # dispatcher bookkeeping
    order: list = field(default_factory=list)
    raw: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    results: dict = field(default_factory=dict)
    remaining: int = 0
    failed: bool = False
    coalesced: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def priority(self) -> str:
        return _KIND_PRIORITY.get(self.kind, BULK)


@dataclass
class ServiceStats:
    """One consistent snapshot of the service's observable state."""

    queue_depth: int
    max_queue: int
    inflight_requests: int
    admitted: int
    completed: int
    failed: int
    rejected: int
    shed: int
    dispatch_cycles: int
    wait_s_mean: float
    wait_s_max: float
    stacked_buckets: int
    stacked_leaves: int
    coalesced_buckets: int
    coalesced_requests: int
    fallback_leaves: int
    batch_fill_ratio: float        # leaves per stacked bucket
    requests_per_bucket: float     # distinct requests per stacked bucket
    decode_stacked_buckets: int
    decode_stacked_leaves: int
    decode_fallback_leaves: int
    stream_requests: int
    stream_serial_degrades: int    # auto-tuned streams degraded to window=1
    quicklook_requests: int
    quicklook_bytes: int           # component bytes fetched by quicklooks
    stream_decode_requests: int
    chunk_decodes: int             # stream chunks actually decoded
    chunk_coalesce_hits: int       # chunk needs served from another request's decode
    per_tenant: dict[str, dict[str, Any]]
    # per-priority admission view: depth, admitted/dispatched counts, the
    # starvation-bound trips ("forced"), and the wait histogram
    # (mean/max/p50/p99 over a bounded reservoir)
    priorities: dict[str, dict[str, float]]
    executor_lanes: dict[str, dict[str, float]]
    executor_priorities: dict[str, dict[str, float]]
    # wire-server connection accounting (empty when no server is attached):
    # open/opened/closed counts, aggregate+per-connection byte counters
    connections: dict[str, Any]
    kv: dict[str, Any]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ReductionService:
    """Thread-safe multi-tenant front-end over one execution engine.

    Client threads call :meth:`compress` / :meth:`decompress` /
    :meth:`park_kv` (or their ``submit_*`` async forms); a single
    dispatcher thread admits, batches, and coalesces the work onto the
    engine, and per-leaf results fan back out to each request's future on
    the executor's completion threads — no client thread ever blocks
    another's progress except through the admission queue itself.

    Parameters
    ----------
    engine:
        The :class:`~repro_torch.core.engine.ExecutionEngine` to run on
        (default: the process-wide engine).  The service never closes it.
    max_queue:
        Admission queue bound (requests).
    overload:
        ``"block"`` | ``"reject"`` | ``"shed"`` — what a full queue does.
    batch_window:
        Seconds the dispatcher lingers collecting more requests to coalesce
        after the first arrives.  ``0`` still coalesces whatever is already
        queued (burst batching) without adding latency.
    max_batch_requests:
        Upper bound on requests merged into one dispatch cycle.
    starvation_limit:
        The weighted-dequeue starvation bound: at most this many
        consecutive ``interactive`` requests are dequeued while ``bulk``
        work waits, after which one bulk request is forced through.
        Interactive work (quicklook, fetch_kv) therefore waits behind at
        most ONE in-progress dispatch plus the batch window, and bulk can
        be delayed by at most ``starvation_limit`` interactive dequeues.
    kv_store:
        A pre-built tenant-scoped :class:`KVPageStore`; by default one is
        created with ``kv_capacity_bytes`` / ``tenant_quota_bytes``.
    """

    def __init__(
        self,
        engine: engine_mod.ExecutionEngine | None = None,
        *,
        max_queue: int = 64,
        overload: str = "block",
        batch_window: float = 0.002,
        max_batch_requests: int = 32,
        starvation_limit: int = 4,
        kv_store: KVPageStore | None = None,
        kv_capacity_bytes: int = 256 << 20,
        kv_rate: int = 12,
        tenant_quota_bytes: dict[str, int] | None = None,
        spill_dir: Any = None,
    ):
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload must be one of {OVERLOAD_POLICIES}, got {overload!r}"
            )
        if starvation_limit < 1:
            raise ValueError("starvation_limit must be >= 1")
        self.engine = engine if engine is not None else engine_mod.default_engine()
        self.max_queue = int(max_queue)
        self.overload = overload
        self.batch_window = float(batch_window)
        self.max_batch_requests = int(max_batch_requests)
        self.starvation_limit = int(starvation_limit)
        self.kv = kv_store if kv_store is not None else KVPageStore(
            capacity_bytes=kv_capacity_bytes,
            spill_dir=spill_dir,
            rate=kv_rate,
            engine=self.engine,
            tenant_quota_bytes=tenant_quota_bytes,
        )
        self._queues: dict[str, deque[_Request]] = {
            p: deque() for p in PRIORITIES
        }
        self._interactive_run = 0  # consecutive interactive dequeues
        self._cond = threading.Condition()
        self._closing = False
        self._inflight = 0
        # metrics (all under _mlock)
        self._mlock = threading.Lock()
        self._m = {
            "admitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "shed": 0, "dispatch_cycles": 0, "wait_s_total": 0.0,
            "wait_count": 0, "wait_s_max": 0.0, "stacked_buckets": 0,
            "stacked_leaves": 0, "coalesced_buckets": 0,
            "coalesced_requests": 0, "fallback_leaves": 0,
            "bucket_requests_sum": 0, "decode_stacked_buckets": 0,
            "decode_stacked_leaves": 0, "decode_fallback_leaves": 0,
            "stream_requests": 0, "stream_serial_degrades": 0,
            "quicklook_requests": 0, "quicklook_bytes": 0,
            "stream_decode_requests": 0, "chunk_decodes": 0,
            "chunk_coalesce_hits": 0,
        }
        self._prio_m = {
            p: {"admitted": 0, "dispatched": 0, "forced": 0,
                "wait_s_total": 0.0, "wait_s_max": 0.0}
            for p in PRIORITIES
        }
        self._wait_samples: dict[str, deque[float]] = {
            p: deque(maxlen=_WAIT_SAMPLES) for p in PRIORITIES
        }
        # wire-server connection counters (fed by ReductionServer)
        self._conns: dict[str, dict[str, int]] = {}
        self._conn_totals = {
            "opened": 0, "closed": 0, "rx_bytes": 0, "tx_bytes": 0,
            "frames_rx": 0, "frames_tx": 0, "protocol_errors": 0,
        }
        self._tenants: dict[str, dict[str, Any]] = {}
        # chunked single-array streams run on their own small pool: each
        # stream's staging loop lives on a pool thread while its chunk
        # compute/serialize tasks ride the engine's lanes — staging must
        # never occupy a lane its own chunks are queued behind
        self._stream_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="hpdr-service-stream"
        )
        self._thread = threading.Thread(
            target=self._loop, name="hpdr-service-dispatch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- admission

    def _depth(self) -> int:
        # caller holds _cond
        return sum(len(q) for q in self._queues.values())

    def _shed_victim(self) -> _Request | None:
        # caller holds _cond.  Shed the oldest BULK request first: under
        # overload the latency-sensitive class is the last to be dropped.
        for prio in (BULK, INTERACTIVE):
            if self._queues[prio]:
                return self._queues[prio].popleft()
        return None

    def _admit(self, req: _Request, timeout: float | None) -> None:
        with self._cond:
            if self._closing:
                raise RuntimeError("ReductionService is closed")
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._depth() >= self.max_queue:
                if self.overload == "reject":
                    with self._mlock:
                        self._m["rejected"] += 1
                    raise ServiceOverloaded(
                        f"admission queue full ({self.max_queue} requests)"
                    )
                if self.overload == "shed":
                    victim = self._shed_victim()
                    with self._mlock:
                        self._m["shed"] += 1
                    # resolve outside _cond?  set_exception is lock-free and
                    # never calls back into the service — safe to fail here
                    self._fail(victim, ServiceOverloaded(
                        "request shed: queue overflow, newer work preferred"
                    ), counted="shed")
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        with self._mlock:
                            self._m["rejected"] += 1
                        raise ServiceOverloaded(
                            f"admission wait exceeded {timeout}s"
                        )
                self._cond.wait(remaining)
                if self._closing:
                    raise RuntimeError("ReductionService is closed")
            self._queues[req.priority].append(req)
            self._inflight += 1
            with self._mlock:
                self._m["admitted"] += 1
                self._prio_m[req.priority]["admitted"] += 1
                t = self._tenants.setdefault(
                    req.tenant, {"requests": 0, "raw_bytes": 0}
                )
                t["requests"] += 1
            self._cond.notify_all()

    def _submit(self, req: _Request, timeout: float | None) -> Submission:
        self._admit(req, timeout)
        return Submission(req.future, device=None, lane="service")

    # ------------------------------------------------------------ client API

    def submit_compress(
        self,
        tree: Any,
        select: Callable | None = None,
        *,
        tenant: str = _DEFAULT_TENANT,
        sep: str = "/",
        timeout: float | None = None,
    ) -> Submission:
        """Admit a compress request; future resolves to ``(flat, stats)``.

        Bit-identical to :func:`repro_torch.core.api.compress_pytree` on the same
        engine — including leaves served from a coalesced cross-request
        bucket and leaves that took the per-leaf fallback.
        """
        req = _Request(
            kind="compress", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), tree=tree, select=select, sep=sep,
        )
        return self._submit(req, timeout)

    def compress(self, tree, select=None, *, tenant=_DEFAULT_TENANT,
                 sep="/", timeout=None):
        return self.submit_compress(
            tree, select, tenant=tenant, sep=sep, timeout=timeout
        ).result()

    def submit_decompress(
        self,
        comp: dict[str, Any],
        like: Any,
        *,
        tenant: str = _DEFAULT_TENANT,
        sep: str = "/",
        timeout: float | None = None,
    ) -> Submission:
        """Admit a decompress request; future resolves to the restored tree."""
        req = _Request(
            kind="decompress", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), comp=comp, like=like, sep=sep,
        )
        return self._submit(req, timeout)

    def decompress(self, comp, like, *, tenant=_DEFAULT_TENANT, sep="/",
                   timeout=None):
        return self.submit_decompress(
            comp, like, tenant=tenant, sep=sep, timeout=timeout
        ).result()

    def submit_compress_stream(
        self,
        data: Any,
        method: str = "zfp",
        *,
        tenant: str = _DEFAULT_TENANT,
        chunk_size: int | str = "auto",
        window: int | str = "auto",
        timeout: float | None = None,
        **params: Any,
    ) -> Submission:
        """Admit a chunked-stream compress of one large array.

        The dispatch path consults the auto-tuner: with the default
        ``chunk_size="auto", window="auto"`` the calibrated machine cost
        model picks the chunking and in-flight window per payload
        (degrading to the serial schedule when overlap can't pay), and the
        chunks ride the engine's compute/io lanes.  The future resolves to
        ``(stream_bytes, info)`` — a framed ``HPDS`` stream (decode with
        :meth:`repro_torch.core.api.CompressorStream.from_bytes`) plus the
        tuner's decision and measured wall/ratio.  Bit-identical to an
        explicitly configured :class:`CompressorStream` with the same
        resolved settings.
        """
        req = _Request(
            kind="stream", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), tree=data, method=str(method),
            stream_kwargs={"chunk_size": chunk_size, "window": window,
                           **params},
        )
        return self._submit(req, timeout)

    def compress_stream(self, data, method="zfp", *, tenant=_DEFAULT_TENANT,
                        chunk_size="auto", window="auto", timeout=None,
                        **params):
        return self.submit_compress_stream(
            data, method, tenant=tenant, chunk_size=chunk_size,
            window=window, timeout=timeout, **params,
        ).result()

    def submit_quicklook(
        self,
        path: Any,
        *,
        err: float | None = None,
        tiers: int | None = None,
        tenant: str = _DEFAULT_TENANT,
        timeout: float | None = None,
    ) -> Submission:
        """Admit a quicklook read of a progressive stream file.

        ``path`` names an aggregated progressive file (written by
        :meth:`repro_torch.core.progressive.ProgressiveStream.write`).  With no
        ``err``/``tiers`` the coarsest precision tier is answered from ONE
        component ``pread`` — the cheap low-precision preview; an explicit
        ``err`` (absolute bound) or ``tiers`` fetches exactly that prefix.
        The future resolves to ``(array, info)`` with ``info`` carrying
        ``bytes_fetched`` / ``preads`` / ``tiers_loaded`` / ``tier_bound`` /
        ``file_bytes`` — the prefix-vs-full accounting.
        """
        req = _Request(
            kind="quicklook", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), tree=path,
            stream_kwargs={"err": err, "tiers": tiers},
        )
        return self._submit(req, timeout)

    def quicklook(self, path, *, err=None, tiers=None,
                  tenant=_DEFAULT_TENANT, timeout=None):
        return self.submit_quicklook(
            path, err=err, tiers=tiers, tenant=tenant, timeout=timeout
        ).result()

    def submit_decompress_stream(
        self,
        source: Any,
        *,
        chunks: tuple[int, int] | None = None,
        tenant: str = _DEFAULT_TENANT,
        timeout: float | None = None,
    ) -> Submission:
        """Admit a chunked-stream decode; future resolves to ``(array, info)``.

        ``source`` is a stream file path (written by
        :meth:`~repro_torch.core.api.CompressorStream.to_file`) or framed stream
        bytes (:meth:`to_bytes`); ``chunks=(lo, hi)`` restores only that
        chunk range (concatenated along the stream axis), reading only
        those chunks' byte ranges via the container chunk index.

        Requests for the SAME stream admitted within one dispatch cycle are
        coalesced: each distinct chunk is decoded once and shared — the
        ``chunk_coalesce_hits`` counter is the win.  ``info`` carries the
        chunk range, the group's decode/hit counts, and ``bytes_read``.
        """
        req = _Request(
            kind="decompress_stream", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), tree=source,
            stream_kwargs={"chunks": chunks},
        )
        return self._submit(req, timeout)

    def decompress_stream(self, source, *, chunks=None,
                          tenant=_DEFAULT_TENANT, timeout=None):
        return self.submit_decompress_stream(
            source, chunks=chunks, tenant=tenant, timeout=timeout
        ).result()

    def submit_fetch_kv(
        self,
        session_id: str,
        *,
        tenant: str = _DEFAULT_TENANT,
        timeout: float | None = None,
    ) -> Submission:
        """Admit a parked-KV fetch on the ``interactive`` priority lane.

        Unlike the direct :meth:`fetch_kv` (which bypasses admission
        entirely), this admitted form is what remote clients ride: it
        contends through the priority queue — where interactive work
        preempts bulk — and its wait lands in the interactive histogram.
        The future resolves to the session's compressed containers.
        """
        req = _Request(
            kind="fetch_kv", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), session_id=str(session_id),
        )
        return self._submit(req, timeout)

    def submit_park_kv(
        self,
        session_id: str,
        cache: Any,
        *,
        tenant: str = _DEFAULT_TENANT,
        timeout: float | None = None,
    ) -> Submission:
        """Admit a KV-park request; future resolves to the park stats."""
        req = _Request(
            kind="park_kv", tenant=str(tenant), future=Future(),
            t_enqueue=time.monotonic(), session_id=str(session_id),
            tree=cache,
        )
        return self._submit(req, timeout)

    def park_kv(self, session_id, cache, *, tenant=_DEFAULT_TENANT,
                timeout=None):
        return self.submit_park_kv(
            session_id, cache, tenant=tenant, timeout=timeout
        ).result()

    # KV reads bypass admission: they are metadata-scale (or a single
    # spill pread) and must stay responsive under compute overload.

    def fetch_kv(self, session_id, *, tenant=_DEFAULT_TENANT):
        return self.kv.fetch(session_id, tenant=tenant)

    def restore_kv(self, session_id, like, *, tenant=_DEFAULT_TENANT):
        return self.kv.restore(session_id, like, tenant=tenant)

    def release_kv(self, session_id, *, tenant=_DEFAULT_TENANT):
        self.kv.release(session_id, tenant=tenant)

    def set_tenant_quota(self, tenant: str, capacity_bytes: int | None) -> None:
        self.kv.set_tenant_quota(tenant, capacity_bytes)

    # ------------------------------------------------- connection accounting

    def note_connection(
        self,
        conn_id: str,
        *,
        opened: bool = False,
        closed: bool = False,
        rx_bytes: int = 0,
        tx_bytes: int = 0,
        frames_rx: int = 0,
        frames_tx: int = 0,
        protocol_errors: int = 0,
    ) -> None:
        """Accumulate wire-server byte/frame counters for one connection.

        Called by :class:`~repro_torch.serving.server.ReductionServer`; the
        per-connection entries (and the aggregate totals, which survive the
        connection) surface in :attr:`ServiceStats.connections`.
        """
        with self._mlock:
            if opened:
                self._conn_totals["opened"] += 1
                self._conns.setdefault(conn_id, {
                    "rx_bytes": 0, "tx_bytes": 0, "frames_rx": 0,
                    "frames_tx": 0, "protocol_errors": 0,
                })
            entry = self._conns.get(conn_id)
            for k, v in (("rx_bytes", rx_bytes), ("tx_bytes", tx_bytes),
                         ("frames_rx", frames_rx), ("frames_tx", frames_tx),
                         ("protocol_errors", protocol_errors)):
                self._conn_totals[k] += v
                if entry is not None:
                    entry[k] += v
            if closed:
                self._conn_totals["closed"] += 1
                self._conns.pop(conn_id, None)

    # ------------------------------------------------------------ dispatcher

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    def _pop_next(self) -> _Request | None:
        """Weighted priority dequeue with a starvation bound.

        ``interactive`` wins every pop — unless it has won
        ``starvation_limit`` consecutive pops while bulk work waited, in
        which case one bulk request is forced through (counted as
        ``forced`` in the priority stats).  Caller holds ``_cond``.
        """
        qi, qb = self._queues[INTERACTIVE], self._queues[BULK]
        if qi and qb and self._interactive_run >= self.starvation_limit:
            self._interactive_run = 0
            with self._mlock:
                self._prio_m[BULK]["forced"] += 1
            return qb.popleft()
        if qi:
            self._interactive_run += 1
            return qi.popleft()
        if qb:
            self._interactive_run = 0
            return qb.popleft()
        return None

    def _collect(self) -> list[_Request] | None:
        """Block for the first request, then linger ``batch_window`` for more."""
        with self._cond:
            while not self._depth() and not self._closing:
                self._cond.wait()
            if not self._depth() and self._closing:
                return None
            batch = [self._pop_next()]
            self._cond.notify_all()  # space freed: wake blocked producers
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch_requests:
            with self._cond:
                if self._depth():
                    batch.append(self._pop_next())
                    self._cond.notify_all()
                    continue
                if self._closing:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if not self._depth() and time.monotonic() >= deadline:
                    break
        return batch

    def _dispatch(self, batch: list[_Request]) -> None:
        """Split the batch into leaf jobs, coalesce by spec, submit."""
        now = time.monotonic()
        with self._mlock:
            self._m["dispatch_cycles"] += 1
            for req in batch:
                wait = now - req.t_enqueue
                self._m["wait_s_total"] += wait
                self._m["wait_count"] += 1
                self._m["wait_s_max"] = max(self._m["wait_s_max"], wait)
                pm = self._prio_m[req.priority]
                pm["dispatched"] += 1
                pm["wait_s_total"] += wait
                pm["wait_s_max"] = max(pm["wait_s_max"], wait)
                self._wait_samples[req.priority].append(wait)

        encode_groups: dict[Any, list[tuple[_Request, tuple]]] = {}
        decode_groups: dict[tuple, list[tuple[_Request, str, Any]]] = {}
        stream_decode_groups: dict[Any, list[_Request]] = {}
        for req in batch:
            try:
                if req.kind == "compress":
                    order, raw, jobs, stats = self.engine.encode_leaf_jobs(
                        req.tree, req.select, sep=req.sep
                    )
                    req.order, req.raw, req.stats = order, raw, stats
                    req.stats["buckets"] = len({j[3] for j in jobs})
                    req.remaining = len(jobs)
                    with self._mlock:
                        self._tenants[req.tenant]["raw_bytes"] += stats["raw"]
                    if not jobs:
                        self._resolve_compress(req)
                        continue
                    for job in jobs:
                        encode_groups.setdefault(job[3], []).append((req, job))
                elif req.kind == "decompress":
                    groups = self.engine.decode_leaf_groups(req.comp)
                    req.remaining = sum(len(v) for v in groups.values())
                    if req.remaining == 0:
                        self._resolve_decompress(req)
                        continue
                    for group, items in groups.items():
                        decode_groups.setdefault(group, []).extend(
                            (req, key, c) for key, c in items
                        )
                elif req.kind == "stream":
                    # off the dispatcher thread: the stream's staging loop
                    # blocks on its in-flight window
                    self._stream_pool.submit(self._run_stream, req)
                elif req.kind == "quicklook":
                    # one (or a prefix of) pread + a small reconstruction;
                    # never let file I/O block the dispatcher
                    self._stream_pool.submit(self._run_quicklook, req)
                elif req.kind == "fetch_kv":
                    # a dict lookup or a single spill pread — interactive
                    self._stream_pool.submit(self._run_fetch_kv, req)
                elif req.kind == "decompress_stream":
                    # cross-request coalescing: same-stream requests in one
                    # dispatch cycle share per-chunk decodes via the
                    # container chunk index (ROADMAP "service hardening")
                    stream_decode_groups.setdefault(
                        self._stream_key(req), []
                    ).append(req)
                else:  # park_kv
                    sub = self.kv.park_async(
                        req.session_id, req.tree, tenant=req.tenant
                    )
                    sub.add_done_callback(
                        lambda s, r=req: self._resolve_from_submission(r, s)
                    )
            except Exception as e:
                self._fail(req, e)

        for spec, entries in encode_groups.items():
            items = [job for (_r, job) in entries]
            reqs = {id(r): r for r, _ in entries}
            if self.engine.encode_bucket_stackable(spec, items):
                self._note_stacked(len(items), reqs.values(), encode=True)
                sub = self.engine.submit_encode_bucket(spec, items, priority=BULK)
                sub.add_done_callback(
                    lambda s, es=entries: self._on_encode_bucket(es, s)
                )
            else:
                with self._mlock:
                    self._m["fallback_leaves"] += len(items)
                for req, job in entries:
                    sub = self.engine.submit_encode_job(job, priority=BULK)
                    sub.add_done_callback(
                        lambda s, r=req, k=job[0]: self._on_leaf(r, k, s)
                    )

        for (spec, _geo), entries in decode_groups.items():
            items = [(key, c) for (_r, key, c) in entries]
            reqs = {id(r): r for r, _k, _c in entries}
            prepared = self.engine.decode_bucket_prepared(spec, items)
            if prepared is not None:
                self._note_stacked(len(items), reqs.values(), encode=False)
                sub = self.engine.submit_decode_bucket(
                    spec, items, prepared, priority=BULK
                )
                sub.add_done_callback(
                    lambda s, es=entries: self._on_decode_bucket(es, s)
                )
            else:
                with self._mlock:
                    self._m["decode_fallback_leaves"] += len(items)
                for req, key, c in entries:
                    sub = self.engine.submit_decode_job(spec, c, priority=BULK)
                    sub.add_done_callback(
                        lambda s, r=req, k=key: self._on_leaf(r, k, s)
                    )

        for _key, reqs_same_stream in stream_decode_groups.items():
            self._stream_pool.submit(
                self._run_stream_decode_group, reqs_same_stream
            )

    def _run_stream(self, req: _Request) -> None:
        """One auto-tuned CompressorStream run on a stream-pool thread."""
        try:
            data = req.tree if isinstance(req.tree, torch.Tensor) else np.asarray(req.tree)
            raw_bytes = engine_mod._nbytes(data)
            stream = api.CompressorStream(
                req.method, engine=self.engine, frame=True,
                **req.stream_kwargs,
            )
            res = stream.compress(data)
            blob = api.CompressorStream.to_bytes(res)
            info = {
                "tuned": res.tuned,
                "window": res.window,
                "chunks": len(res.chunks),
                "wall_s": res.wall_time,
                "raw_bytes": raw_bytes,
                "stream_bytes": len(blob),
                "ratio": raw_bytes / max(len(blob), 1),
            }
            with self._mlock:
                self._m["stream_requests"] += 1
                if res.tuned is not None and res.window == 1:
                    self._m["stream_serial_degrades"] += 1
                self._tenants[req.tenant]["raw_bytes"] += raw_bytes
            self._resolve(req, (blob, info))
        except Exception as e:
            self._fail(req, e)

    def _run_quicklook(self, req: _Request) -> None:
        """Answer a precision-tier read from a progressive stream file."""
        try:
            from ..core import progressive  # lazy: serving ↔ core layering

            err = req.stream_kwargs.get("err")
            tiers = req.stream_kwargs.get("tiers")
            with progressive.ProgressiveReader(req.tree, backend=self.engine.backend) as r:
                if err is None and tiers is None:
                    tiers = 1  # default preview: coarsest tier, one pread
                arr = r.retrieve(err, tiers=tiers)
                info = {
                    "bytes_fetched": r.bytes_fetched,
                    "preads": r.preads,
                    "tiers_loaded": r.tiers_loaded,
                    "tier_bound": r.tier_bounds[r.tiers_loaded - 1],
                    "file_bytes": int(os.path.getsize(req.tree)),
                }
            with self._mlock:
                self._m["quicklook_requests"] += 1
                self._m["quicklook_bytes"] += info["bytes_fetched"]
            self._resolve(req, (arr, info))
        except Exception as e:
            self._fail(req, e)

    def _run_fetch_kv(self, req: _Request) -> None:
        """Admitted (interactive-priority) parked-KV fetch."""
        try:
            self._resolve(
                req, self.kv.fetch(req.session_id, tenant=req.tenant)
            )
        except Exception as e:
            self._fail(req, e)

    @staticmethod
    def _stream_key(req: _Request) -> tuple:
        """Identity of a stream source: same key ⇒ same chunk index."""
        from ..core.container import crc32_of

        src = req.tree
        if isinstance(src, (bytes, bytearray, memoryview)):
            raw = bytes(src)
            return ("bytes", len(raw), crc32_of(raw))
        return ("file", os.path.realpath(str(src)))

    def _run_stream_decode_group(self, reqs: list[_Request]) -> None:
        """Decode one stream for N coalesced requests, each chunk once.

        The stream's chunk index locates every chunk, so only the union of
        the requested ranges is ever read or decoded; a chunk needed by
        several requests decodes once and the rest are ``coalesce`` hits.
        """
        try:
            src = reqs[0].tree
            if isinstance(src, (bytes, bytearray, memoryview)):
                result = api.CompressorStream.from_bytes(bytes(src))
            else:
                result = api.CompressorStream.from_file(str(src))
            n = len(result.chunks)
        except Exception as e:
            for req in reqs:
                self._fail(req, e)
            return
        cache: dict[int, torch.Tensor] = {}
        decoded = hits = 0
        for req in reqs:
            try:
                sel = req.stream_kwargs.get("chunks")
                lo, hi = (0, n) if sel is None else (int(sel[0]), int(sel[1]))
                if not 0 <= lo < hi <= n:
                    raise IndexError(
                        f"chunk range [{lo}, {hi}) out of bounds for "
                        f"{n}-chunk stream"
                    )
                parts = []
                for i in range(lo, hi):
                    if i in cache:
                        hits += 1
                    else:
                        cache[i] = api.decode(result.chunks[i], self.engine.backend)
                        decoded += 1
                    parts.append(cache[i])
                arr = torch.cat(parts, dim=result.axis)
                reader = getattr(result.chunks, "reader", None)
                info = {
                    "chunks": [lo, hi],
                    "stream_chunks": n,
                    "axis": result.axis,
                    "group_requests": len(reqs),
                    "group_chunk_decodes": decoded,
                    "group_coalesce_hits": hits,
                }
                if reader is not None:
                    info["bytes_read"] = int(
                        getattr(reader, "pread_bytes", 0) or 0
                    )
                self._resolve(req, (arr, info))
            except Exception as e:
                self._fail(req, e)
        reader = getattr(result.chunks, "reader", None)
        if reader is not None:
            reader.close()
        with self._mlock:
            self._m["stream_decode_requests"] += len(reqs)
            self._m["chunk_decodes"] += decoded
            self._m["chunk_coalesce_hits"] += hits

    def _note_stacked(self, n_leaves: int, reqs, *, encode: bool) -> None:
        reqs = list(reqs)
        with self._mlock:
            if encode:
                self._m["stacked_buckets"] += 1
                self._m["stacked_leaves"] += n_leaves
                self._m["bucket_requests_sum"] += len(reqs)
                if len(reqs) > 1:
                    self._m["coalesced_buckets"] += 1
            else:
                self._m["decode_stacked_buckets"] += 1
                self._m["decode_stacked_leaves"] += n_leaves
            if len(reqs) > 1:
                for req in reqs:
                    if not req.coalesced:
                        req.coalesced = True
                        self._m["coalesced_requests"] += 1

    # ------------------------------------------------------------ completion

    def _on_encode_bucket(self, entries, sub: Submission) -> None:
        exc = sub.exception()
        if exc is not None:
            for req, _job in entries:
                self._fail(req, exc)
            return
        for (req, job), c in zip(entries, sub.result()):
            self._deliver(req, job[0], c)

    def _on_decode_bucket(self, entries, sub: Submission) -> None:
        exc = sub.exception()
        if exc is not None:
            for req, _key, _c in entries:
                self._fail(req, exc)
            return
        for (req, key, _c), out in zip(entries, sub.result()):
            self._deliver(req, key, out)

    def _on_leaf(self, req: _Request, key: str, sub: Submission) -> None:
        exc = sub.exception()
        if exc is not None:
            self._fail(req, exc)
            return
        self._deliver(req, key, sub.result())

    def _deliver(self, req: _Request, key: str, value: Any) -> None:
        with req.lock:
            if req.failed:
                return
            req.results[key] = value
            req.remaining -= 1
            finished = req.remaining == 0
        if finished:
            try:
                if req.kind == "compress":
                    self._resolve_compress(req)
                else:
                    self._resolve_decompress(req)
            except Exception as e:
                self._fail(req, e)

    def _resolve_compress(self, req: _Request) -> None:
        stats = req.stats
        flat: dict[str, Any] = {}
        for key in req.order:
            if key in req.raw:
                flat[key] = req.raw[key]
                continue
            c = req.results[key]
            flat[key] = c
            stats["compressed"] += c.nbytes()
            stats["compressed_leaves"] += 1
        stats["ratio"] = stats["raw"] / max(stats["compressed"], 1)
        stats["coalesced"] = req.coalesced
        self._resolve(req, (flat, stats))

    def _resolve_decompress(self, req: _Request) -> None:
        flat = {
            key: req.results[key] if key in req.results else val
            for key, val in req.comp.items()
        }
        self._resolve(req, api.unflatten_like(
            req.like, lambda key: api.as_tensor(flat[key]), req.sep))

    def _resolve_from_submission(self, req: _Request, sub: Submission) -> None:
        exc = sub.exception()
        if exc is not None:
            self._fail(req, exc)
        else:
            self._resolve(req, sub.result())

    def _resolve(self, req: _Request, value: Any) -> None:
        req.future.set_result(value)
        with self._mlock:
            self._m["completed"] += 1
        self._request_done()

    def _fail(self, req: _Request, exc: BaseException,
              counted: str = "failed") -> None:
        with req.lock:
            if req.failed or req.future.done():
                return
            req.failed = True
        req.future.set_exception(exc)
        if counted == "failed":
            with self._mlock:
                self._m["failed"] += 1
        self._request_done()

    def _request_done(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    # --------------------------------------------------------------- metrics

    @staticmethod
    def _wait_hist(samples: list[float], pm: dict) -> dict[str, float]:
        n = len(samples)
        arr = np.asarray(samples) if n else None
        return {
            "admitted": pm["admitted"],
            "dispatched": pm["dispatched"],
            "forced": pm["forced"],
            "wait_mean": pm["wait_s_total"] / max(pm["dispatched"], 1),
            "wait_max": pm["wait_s_max"],
            "wait_p50": float(np.percentile(arr, 50)) if n else 0.0,
            "wait_p99": float(np.percentile(arr, 99)) if n else 0.0,
            "samples": n,
        }

    def stats(self) -> ServiceStats:
        with self._cond:
            depths = {p: len(q) for p, q in self._queues.items()}
            depth = sum(depths.values())
            inflight = self._inflight
        lanes = self.engine.executor.lane_stats()
        prio_lanes = self.engine.executor.priority_stats()
        kv_stats = self.kv.stats()
        with self._mlock:
            m = dict(self._m)
            tenants = {t: dict(v) for t, v in self._tenants.items()}
            priorities = {
                p: {"depth": depths[p],
                    **self._wait_hist(list(self._wait_samples[p]),
                                      self._prio_m[p])}
                for p in PRIORITIES
            }
            connections = {
                **self._conn_totals,
                "open": len(self._conns),
                "per_connection": {c: dict(v) for c, v in self._conns.items()},
            }
        parked = kv_stats.get("tenant_bytes", {})
        for tenant, nbytes in parked.items():
            tenants.setdefault(tenant, {"requests": 0, "raw_bytes": 0})
        for tenant in tenants:
            tenants[tenant]["parked_bytes"] = parked.get(tenant, 0)
        return ServiceStats(
            queue_depth=depth,
            max_queue=self.max_queue,
            inflight_requests=inflight,
            admitted=m["admitted"],
            completed=m["completed"],
            failed=m["failed"],
            rejected=m["rejected"],
            shed=m["shed"],
            dispatch_cycles=m["dispatch_cycles"],
            wait_s_mean=m["wait_s_total"] / max(m["wait_count"], 1),
            wait_s_max=m["wait_s_max"],
            stacked_buckets=m["stacked_buckets"],
            stacked_leaves=m["stacked_leaves"],
            coalesced_buckets=m["coalesced_buckets"],
            coalesced_requests=m["coalesced_requests"],
            fallback_leaves=m["fallback_leaves"],
            batch_fill_ratio=(
                m["stacked_leaves"] / max(m["stacked_buckets"], 1)
            ),
            requests_per_bucket=(
                m["bucket_requests_sum"] / max(m["stacked_buckets"], 1)
            ),
            decode_stacked_buckets=m["decode_stacked_buckets"],
            decode_stacked_leaves=m["decode_stacked_leaves"],
            decode_fallback_leaves=m["decode_fallback_leaves"],
            stream_requests=m["stream_requests"],
            stream_serial_degrades=m["stream_serial_degrades"],
            quicklook_requests=m["quicklook_requests"],
            quicklook_bytes=m["quicklook_bytes"],
            stream_decode_requests=m["stream_decode_requests"],
            chunk_decodes=m["chunk_decodes"],
            chunk_coalesce_hits=m["chunk_coalesce_hits"],
            per_tenant=tenants,
            priorities=priorities,
            executor_lanes=lanes,
            executor_priorities=prio_lanes,
            connections=connections,
            kv=kv_stats,
        )

    # ------------------------------------------------------------- lifecycle

    def close(self, timeout: float | None = None) -> None:
        """Drain queued + in-flight requests, then stop the dispatcher.

        Idempotent.  New submissions during/after close raise
        ``RuntimeError``; already-admitted requests complete normally.
        """
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._thread.join(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                self._cond.wait(remaining)
        self._stream_pool.shutdown(wait=True)

    def __enter__(self) -> "ReductionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
