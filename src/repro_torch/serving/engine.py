"""Batched serving engine: prefill + decode with optional KV compression
(counterpart of ``repro.serving.engine``).

Production shape: fixed batch slots, greedy continuous refill from a request
queue, single-token decode over stacked layer caches.  Prefill runs as
decode steps over the prompt.  As in the reference, one shared
``cache_len = lens.max()`` drives every slot's decode step, and a slot's
prefill writes at its own length across the whole batch: the reference's
behaviour, reproduced (``ROADMAP.md``).

HPDR integration: ``compress_kv_cache``/``decompress_kv_cache`` push cold KV
pages through ZFP fixed-rate blocks — the serving-side analogue of the
paper's reduction-before-I/O, used when parking long-context sessions.
Parking runs on the execution engine, and ``park_kv_cache_async`` returns a
future so the decode loop keeps stepping while a session is parked in the
background.  The reference snapshots an (immutable) JAX cache to host
numpy; the port's cache is written in place by the decode loop, so the
snapshot is a copy made before ``park_async`` returns: a ``clone()`` of
each tensor on the caller's stream (on the card, a device copy), which the
io-lane task's work is ordered after through an event.  :class:`KVPageStore`
bounds the memory parked sessions hold: tracked bytes sit behind a CMM
byte-budget LRU whose evictions spill containers to disk (the reference's
``HPKV`` files, byte for byte), and evicted sessions re-materialise
transparently on next access.
"""

from __future__ import annotations

import hashlib
import io
import json
import tempfile
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..core import api
from ..core import engine as engine_mod
from ..core.context import ContextCache, ReductionContext
from ..models.model import Model
from ..runtime.executor import Submission
from .protocol import npy_bytes


@dataclass
class Request:
    uid: int
    prompt: Any                  # (S,) int tokens (numpy or a tensor)
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Greedy batched decoding over ``batch_size`` slots of one cache.

    The cache (``model.init_cache``, ``cache_dtype``) lives on the device of
    the parameters, and so does every decode step.
    """

    def __init__(self, model: Model, params: Any, batch_size: int, max_len: int,
                 cache_dtype=torch.float32):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.cache = model.init_cache(batch_size, max_len, cache_dtype, self.device)
        self.lens = np.zeros(batch_size, np.int32)
        self.slots: list[Request | None] = [None] * batch_size
        self._decode = model.decode_step

    def _step(self, toks: np.ndarray, cache_len: int) -> torch.Tensor:
        logits, self.cache = self._decode(
            self.params, torch.from_numpy(toks).to(self.device), self.cache, cache_len)
        return logits

    # ------------------------------------------------------------- prefill

    def _prefill_slot(self, slot: int, prompt) -> int:
        """Feed prompt tokens through decode steps (slot-batched)."""
        last = 0
        for tok in np.asarray(prompt):
            toks = np.zeros(self.batch_size, np.int32)
            toks[slot] = tok
            logits = self._step(toks, int(self.lens[slot]))
            self.lens[slot] += 1
            last = int(torch.argmax(logits[slot]))
        return last

    # --------------------------------------------------------------- serve

    def serve(self, requests: list[Request]) -> dict:
        """Run all requests to completion with continuous slot refill."""
        queue = list(requests)
        active: dict[int, Request] = {}
        t0 = time.perf_counter()
        steps = 0
        pending_tok = np.zeros(self.batch_size, np.int32)

        def refill():
            for s in range(self.batch_size):
                if self.slots[s] is None and queue:
                    req = queue.pop(0)
                    self.slots[s] = req
                    active[s] = req
                    pending_tok[s] = self._prefill_slot(s, req.prompt)

        refill()
        while active:
            # one shared cache_len for the whole batch, as the reference
            logits = self._step(pending_tok, int(self.lens.max()))
            steps += 1
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            for s, req in list(active.items()):
                req.out_tokens.append(int(nxt[s]))
                self.lens[s] += 1
                pending_tok[s] = nxt[s]
                if len(req.out_tokens) >= req.max_new_tokens or self.lens[s] >= self.max_len - 1:
                    req.done = True
                    self.slots[s] = None
                    del active[s]
            refill()
        dt = time.perf_counter() - t0
        total_tokens = sum(len(r.out_tokens) for r in requests)
        return {
            "requests": len(requests),
            "decode_steps": steps,
            "new_tokens": total_tokens,
            "wall_s": dt,
            "tokens_per_s": total_tokens / dt if dt else float("inf"),
        }


# ---------------------------------------------------------------------------
# KV-cache compression (HPDR integration)
# ---------------------------------------------------------------------------

# numpy kind "f": the reference's select tests ``arr.dtype.kind == "f"``,
# which bfloat16 (an ml_dtypes void type there) is not
_KIND_F = ("float16", "float32", "float64")


def _kv_select(rate: int):
    def select(key: str, arr):
        del key
        size = arr.numel() if isinstance(arr, torch.Tensor) else int(np.size(arr))
        if api.dtype_name(arr) in _KIND_F and size >= 4096:
            return "zfp", {"rate": rate}
        return None

    return select


def compress_kv_cache(
    cache: Any, rate: int = 12, engine: engine_mod.ExecutionEngine | None = None
) -> tuple[Any, dict]:
    """ZFP fixed-rate compression of float cache leaves (park a session).

    Thin policy over :func:`api.compress_pytree`, executed on the execution
    engine: same-shape KV pages bucket into one plan (cached in the CMM so
    parking session N+1 reuses session N's plan) and run as one batched
    bucket; everything else is passed through raw.
    """
    return api.compress_pytree(cache, _kv_select(rate), engine=engine)


def _snapshot(cache: Any) -> tuple[Any, list]:
    """A copy of every tensor of ``cache`` made now, on the caller's stream,
    and ``(device, event)`` for each card, recorded after the copies (numpy
    leaves are taken as they are, as the reference takes them)."""
    snap = {key: leaf.detach().clone() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for key, leaf in api.flatten_with_keys(cache)}
    events = []
    for dev in {t.device for t in snap.values() if isinstance(t, torch.Tensor) and t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return api.unflatten_like(cache, snap.__getitem__), events


def _after(events: list, fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)`` with each card's current stream (where this
    thread queues its own work) and default stream (which every engine task
    stream waits on when it starts) made to wait on the snapshot's event
    first."""
    for dev, ev in events:
        torch.cuda.current_stream(dev).wait_event(ev)
        torch.cuda.default_stream(dev).wait_event(ev)
    return fn(*args, **kwargs)


def park_kv_cache_async(
    cache: Any, rate: int = 12, engine: engine_mod.ExecutionEngine | None = None
) -> Submission:
    """Park a session in the background: future resolving to (flat, stats).

    The cache is snapshotted first (a copy on the caller's stream, as in
    ``CheckpointManager.save_async``); compression then runs on the
    engine's io lane while decode steps continue.
    """
    eng = engine if engine is not None else engine_mod.default_engine()
    snapshot, events = _snapshot(cache)
    return eng.submit(_after, events, api.compress_pytree, snapshot, _kv_select(rate),
                      engine=eng, lane="io")


def decompress_kv_cache(
    comp: Any, like: Any, engine: engine_mod.ExecutionEngine | None = None
) -> Any:
    return api.decompress_pytree(comp, like, engine=engine)


# ---------------------------------------------------------------------------
# parked-session store: CMM byte-budget LRU + transparent disk spill
# ---------------------------------------------------------------------------

_KV_MAGIC = b"HPKV"
_KV_VERSION = 1


def _dump_flat(flat: dict[str, Any]) -> bytes:
    """Serialise one parked session's ``compress_kv_cache`` output."""
    entries, blobs = [], []
    off = 0
    for key, val in flat.items():
        if isinstance(val, api.Compressed):
            kind, blob = "hpdr", val.to_bytes()
        else:
            kind, blob = "npy", npy_bytes(val)
        entries.append({"key": key, "kind": kind, "offset": off,
                        "nbytes": len(blob)})
        off += len(blob)
        blobs.append(blob)
    header = json.dumps({"entries": entries}).encode()
    out = io.BytesIO()
    out.write(_KV_MAGIC)
    out.write(np.uint32(_KV_VERSION).tobytes())
    out.write(np.uint64(len(header)).tobytes())
    out.write(header)
    for blob in blobs:
        out.write(blob)
    return out.getvalue()


def _load_flat(raw: bytes) -> dict[str, Any]:
    if len(raw) < 16 or raw[:4] != _KV_MAGIC:
        raise ValueError("not an HPDR parked-KV stream")
    version = int(np.frombuffer(raw[4:8], np.uint32)[0])
    if version != _KV_VERSION:
        raise ValueError(f"unsupported parked-KV version {version}")
    hlen = int(np.frombuffer(raw[8:16], np.uint64)[0])
    header = json.loads(raw[16:16 + hlen].decode())
    base = 16 + hlen
    flat: dict[str, Any] = {}
    for entry in header["entries"]:
        lo = base + entry["offset"]
        blob = raw[lo:lo + entry["nbytes"]]
        if entry["kind"] == "hpdr":
            flat[entry["key"]] = api.Compressed.from_bytes(blob)
        else:
            flat[entry["key"]] = np.load(io.BytesIO(blob), allow_pickle=False)
    return flat


_DEFAULT_TENANT = "default"


class KVPageStore:
    """Parked serving sessions behind the CMM's byte-budget LRU.

    ``park`` compresses a session's KV cache on the execution engine (plans
    CMM-cached) and tracks the resulting containers as a
    :class:`~repro_torch.core.context.ContextCache` entry, so total parked
    bytes are bounded: under memory pressure the least-recently-used
    sessions are evicted through the cache's ``on_evict`` hook, which
    *spills their containers to disk*.  A later ``fetch``/``restore`` of an
    evicted session re-materialises it from the spill transparently
    (observable as ``load_count``).  Raw (uncompressed) leaves are kept as
    copies, since the caller's cache is written in place after a park.

    Sessions are **tenant-scoped**: every entry is keyed by
    ``(tenant, session_id)``, and :meth:`set_tenant_quota` bounds one
    tenant's resident bytes independently of the global budget — over
    quota, that tenant's own LRU sessions spill first, so a heavy tenant
    cannot displace a light one.  :meth:`park_async` registers its in-flight
    submission so a concurrent ``fetch``/``restore``/``release`` of the same
    session waits for the park to land instead of observing a half-written
    view.
    """

    def __init__(
        self,
        capacity_bytes: int = 256 << 20,
        spill_dir: str | Path | None = None,
        rate: int = 12,
        engine: engine_mod.ExecutionEngine | None = None,
        tenant_quota_bytes: dict[str, int] | None = None,
    ):
        self.rate = rate
        self.engine = engine
        self.spill_dir = Path(
            spill_dir if spill_dir is not None
            else tempfile.mkdtemp(prefix="hpdr-kv-")
        )
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        self.cache = ContextCache(
            capacity=1 << 30,  # bounded by bytes, not entry count
            capacity_bytes=capacity_bytes,
            on_evict=self._spill,
            group_fn=lambda key: key[1],  # ("kv_page", tenant, session)
        )
        for tenant, quota in (tenant_quota_bytes or {}).items():
            self.cache.set_group_capacity(str(tenant), quota)
        # Store-level mutation lock (reentrant: an insert may trigger an
        # eviction spill while the lock is held).  Serialises park / fetch /
        # release against in-flight LRU spills, so releasing a session
        # cannot interleave with its own eviction and resurrect it from a
        # spill written after the release.
        self._lock = threading.RLock()
        # session key -> in-flight async park (a Future registered *before*
        # the submission exists, so fetch can never slip between submit and
        # registration)
        self._inflight: dict[tuple, Future] = {}
        self.spill_count = 0
        self.load_count = 0

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _key(session_id: str, tenant: str = _DEFAULT_TENANT) -> tuple:
        return ("kv_page", str(tenant), str(session_id))

    def _path(self, session_id: str, tenant: str = _DEFAULT_TENANT) -> Path:
        # digest suffix: sanitization alone could collide distinct session
        # ids ("user:1" vs "user_1") onto one spill file — and silently
        # serve one session's KV state for another after re-materialising.
        # The digest covers the tenant too, so same-named sessions of
        # different tenants never share a spill.
        sid, tid = str(session_id), str(tenant)
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in sid)
        digest = hashlib.sha1(f"{tid}\x00{sid}".encode()).hexdigest()[:8]
        return self.spill_dir / f"{safe[:80]}-{digest}.hpkv"

    def _spill(self, ctx) -> None:
        _tag, tenant, session_id = ctx.key
        self._path(session_id, tenant).write_bytes(_dump_flat(ctx.buffers))
        with self._lock:
            self.spill_count += 1

    def _wait_inflight(self, session_id: str, tenant: str) -> None:
        """Block until any in-flight async park of this session lands.

        A park *failure* is swallowed here — it surfaces on the
        ``park_async`` submission; the waiter then simply sees whatever
        state preceded the failed park (usually ``KeyError``).
        """
        with self._lock:
            fut = self._inflight.get(self._key(session_id, tenant))
        if fut is not None:
            try:
                fut.result()
            except Exception:
                pass

    def _park(self, session_id: str, cache: Any, tenant: str, *, owned: bool) -> dict:
        """Compress and track one session; ``owned`` says the cache is a
        snapshot nobody else writes (else raw tensor leaves are copied)."""
        flat, stats = compress_kv_cache(cache, rate=self.rate, engine=self.engine)
        if not owned:
            flat = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                    for k, v in flat.items()}
        key = self._key(session_id, tenant)
        with self._lock:
            self.cache.discard(key)  # re-park replaces the tracked entry
            ctx = ReductionContext(key=key, plan=None, buffers=flat)
            self.cache.get_or_create(key, lambda: ctx)
        return stats

    # -- public API ----------------------------------------------------------

    def set_tenant_quota(self, tenant: str, capacity_bytes: int | None) -> None:
        """Bound one tenant's resident parked bytes (``None`` clears)."""
        self.cache.set_group_capacity(str(tenant), capacity_bytes)

    def park(
        self, session_id: str, cache: Any, *, tenant: str = _DEFAULT_TENANT
    ) -> dict:
        """Compress + track one session; returns the compression stats."""
        return self._park(session_id, cache, tenant, owned=False)

    def park_async(
        self, session_id: str, cache: Any, *, tenant: str = _DEFAULT_TENANT
    ) -> Submission:
        """Background park on the engine's io lane (decode keeps stepping).

        The cache is copied before this returns (see :func:`_snapshot`), so
        the caller may go on writing it.  The in-flight park is registered
        under the session key before the io-lane submission exists, so a
        concurrent :meth:`fetch` / :meth:`release` of the same session waits
        for it to land — it can never observe the store mid-park.
        """
        eng = self.engine if self.engine is not None else engine_mod.default_engine()
        snapshot, events = _snapshot(cache)
        key = self._key(session_id, tenant)
        done: Future = Future()
        with self._lock:
            self._inflight[key] = done

        def _do() -> dict:
            try:
                out = _after(events, self._park, session_id, snapshot, tenant, owned=True)
            except BaseException as e:
                done.set_exception(e)
                raise
            else:
                done.set_result(out)
                return out
            finally:
                with self._lock:
                    if self._inflight.get(key) is done:
                        del self._inflight[key]

        return eng.submit(_do, lane="io")

    def fetch(
        self, session_id: str, *, tenant: str = _DEFAULT_TENANT
    ) -> dict[str, Any]:
        """The session's compressed containers; re-materialises a spilled
        session from disk transparently and waits on an in-flight async
        park of the same session."""
        self._wait_inflight(session_id, tenant)

        def rematerialize():
            path = self._path(session_id, tenant)
            if not path.exists():
                raise KeyError(f"unknown parked session {session_id!r}")
            flat = _load_flat(path.read_bytes())
            self.load_count += 1
            return ReductionContext(key=self._key(session_id, tenant),
                                    plan=None, buffers=flat)

        with self._lock:
            return self.cache.get_or_create(
                self._key(session_id, tenant), rematerialize
            ).buffers

    def restore(
        self, session_id: str, like: Any, *, tenant: str = _DEFAULT_TENANT
    ) -> Any:
        """Decompress a parked session back into ``like``'s structure."""
        return decompress_kv_cache(self.fetch(session_id, tenant=tenant),
                                   like, engine=self.engine)

    def release(
        self, session_id: str, *, tenant: str = _DEFAULT_TENANT
    ) -> None:
        """Forget a session entirely (cache entry + spill file)."""
        self._wait_inflight(session_id, tenant)
        with self._lock:
            self.cache.discard(self._key(session_id, tenant))
            path = self._path(session_id, tenant)
            if path.exists():
                path.unlink()

    def tenant_bytes(self) -> dict[str, int]:
        """Resident parked bytes per tenant (the ServiceStats surface)."""
        return self.cache.nbytes_by_group()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "sessions": len(self.cache),
                "parked_bytes": self.cache.nbytes(),
                "capacity_bytes": self.cache.capacity_bytes,
                "spills": self.spill_count,
                "loads": self.load_count,
                "evictions": self.cache.evict_count,
                "tenant_bytes": self.cache.nbytes_by_group(),
                "tenant_evictions": dict(self.cache.group_evict_count),
            }
