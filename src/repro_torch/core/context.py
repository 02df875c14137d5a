"""Context Memory Model (CMM) — HPDR §III-B.

The paper identifies per-call memory management (allocations for the
reduction *context*: workspace buffers, plans, codebooks) as a dominant,
overlooked cost — and the one that destroys multi-accelerator scaling,
because concurrent allocator traffic serialises inside a shared runtime.
CMM fixes this by hash-caching contexts so repeated reductions with the
same characteristics reuse persistent allocations.

PyTorch port (a copy of ``repro.core.context``; the port imports nothing of
``repro``):
  * the *plan* part of a context is the codec's plan — the bound kernel
    wrappers plus the device-resident tables they read (sequency
    permutation, scale tables), built once per (algorithm, shape, dtype,
    params) key, exactly like the paper's cached plans;
  * the *buffer* part is a dict of persistent device tensors;
  * cache statistics: the modelled per-call allocator cost is zero on a hit.

The cache is LRU by entry count and thread-safe (serving engines may call
from threads).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable


@dataclass
class ReductionContext:
    """A persistent reduction context (paper: plan + workspace allocations)."""

    key: Hashable
    plan: Any                       # usually a jitted callable
    buffers: dict[str, Any] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)
    hits: int = 0

    def nbytes(self) -> int:
        total = 0
        for buf in self.buffers.values():
            nb = getattr(buf, "nbytes", 0)
            total += int(nb() if callable(nb) else nb)
        return total


class ContextCache:
    """Hash-map context cache with LRU eviction (HPDR CMM).

    Eviction runs on two policies: entry count (``capacity``, the classic
    plan-cache bound) and, when ``capacity_bytes`` is set, total tracked
    buffer bytes — the memory-pressure policy the serving engine's parked
    KV pages sit behind.  ``on_evict(ctx)`` fires for every evicted context
    *outside* the cache lock, so a spill handler can persist the evicted
    buffers (and must not call back into the cache).
    """

    def __init__(
        self,
        capacity: int = 64,
        capacity_bytes: int | None = None,
        on_evict: Callable[[ReductionContext], None] | None = None,
        group_fn: Callable[[Hashable], Any] | None = None,
    ):
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.on_evict = on_evict
        # Tenant-scoped accounting: ``group_fn(key)`` names the group a
        # context's bytes are charged to; groups with a quota set via
        # ``set_group_capacity`` get their own LRU eviction pass, so one
        # tenant's parked sessions can never displace another tenant's
        # budget (the serving layer's per-tenant CMM quota).
        self.group_fn = group_fn
        self._group_capacity: dict[Any, int] = {}
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, ReductionContext] = OrderedDict()
        self.hit_count = 0
        self.miss_count = 0
        self.evict_count = 0
        self.group_evict_count: dict[Any, int] = {}

    def _evict_over_capacity(self) -> list[ReductionContext]:
        """Pop LRU entries past either capacity bound (lock held).

        The most recent entry is never evicted — a single context larger
        than the byte budget stays resident while in use.
        """
        evicted = []
        while len(self._entries) > self.capacity and len(self._entries) > 1:
            evicted.append(self._entries.popitem(last=False)[1])
            self.evict_count += 1
        if self.capacity_bytes is not None:
            # Recomputed (not a running counter) because tracked contexts
            # grow after insertion — plans accrete decode tables into their
            # workspace.  Byte-capacity caches hold few, large entries
            # (parked sessions), so the walk is cheap relative to the
            # compression that precedes every insert; the hot plan cache
            # (GLOBAL_CMM) sets no byte bound and never pays this.
            total = sum(c.nbytes() for c in self._entries.values())
            while total > self.capacity_bytes and len(self._entries) > 1:
                _, ctx = self._entries.popitem(last=False)
                total -= ctx.nbytes()
                evicted.append(ctx)
                self.evict_count += 1
        if self.group_fn is not None and self._group_capacity:
            evicted.extend(self._evict_over_group_quotas())
        return evicted

    def _evict_over_group_quotas(self) -> list[ReductionContext]:
        """Evict LRU entries of any group over its byte quota (lock held).

        The most recently used entry overall is exempt, matching the global
        byte policy: the context just touched stays resident even when it
        alone exceeds its group's quota.
        """
        evicted: list[ReductionContext] = []
        totals: dict[Any, int] = {}
        for key, ctx in self._entries.items():
            group = self.group_fn(key)
            if group in self._group_capacity:
                totals[group] = totals.get(group, 0) + ctx.nbytes()
        newest = next(reversed(self._entries)) if self._entries else None
        for group, cap in self._group_capacity.items():
            total = totals.get(group, 0)
            if total <= cap:
                continue
            for key in [
                k for k in self._entries if self.group_fn(k) == group
            ]:
                if total <= cap:
                    break
                if key == newest:
                    continue
                ctx = self._entries.pop(key)
                total -= ctx.nbytes()
                evicted.append(ctx)
                self.evict_count += 1
                self.group_evict_count[group] = (
                    self.group_evict_count.get(group, 0) + 1
                )
        return evicted

    def set_group_capacity(self, group: Any, capacity_bytes: int | None) -> None:
        """Set (or clear, with ``None``) one group's byte quota.

        Takes effect on the next insert; an already-over-quota group is
        trimmed then, not here (callers wanting immediate enforcement can
        touch the cache with any insert).
        """
        with self._lock:
            if capacity_bytes is None:
                self._group_capacity.pop(group, None)
            else:
                self._group_capacity[group] = int(capacity_bytes)

    def group_capacity(self, group: Any) -> int | None:
        with self._lock:
            return self._group_capacity.get(group)

    def nbytes_by_group(self) -> dict[Any, int]:
        """Tracked bytes per group (every group, quota'd or not)."""
        if self.group_fn is None:
            return {}
        with self._lock:
            totals: dict[Any, int] = {}
            for key, ctx in self._entries.items():
                group = self.group_fn(key)
                totals[group] = totals.get(group, 0) + ctx.nbytes()
            return totals

    def get_or_create(
        self, key: Hashable, builder: Callable[[], ReductionContext]
    ) -> ReductionContext:
        """Return the cached context for ``key``; build + insert on miss.

        The builder runs outside the lock on a miss is *not* safe for
        correctness of single-build (two threads may both build), but both
        results are identical and one wins — the paper makes the same
        idempotency assumption for its context table.
        """
        with self._lock:
            ctx = self._entries.get(key)
            if ctx is not None:
                self._entries.move_to_end(key)
                self.hit_count += 1
                ctx.hits += 1
                return ctx
            self.miss_count += 1
        ctx = builder()
        ctx.key = key
        with self._lock:
            self._entries[key] = ctx
            self._entries.move_to_end(key)
            evicted = self._evict_over_capacity()
        if self.on_evict is not None:
            for victim in evicted:
                self.on_evict(victim)
        return ctx

    def evict(self, key: Hashable) -> ReductionContext | None:
        """Explicitly drop one context (fires ``on_evict``); None if absent."""
        with self._lock:
            ctx = self._entries.pop(key, None)
            if ctx is not None:
                self.evict_count += 1
        if ctx is not None and self.on_evict is not None:
            self.on_evict(ctx)
        return ctx

    def discard(self, key: Hashable) -> ReductionContext | None:
        """Silently drop one context (no ``on_evict``, e.g. replacement)."""
        with self._lock:
            return self._entries.pop(key, None)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def nbytes(self) -> int:
        with self._lock:
            return sum(c.nbytes() for c in self._entries.values())

    def stats(self) -> dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hit_count,
            "misses": self.miss_count,
            "evictions": self.evict_count,
            "bytes": self.nbytes(),
        }


# Global CMM instance used by the pipelines/API (one per process, like the
# paper's per-runtime context table).
GLOBAL_CMM = ContextCache(capacity=128)


def context_key(algorithm: str, shape: tuple, dtype: Any, **params: Any) -> tuple:
    """Canonical context hash key (paper: 'similar data characteristics')."""
    return (algorithm, tuple(shape), str(dtype), tuple(sorted(params.items())))
