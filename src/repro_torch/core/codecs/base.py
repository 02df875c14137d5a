"""Codec protocol + plan objects for the HPDR codec registry (counterpart of
``repro.core.codecs.base``).

  * :class:`ReductionSpec` — the hashable description of a reduction
    (method, shape, dtype, method parameters, backend).  Its
    :meth:`ReductionSpec.key` is the CMM hash key.
  * :class:`ReductionPlan` — what planning produces: the stage pipeline
    bound to the spec's static arguments, the plan-bound per-stage
    ``executables`` some codecs also carry, plus the device-resident tables
    (permutations, scale tables, level maps) that repeated calls reuse.
  * :class:`Codec` — the protocol every registered compressor implements:
    ``plan(spec)``, ``encode(plan, data)``, ``decode(plan, c)``.

Codecs are stateless; all per-(shape, dtype, params) state lives in the plan,
which the API layer stores in the global CMM.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from ...runtime.trace import span
from .. import adapters
from ..container import Compressed
from ..context import context_key


@dataclass(frozen=True)
class ReductionSpec:
    """Hashable description of one reduction: method + data characteristics.

    ``backend`` names the device adapter the plan is bound to
    (``auto`` | ``torch`` | ``cuda``); ``auto`` resolves to ``cuda``.
    """

    method: str
    shape: tuple[int, ...]
    dtype: str
    params: tuple[tuple[str, Any], ...] = ()
    backend: str = adapters.AUTO

    @classmethod
    def create(
        cls,
        method: str,
        shape: tuple[int, ...],
        dtype: Any,
        backend: str = adapters.AUTO,
        **params: Any,
    ) -> "ReductionSpec":
        return cls(
            method=method,
            shape=tuple(int(n) for n in shape),
            dtype=str(dtype),
            params=tuple(sorted(params.items())),
            backend=str(backend),
        )

    def param(self, name: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == name:
                return v
        return default

    def resolved(self) -> "ReductionSpec":
        """This spec with ``backend`` bound to a concrete, runnable backend."""
        concrete = adapters.resolve_backend(self.backend)
        if concrete == self.backend:
            return self
        return dataclasses.replace(self, backend=concrete)

    def key(self) -> tuple:
        """Canonical CMM hash key for this spec (backend-resolved).

        A ``cuda`` plan holds its tables on the current CUDA device, so the
        key names that device: an engine that places work on several cards
        gets one plan per card.
        """
        backend = adapters.resolve_backend(self.backend)
        where = {"device": torch.cuda.current_device()} if backend == adapters.CUDA else {}
        return context_key(
            self.method, self.shape, self.dtype,
            backend=backend, **where, **dict(self.params),
        )


@dataclass
class ReductionPlan:
    """A built plan: the compiled stage pipeline + persistent device tensors.

    ``device`` is where the plan's tensors live and its kernels run (the
    CPU for ``torch``, the current CUDA device for ``cuda``).  ``workspace``
    holds the data-independent tables the kernels read — the paper's
    persistent context allocations.  ``executables`` maps a stage name to a
    callable with the spec's statics and backend bound (MGARD's
    ``decompose``/``quantize``/``dequantize``/``recompose``, which the
    progressive tier runs).  An executable that takes a workspace tensor
    hands it back; callers re-store it with :meth:`recycle` while holding
    :attr:`lock`, as in the reference, whose executables donate the buffer
    (PyTorch has no donation, so the tensor comes back unchanged).
    """

    spec: ReductionSpec
    device: torch.device
    executables: dict[str, Any] = field(default_factory=dict)
    workspace: dict[str, Any] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)
    pipeline: Any = field(default=None, repr=False, compare=False)
    lock: Any = field(default_factory=threading.Lock, repr=False, compare=False)

    def nbytes(self) -> int:
        return sum(int(getattr(b, "nbytes", 0)) for b in self.workspace.values())

    def recycle(self, name: str, buf: Any) -> None:
        """Re-store a workspace tensor an executable handed back."""
        self.workspace[name] = buf


class Codec:
    """Base class for registered codecs (see :mod:`repro_torch.core.codecs`).

    Subclasses set :attr:`spec_defaults` — the parameter names that belong
    in this codec's :class:`ReductionSpec`, with their default values — and
    implement :meth:`plan`, :meth:`build_stages`, :meth:`finish_container`,
    :meth:`decode_state` and :meth:`decode_spec`; :meth:`encode_input` and
    :meth:`finish_decode` are the hooks around the pipeline's two ends.
    """

    spec_defaults: dict[str, Any] = {}

    def __init__(self, name: str):
        self.name = name

    def spec_params(self) -> tuple[str, ...]:
        return tuple(self.spec_defaults)

    def make_spec(self, shape: tuple[int, ...], dtype: Any, **kwargs: Any) -> ReductionSpec:
        """Build a canonical spec from loose kwargs (irrelevant ones dropped,
        missing ones defaulted, ``backend`` resolved)."""
        backend = adapters.resolve_backend(kwargs.pop("backend", None))
        params = {k: kwargs.get(k, d) for k, d in self.spec_defaults.items()}
        return ReductionSpec.create(self.name, shape, dtype, backend=backend, **params)

    # -- protocol ------------------------------------------------------------

    def plan(self, spec: ReductionSpec) -> ReductionPlan:
        """Build the persistent plan for ``spec`` (called once per CMM miss)."""
        raise NotImplementedError

    def encode_begin(
        self,
        plan: ReductionPlan,
        data: Any,
        *,
        env: Any = None,
        profile: dict | None = None,
    ) -> tuple[dict, Any]:
        """Phase 1 of a two-phase encode: run the forward pipeline only.

        Returns ``(state, env)`` with every array-scale product still on the
        plan's device; nothing has been fetched for the container yet.  The
        chunk-pipelined stream runs this on its compute lane while the
        previous chunk's :meth:`encode_finish` runs on the io lane.  (The
        reference also takes a per-slot ``workspace`` here, because XLA
        donates it; the port's stages only read the plan's workspace.)
        """
        return plan.pipeline.run(self.encode_input(plan, data), env=env, profile=profile)

    def encode_finish(
        self, plan: ReductionPlan, state: dict, env: Any, *, pinned: bool = False
    ) -> Compressed:
        """Phase 2: fetch the exact-sized sections and build the container.

        ``pinned=True`` copies each section from the card into page-locked
        host memory (the stream's io lane); the bytes are the same either way.
        The one-shot path keeps pageable memory: its caller may hold a
        container of any size for as long as it likes, and page-locked host
        memory is scarce.
        """
        from ..stages.base import LeafView  # local: codecs ↔ stages layering

        return self.finish_container(plan, env, LeafView(state, env, pinned=pinned))

    def encode(
        self,
        plan: ReductionPlan,
        data: Any,
        *,
        env: Any = None,
        profile: dict | None = None,
    ) -> Compressed:
        """Exactly :meth:`encode_begin` followed by :meth:`encode_finish`, so
        the stream's two-phase path writes the same bytes by construction."""
        state, env = self.encode_begin(plan, data, env=env, profile=profile)
        t0 = time.perf_counter()
        with span("codec.fetch"):
            c = self.encode_finish(plan, state, env)
        if profile is not None:  # the sections' copy to host memory
            profile["fetch"] = profile.get("fetch", 0.0) + time.perf_counter() - t0
        return c

    def decode(
        self,
        plan: ReductionPlan,
        c: Compressed,
        *,
        env: Any = None,
        profile: dict | None = None,
    ) -> torch.Tensor:
        """Run the inverse pipeline on the container's sections: exactly
        :meth:`decode_prepare` followed by :meth:`decode_prepared`."""
        state0, env = self.decode_prepare(plan, c, env=env, profile=profile)
        return self.decode_prepared(plan, c, state0, env, profile=profile)

    def decode_prepare(
        self,
        plan: ReductionPlan,
        c: Compressed,
        *,
        env: Any = None,
        profile: dict | None = None,
    ) -> tuple[dict, Any] | None:
        """The host half of :meth:`decode`: ``(state0, env)``, the
        container's sections that seed the inverse pipeline and the call's
        environment with every host stage's operands prepared.  ``None`` for
        a codec that decodes otherwise (it overrides :meth:`decode`), which
        a caller then decodes whole.  The stream's read-back runs this on
        its main thread and :meth:`decode_prepared` on its compute lane."""
        from ..stages.base import CallEnv  # local: codecs ↔ stages layering

        if plan.pipeline is None or type(self).decode is not Codec.decode:
            return None
        state0, meta = self.decode_state(plan, c)
        env = env if env is not None else CallEnv(plan)
        env.meta.update(meta)
        plan.pipeline.prepare(env, profile)
        return state0, env

    def decode_prepared(
        self,
        plan: ReductionPlan,
        c: Compressed,
        state0: dict,
        env: Any,
        *,
        profile: dict | None = None,
    ) -> torch.Tensor:
        """The device half of :meth:`decode`, after :meth:`decode_prepare`:
        the sections moved to the plan's device (one already there is taken
        as it lies), the device stages' inverses, the decoded tensor."""
        state, env = plan.pipeline.invert_prepared(state0, env, profile)
        return self.finish_decode(plan, env, state, c)

    def decode_spec(self, c: Compressed) -> ReductionSpec:
        """Spec keying the decode-side plan, recovered from container meta."""
        raise NotImplementedError

    def decode_bucket_key(self, c: Compressed) -> Any:
        """Per-stream decode geometry beyond the decode spec (hashable): the
        engine groups decode buckets by ``(decode spec, this key)``, as the
        reference does; ``None`` groups by spec alone."""
        return None

    @property
    def supports_batched_encode(self) -> bool:
        """Whether a bucket of same-spec leaves can run the stage graph's
        batched form (:meth:`CompiledPipeline.run_batched`)."""
        return type(self).build_stages is not Codec.build_stages

    @property
    def supports_batched_decode(self) -> bool:
        return type(self).decode_state is not Codec.decode_state

    def encode_input(self, plan: ReductionPlan, data: torch.Tensor) -> dict[str, Any]:
        """The pipeline's initial state for ``data`` (the input-policy hook:
        ``huffman-bytes`` takes a byte view here)."""
        return {"data": data}

    def decode_state(
        self, plan: ReductionPlan, c: Compressed
    ) -> tuple[dict[str, Any], dict[str, Any]]:
        """``(inverse state0, env meta)`` from the container: the sections
        that seed the inverse pipeline, and the metadata its host stages
        prepare from."""
        raise NotImplementedError

    def finish_decode(
        self, plan: ReductionPlan, env: Any, state: dict, c: Compressed
    ) -> torch.Tensor:
        """One leaf's decoded tensor from the inverse pipeline's state."""
        return state["data"]

    # -- stage graph ---------------------------------------------------------

    def build_stages(self, spec: ReductionSpec):
        """Return this codec's :class:`StageGraph`."""
        raise NotImplementedError

    def _attach_pipeline(self, plan: ReductionPlan) -> ReductionPlan:
        plan.pipeline = self.build_stages(plan.spec).compile(plan)
        return plan

    def finish_container(self, plan: ReductionPlan, env: Any, view: Any) -> Compressed:
        """Serialise one leaf's pipeline state into a container."""
        raise NotImplementedError
