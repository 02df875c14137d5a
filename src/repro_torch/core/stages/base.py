"""Stage-graph codec pipeline, eager PyTorch form (counterpart of
``repro.core.stages.base``, reduced to what the ported codecs need).

  * :class:`Stage` — one pipeline stage.  *Device* stages transform the
    flowing state (a dict of tensors on the plan's device) with ``apply``
    and, where they declare ``inv_writes``, ``invert``.  *Host* stages
    (``device = False``) are the graph's synchronisation points: in the
    encode direction they fetch exactly the state keys they name in
    ``fetches`` (metadata scale, counted as D2H) and ``host_apply`` fills
    the call's ``meta``, ``statics`` and ``operands``; in the decode
    direction ``host_prepare`` derives operands from the container's
    metadata, with no fetch from the device.
  * :class:`StageGraph` — a codec's stage composition; :meth:`describe` is
    the per-stage metadata recorded in the container header, the same
    layout the reference writes.
  * :class:`CompiledPipeline` — the graph bound to one plan.  PyTorch runs
    eagerly, so :meth:`~CompiledPipeline.run` and
    :meth:`~CompiledPipeline.invert` call the stages in order.
    :meth:`~CompiledPipeline.run_batched` and
    :meth:`~CompiledPipeline.invert_batched` drive a bucket of same-spec
    leaves for the execution engine: where the reference vmaps each fused
    device segment over the stacked leaves under ``shard_map``, the port
    stacks the leaves along a new leading axis on the plan's device and runs
    each stage that takes a stack (``Stage.stacks``) once over it, and loops
    every other stage over the leaves.  Each leaf's state, and so its
    container, is what a run of that leaf alone gives.  Fused segments and
    buffer donation have no PyTorch counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ...runtime.trace import span


def _nbytes(a: Any) -> int:
    return int(getattr(a, "nbytes", 0))


def _on_host(a: Any) -> bool:
    return isinstance(a, np.ndarray) or (
        isinstance(a, torch.Tensor) and a.device.type == "cpu"
    )


@dataclass
class TransferStats:
    """Host↔device byte accounting for one pipeline execution.

    Counts the bytes that cross between host memory and a CUDA plan's
    device: inputs staged in (``h2d``) and sections fetched for the
    container (``d2h``).  A plan on the CPU moves nothing and counts 0.
    """

    h2d: int = 0
    d2h: int = 0

    def count_h2d(self, *arrays: Any) -> None:
        self.h2d += sum(_nbytes(a) for a in arrays)

    def count_d2h(self, *arrays: Any) -> None:
        self.d2h += sum(_nbytes(a) for a in arrays)

    def as_dict(self) -> dict[str, int]:
        return {"h2d_bytes": self.h2d, "d2h_bytes": self.d2h}


class CallEnv:
    """Per-call environment threaded through one pipeline run: the plan's
    binding (``backend``, ``workspace``), the call's transfer counts, and
    what host stages produce for the rest of the call:

      * ``meta``     — per-call metadata for the container header;
      * ``operands`` — host-built arrays later device stages read (codebook
                       tables), shipped to the plan's device once per call
                       and counted as H2D (:meth:`operand`);
      * ``statics``  — python ints later stages need (the packed word
                       count, the alphabet size).

    ``graphs`` asks the stages that can for their device transforms replayed
    from CUDA graphs (``mgard.GraphedTransform``): the stream's lanes set it,
    where a chunk's launches would otherwise pace the lane.
    """

    __slots__ = ("plan", "spec", "meta", "operands", "statics", "transfers", "graphs")

    def __init__(self, plan: Any, transfers: TransferStats | None = None, *,
                 graphs: bool = False):
        self.plan = plan
        self.graphs = graphs
        self.spec = plan.spec
        self.meta: dict[str, Any] = {}
        self.operands: dict[str, Any] = {}
        self.statics: dict[str, int] = dict(plan.meta.get("statics", ()) or {})
        self.transfers = transfers if transfers is not None else TransferStats()

    @property
    def backend(self) -> str:
        return self.spec.backend

    def workspace(self, name: str) -> Any:
        return self.plan.workspace[name]

    def static(self, name: str) -> int:
        return self.statics[name]

    def operand(self, name: str) -> torch.Tensor:
        """Operand ``name`` on the plan's device (shipped on first use)."""
        val = self.operands[name]
        device = self.plan.device
        if isinstance(val, torch.Tensor) and val.device == device:
            return val
        if device.type != "cpu" and _on_host(val):
            self.transfers.count_h2d(val)
        out = _as_tensor(val).to(device)
        self.operands[name] = out
        return out


def _as_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v if v.flags.writeable else v.copy())
    return v


class Stage:
    """One named, composable pipeline stage.

    Device stages implement :meth:`apply` and, where ``inv_writes`` names
    what their inverse produces, :meth:`invert`; stages without an inverse
    (histograms, scans) are identities in the decode direction.  Host
    stages implement :meth:`host_apply` on the state keys they ``fetch``,
    and :meth:`host_prepare` for the decode direction.

    ``stage_meta`` is the stage's metadata contract: the static,
    plan-derived parameters recorded per stage in the container header.
    """

    name: str = "stage"
    device: bool = True
    fetches: tuple[str, ...] = ()      # host stages only
    inv_writes: tuple[str, ...] = ()   # device stages with an inverse
    stacks: bool = False               # takes same-shape leaves stacked on axis 0

    def planned(self, plan: Any) -> None:
        """Plan-time hook: record plan-constant statics/workspace/meta."""

    def apply(self, env: CallEnv, state: dict) -> dict:
        raise NotImplementedError(f"{self.name} is not a device stage")

    def invert(self, env: CallEnv, state: dict) -> dict:
        raise NotImplementedError(f"{self.name} has no inverse")

    def apply_stacked(self, env: CallEnv, state: dict) -> dict:
        """:meth:`apply` over a stack of leaves (every state tensor with a
        new leading leaf axis), for stages with ``stacks = True``."""
        raise NotImplementedError(f"{self.name} takes no stack")

    def invert_stacked(self, env: CallEnv, state: dict) -> dict:
        """:meth:`invert` over a stack of leaves."""
        raise NotImplementedError(f"{self.name} takes no stack")

    def host_apply(self, env: CallEnv, fetched: dict[str, np.ndarray]) -> None:
        raise NotImplementedError(f"{self.name} is not a host stage")

    def host_prepare(self, env: CallEnv) -> None:
        """Decode-direction preparation from ``env.meta`` (never a fetch)."""

    def stage_meta(self, plan: Any) -> dict[str, Any]:
        return {}


@dataclass(frozen=True)
class StageGraph:
    """A codec's stage composition, in encode order."""

    stages: tuple[Stage, ...]

    def compile(self, plan: Any) -> "CompiledPipeline":
        return CompiledPipeline(self, plan)

    def describe(self, plan: Any) -> list[dict]:
        """Per-stage metadata layout recorded in the container header."""
        out = []
        for st in self.stages:
            entry = {"stage": st.name, "kind": "device" if st.device else "host"}
            entry.update(st.stage_meta(plan))
            out.append(entry)
        return out


class CompiledPipeline:
    """A stage graph bound to one plan, run eagerly stage by stage."""

    def __init__(self, graph: StageGraph, plan: Any):
        self.graph = graph
        self.plan = plan
        for st in graph.stages:
            st.planned(plan)
        plan.meta.setdefault("stage_graph", graph.describe(plan))
        stages = graph.stages
        # the reference's segments: maximal runs of device stages between
        # host barriers (encode), and the one fused inverse run (decode)
        self.n_segments = sum(
            1 for i, st in enumerate(stages) if st.device and (i == 0 or not stages[i - 1].device))
        self.n_inv_segments = int(any(st.device and st.inv_writes for st in stages))
        # the leading stages that take a stack; the rest loop over the leaves
        self.n_stacked = 0
        while self.n_stacked < len(stages) and stages[self.n_stacked].device \
                and stages[self.n_stacked].stacks:
            self.n_stacked += 1

    def _stage_in(self, env: CallEnv, state0: dict[str, Any]) -> dict[str, torch.Tensor]:
        """Move the initial state onto the plan's device (counting H2D)."""
        device = self.plan.device
        state = {}
        for k, v in state0.items():
            if device.type != "cpu" and _on_host(v):
                env.transfers.count_h2d(v)
            state[k] = _as_tensor(v).to(device)
        return state

    def _timed(self, profile, name: str, fn, *args) -> dict:
        """``fn(*args)`` in the stage span ``stage.<name>``; with
        ``profile``, its wall seconds (the card synchronised) under ``name``."""
        with span("stage." + name):
            if profile is None:
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            if self.plan.device.type == "cuda":
                torch.cuda.synchronize(self.plan.device)
        profile[name] = profile.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    def run(
        self,
        state0: dict[str, Any],
        env: CallEnv | None = None,
        profile: dict[str, float] | None = None,
    ) -> tuple[dict[str, torch.Tensor], CallEnv]:
        """Execute the encode direction for one leaf.

        Device stages run in order; a host stage first fetches its declared
        keys (counted as D2H).  With ``profile``, wall seconds accumulate
        into it per stage, and under ``stage_in`` for moving the inputs onto
        the plan's device (device work is synchronised for honest timings).
        """
        env = env or CallEnv(self.plan)
        state = self._timed(profile, "stage_in", self._stage_in, env, state0)
        for st in self.graph.stages:
            if st.device:
                state.update(self._timed(profile, st.name, st.apply, env, state))
            else:
                self._timed(profile, st.name, self._host_step, st, env, state)
        return state, env

    @staticmethod
    def _host_step(st: Stage, env: CallEnv, state: dict) -> dict:
        fetched = {}
        if st.fetches:
            with span(f"stage.{st.name}.fetch"):  # where the host waits on the card
                for k in st.fetches:
                    v = state[k]
                    if v.device.type != "cpu":
                        env.transfers.count_d2h(v)
                    v = v.cpu()
                    # numpy has no bfloat16: its values are exact in float32
                    fetched[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        st.host_apply(env, fetched)
        return {}

    def invert(
        self,
        state0: dict[str, Any],
        env: CallEnv | None = None,
        profile: dict[str, float] | None = None,
    ) -> tuple[dict[str, torch.Tensor], CallEnv]:
        """Execute the decode direction for one leaf (container sections in).

        Host stages prepare first, from ``env.meta`` alone (no device
        fetch); then the inverses of the device stages that have one run in
        reverse order.
        """
        env = env or CallEnv(self.plan)
        self.prepare(env, profile)
        return self.invert_prepared(state0, env, profile)

    def prepare(self, env: CallEnv, profile: dict[str, float] | None = None) -> None:
        """The decode direction's host side: every host stage prepares its
        operands from ``env.meta`` (decode tables, bins)."""
        for st in self.graph.stages:
            if not st.device:
                self._timed(profile, st.name, st.host_prepare, env)

    def invert_prepared(
        self,
        state0: dict[str, Any],
        env: CallEnv,
        profile: dict[str, float] | None = None,
    ) -> tuple[dict[str, torch.Tensor], CallEnv]:
        """:meth:`invert` after :meth:`prepare` ran on ``env``: the sections
        moved to the plan's device (a section already there is taken as it
        lies, with no copy), then the device stages' inverses."""
        state = self._timed(profile, "stage_in", self._stage_in, env, state0)
        for st in reversed(self.graph.stages):
            if st.device and st.inv_writes:
                state.update(self._timed(profile, f"invert[{st.name}]", st.invert, env, state))
        return state, env

    # -- execution: a bucket of same-spec leaves (the engine's batched path) --

    @staticmethod
    def _stack(rows: list[dict]) -> dict[str, torch.Tensor]:
        """The leaves' state stacked along a new leading axis, every key
        whose tensors agree in shape (others stay per leaf)."""
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]
                if all(r[k].shape == rows[0][k].shape for r in rows)}

    def run_batched(self, states0: list[dict[str, Any]], envs: list[CallEnv]) -> list[dict]:
        """Execute the encode direction for a bucket of same-spec leaves.

        ``states0`` holds each leaf's initial state and ``envs`` its call
        environment.  The graph's leading stages that take a stack
        (``Stage.stacks``: ZFP's block transform, one kernel launch for the
        bucket) run once over the leaves stacked along a new axis 0 on the
        plan's device; every later stage loops over the leaves (MGARD's
        decomposition and quantization and the entropy tail, between host
        barriers that give each leaf its own bins, codebook and stream
        length).  Returns each leaf's final state, in order: what :meth:`run`
        of that leaf alone returns.
        """
        stages = self.graph.stages
        rows = [self._timed(None, "stage_in", self._stage_in, env, s0)
                for env, s0 in zip(envs, states0)]
        if self.n_stacked:
            stacked = self._stack(rows)
            for st in stages[: self.n_stacked]:
                stacked.update(self._timed(None, st.name, st.apply_stacked, envs[0], stacked))
            rows = [{k: v[i] for k, v in stacked.items()} for i in range(len(envs))]
        for env, row in zip(envs, rows):
            for st in stages[self.n_stacked:]:
                if st.device:
                    row.update(self._timed(None, st.name, st.apply, env, row))
                else:
                    self._timed(None, st.name, self._host_step, st, env, row)
        return rows

    def invert_batched(self, states0: list[dict[str, Any]], envs: list[CallEnv]) -> list[dict]:
        """Execute the decode direction for a bucket of same-spec leaves
        (``states0``: each container's sections; ``envs``: each call's
        environment holding its stream's metadata).  Host stages prepare per
        leaf; the inverses of the looping stages run leaf by leaf, then
        those of the stacking prefix once over the stacked leaves."""
        stages = self.graph.stages
        for env in envs:
            for st in stages:
                if not st.device:
                    self._timed(None, st.name, st.host_prepare, env)
        rows = [self._timed(None, "stage_in", self._stage_in, env, s0)
                for env, s0 in zip(envs, states0)]
        for env, row in zip(envs, rows):
            for st in reversed(stages[self.n_stacked:]):
                if st.device and st.inv_writes:
                    row.update(self._timed(None, f"invert[{st.name}]", st.invert, env, row))
        stacked_inv = [st for st in reversed(stages[: self.n_stacked]) if st.inv_writes]
        if stacked_inv:
            stacked = self._stack(rows)
            for st in stacked_inv:
                stacked.update(self._timed(None, f"invert[{st.name}]", st.invert_stacked,
                                           envs[0], stacked))
            rows = [{k: v[i] for k, v in stacked.items()} for i in range(len(envs))]
        return rows


class LeafView:
    """The container serialiser's window onto pipeline state.

    :meth:`fetch` copies one state tensor to a host numpy array, counting
    the bytes that leave a CUDA device.  With ``pinned=True`` (the chunk
    stream's io lane) a CUDA tensor is copied into page-locked memory.
    """

    def __init__(self, state: dict[str, Any], env: CallEnv, pinned: bool = False):
        self.state = state
        self.env = env
        self.pinned = pinned

    def fetch(self, key: str, length: int | None = None) -> np.ndarray:
        """State ``key`` on the host; with ``length``, only its first
        ``length`` entries, sliced on the device before the copy."""
        arr = self.state[key]
        if length is not None:
            arr = arr[:length]
        if arr.device.type == "cpu":
            return arr.numpy()
        self.env.transfers.count_d2h(arr)
        if not self.pinned:
            return arr.cpu().numpy()
        # Each fetch takes a block of its own from PyTorch's caching host
        # allocator, and the returned array (and any view the container
        # takes of it) keeps that block alive: no later chunk is handed
        # memory a container still reads.
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        host.copy_(arr, non_blocking=True)
        torch.cuda.current_stream(arr.device).synchronize()
        return host.numpy()
