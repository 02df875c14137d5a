"""Stage-graph codec pipeline, eager PyTorch form (counterpart of
``repro.core.stages.base``, reduced to what the ported codecs need).

  * :class:`Stage` — one pipeline stage, with ``apply``/``invert`` on the
    flowing state (a dict of tensors on the plan's device).
  * :class:`StageGraph` — a codec's stage composition; :meth:`describe` is
    the per-stage metadata recorded in the container header, the same
    layout the reference writes.
  * :class:`CompiledPipeline` — the graph bound to one plan.  PyTorch runs
    eagerly, so :meth:`~CompiledPipeline.run` and
    :meth:`~CompiledPipeline.invert` call the stages in order.  Host stages,
    fused-segment tracing, batched runs and buffer donation are not ported
    yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


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
    binding (``backend``, ``workspace``) and the call's transfer counts."""

    __slots__ = ("plan", "spec", "transfers")

    def __init__(self, plan: Any, transfers: TransferStats | None = None):
        self.plan = plan
        self.spec = plan.spec
        self.transfers = transfers if transfers is not None else TransferStats()

    @property
    def backend(self) -> str:
        return self.spec.backend

    def workspace(self, name: str) -> torch.Tensor:
        return self.plan.workspace[name]


class Stage:
    """One named, composable pipeline stage.

    ``stage_meta`` is the stage's metadata contract: the static,
    plan-derived parameters recorded per stage in the container header.
    """

    name: str = "stage"
    device: bool = True

    def apply(self, env: CallEnv, state: dict) -> dict:
        raise NotImplementedError(f"{self.name} has no forward direction")

    def invert(self, env: CallEnv, state: dict) -> dict:
        raise NotImplementedError(f"{self.name} has no inverse")

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
        plan.meta.setdefault("stage_graph", graph.describe(plan))

    def _stage_in(self, env: CallEnv, state0: dict[str, Any]) -> dict[str, torch.Tensor]:
        """Move the initial state onto the plan's device (counting H2D)."""
        device = self.plan.device
        state = {}
        for k, v in state0.items():
            if device.type != "cpu" and _on_host(v):
                env.transfers.count_h2d(v)
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v if v.flags.writeable else v.copy())
            state[k] = v.to(device)
        return state

    def _timed(self, profile, name: str, fn, *args) -> dict:
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

        With ``profile``, wall seconds accumulate into it per stage, and
        under ``stage_in`` for moving the inputs onto the plan's device
        (device work is synchronised for honest timings).
        """
        env = env or CallEnv(self.plan)
        state = self._timed(profile, "stage_in", self._stage_in, env, state0)
        for st in self.graph.stages:
            state.update(self._timed(profile, st.name, st.apply, env, state))
        return state, env

    def invert(
        self,
        state0: dict[str, Any],
        env: CallEnv | None = None,
        profile: dict[str, float] | None = None,
    ) -> tuple[dict[str, torch.Tensor], CallEnv]:
        """Execute the decode direction for one leaf (container sections in),
        the stages' inverses in reverse order."""
        env = env or CallEnv(self.plan)
        state = self._timed(profile, "stage_in", self._stage_in, env, state0)
        for st in reversed(self.graph.stages):
            state.update(self._timed(profile, f"invert[{st.name}]", st.invert, env, state))
        return state, env


class LeafView:
    """The container serialiser's window onto pipeline state.

    :meth:`fetch` copies one state tensor to a host numpy array, counting
    the bytes that leave a CUDA device.
    """

    def __init__(self, state: dict[str, Any], env: CallEnv):
        self.state = state
        self.env = env

    def fetch(self, key: str) -> np.ndarray:
        arr = self.state[key]
        if arr.device.type != "cpu":
            self.env.transfers.count_d2h(arr)
        return arr.cpu().numpy()
