"""Fault tolerance for training runs, over pytrees of tensors (counterpart of
``repro.runtime.fault``).

  * **Checkpoint/restart** — committed-marker checkpoints through the
    HPDR-compressed manager (:mod:`repro_torch.checkpoint`).
  * **Preemption safety** — SIGTERM triggers a synchronous save before exit
    (:func:`install_preemption_handler`).
  * **Straggler mitigation** — a watchdog tracks the step times and flags a
    step slower than ``threshold ×`` the median (:class:`StragglerWatchdog`).
  * **In-graph failure containment** — an update whose gradients hold a
    NaN or an infinity is skipped rather than poisoning the weights
    (:func:`skip_nonfinite_update`).

Pytrees are the nested ``dict``/``list``/``tuple`` structures the port's
``api.flatten_with_keys`` walks.
"""

from __future__ import annotations

import signal
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    window: int = 50
    history: deque = field(default_factory=lambda: deque(maxlen=200))
    flagged: int = 0

    def observe(self, step_time: float) -> bool:
        self.history.append(step_time)
        if len(self.history) < 10:
            return False
        med = sorted(self.history)[len(self.history) // 2]
        slow = step_time > self.threshold * med
        if slow:
            self.flagged += 1
        return slow


def install_preemption_handler(save_fn: Callable[[], None]) -> None:
    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)


def all_finite(grads: Any) -> torch.Tensor:
    """0-d bool on the gradients' device: every gradient finite.  Placed
    gradients (DTensors) are checked on each rank's block and the verdict
    is shared: finite on every rank only if on all."""
    from ..core import api
    from .sharding import is_placed

    leaves = [g for _k, g in api.flatten_with_keys(grads)]
    placed = [g for g in leaves if is_placed(g)]
    leaves = [g.to_local() if is_placed(g) else g for g in leaves]
    device = leaves[0].device if leaves else torch.device("cpu")
    finite = torch.ones((), dtype=torch.bool, device=device)
    for g in leaves:
        finite &= torch.isfinite(g.to(torch.float32)).all()
    if placed:
        from torch.distributed.tensor import DTensor, Partial

        mesh = placed[0].device_mesh
        bad = DTensor.from_local((~finite).to(torch.int32), mesh, [Partial()] * mesh.ndim)
        finite = bad.full_tensor() == 0
    return finite


def skip_nonfinite_update(new_params: Any, old_params: Any, grads: Any):
    """Keep ``old_params`` when any gradient is non-finite (SDC containment).

    Returns ``(params, finite)``: the new parameters where every gradient
    is finite, else the old ones, and a 0-d bool tensor.  Like the
    reference, the check and the choice stay on the device (no host sync).
    """
    from ..core import api

    finite = all_finite(grads)
    old = dict(api.flatten_with_keys(old_params))
    new = dict(api.flatten_with_keys(new_params))
    picked = api.unflatten_like(
        new_params, lambda k: torch.where(finite, new[k], old[k]))
    return picked, finite
