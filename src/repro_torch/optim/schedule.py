"""LR schedules: cosine (default) and WSD (MiniCPM, arXiv:2404.06395)
(counterpart of ``repro.optim.schedule``).

WSD — Warmup-Stable-Decay: linear warmup → constant plateau → short
exponential decay tail; the schedule MiniCPM's data-scaling law study
depends on.

Both compute in float32 tensors, as the reference does
(``jnp.asarray(step, jnp.float32)``): Python's float64 arithmetic would
give other learning rates.  The one exception is the cosine itself
(:func:`_cos`).  ``step`` may be an int or a
tensor (the optimizer's step counter on the card); the result is a 0-d
float32 tensor on the step's device.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(_F32)
    return torch.tensor(step, dtype=_F32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine of a float32 argument, rounded from float64: XLA's
    float32 ``cos`` is nearly correctly rounded (torch's CPU and CUDA ones
    are each off in other last bits), so this gives the reference's value
    but for rare last-bit cases, and the same one on the CPU and the card."""
    return torch.cos(x.double()).to(_F32)


def cosine(step, *, peak_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + _cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_fraction: float = 0.1, min_ratio: float = 0.01):
    step = _step(step)
    decay_steps = torch.tensor(max(total * decay_fraction, 1.0), dtype=_F32,
                               device=step.device)
    decay_start = total - decay_steps
    warm = peak_lr * step / max(warmup, 1)
    stable = torch.full_like(warm, peak_lr)
    prog = torch.clip((step - decay_start) / decay_steps, 0.0, 1.0)
    decay = peak_lr * torch.pow(torch.tensor(min_ratio, dtype=_F32, device=step.device), prog)
    out = torch.where(step < warmup, warm, stable)
    return torch.where(step >= decay_start, decay, out)


SCHEDULES = {"cosine": cosine, "wsd": wsd}
