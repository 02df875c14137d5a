"""Device adapters — HPDR §III-C, in PyTorch (counterpart of ``repro.core.adapters``).

Two backends:

  * ``torch`` — the plain PyTorch versions of every op, on CPU tensors.  The
                tests' path and the oracle of the kernels.
  * ``cuda``  — the hand-written Hopper kernels, on CUDA tensors.

``auto`` resolves to ``cuda`` and raises where no CUDA device is present (the
reference's ``default_adapter`` picks XLA on a GPU).  :func:`dispatch`
raises ``KeyError`` for an op that no backend registers, as the reference
does, and ``NotImplementedError`` when the op lacks only the requested
backend (the reference silently falls back to its XLA implementation): a
kernel that is missing is an error, never a slow path.

The reference's ``supports_donation`` and ``donating_jit`` are XLA buffer
donation.  Eager PyTorch has nothing to donate, and the plans already
recycle their workspace in place, so they have no counterpart here.
"""

from __future__ import annotations

from typing import Callable

import torch

TORCH = "torch"
CUDA = "cuda"
AUTO = "auto"

ADAPTERS = (TORCH, CUDA)

_REGISTRY: dict[tuple[str, str], Callable] = {}


def register(op: str, adapter: str) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as the implementation of ``op`` under ``adapter``."""
    if adapter not in ADAPTERS:
        raise ValueError(f"unknown adapter {adapter!r}; expected one of {ADAPTERS}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, adapter)] = fn
        return fn

    return deco


def default_adapter() -> str:
    """The best backend here: ``cuda``, which raises without a card exactly
    as ``resolve_backend("auto")`` does."""
    return resolve_backend(AUTO)


def available_backends() -> tuple[str, ...]:
    """Backends that can execute here: ``torch`` always, ``cuda`` with a card."""
    return ADAPTERS if torch.cuda.is_available() else (TORCH,)


def resolve_backend(backend: str | None) -> str:
    """Resolve a spec-level backend request to a concrete, runnable backend.

    ``auto``/``None`` is ``cuda``; every request is validated against
    :func:`available_backends`, so a missing card fails loudly at plan time.
    """
    if backend is None or backend == AUTO:
        backend = CUDA
    if backend not in ADAPTERS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {(AUTO,) + ADAPTERS}"
        )
    if backend not in available_backends():
        raise ValueError(
            f"backend {backend!r} needs a CUDA device and torch.cuda.is_available() "
            f"is False; pass backend={TORCH!r} to run the plain versions on the CPU"
        )
    return backend


def device_for(backend: str) -> torch.device:
    """The device a plan bound to ``backend`` keeps its tensors on."""
    backend = resolve_backend(backend)
    if backend == CUDA:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def for_tensor(adapter: str | None, t: torch.Tensor) -> str:
    """``adapter``, or where none is given the backend of ``t``'s device:
    the kernel for a CUDA tensor, the plain version for a CPU tensor (the
    standalone entry points' rule)."""
    if adapter is not None:
        return adapter
    return CUDA if t.device.type == "cuda" else TORCH


def resolve(adapter: str | None) -> str:
    """The reference's name for :func:`resolve_backend`."""
    return resolve_backend(adapter)


def dispatch(op: str, adapter: str | None = None) -> Callable:
    """The registered implementation of ``op`` for ``adapter`` — or an error:
    ``KeyError`` for an op no backend registers, ``NotImplementedError`` for
    an op that lacks only this backend."""
    a = resolve_backend(adapter)
    impl = _REGISTRY.get((op, a))
    if impl is None:
        if not any(key == op for key, _ in _REGISTRY):
            raise KeyError(f"op {op!r} has no implementation (adapter={a!r})")
        raise NotImplementedError(f"op {op!r} has no {a!r} implementation")
    return impl


def registered_ops() -> dict[tuple[str, str], Callable]:
    """A copy of the registry: ``(op, backend) -> implementation``."""
    return dict(_REGISTRY)

