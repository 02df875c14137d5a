"""Tridiagonal mass-solve kernel on Hopper — launch wrapper for
``csrc/tridiag.cu``.

Counterpart of ``repro.kernels.tridiag.kernel.solve_mass`` (the Pallas TPU
kernel).  The CUDA source says what bounds it and how its design answers
that (tiles of systems swept in shared memory, each value read and written
once); this module checks what it is given, allocates the output, launches
on PyTorch's current stream and raises if the launch failed.

:func:`solve_columns` solves along axis -2 of a contiguous ``(n, B)`` or
``(P, n, Q)`` tensor, the view ``core.mgard.tridiag_solve_1d`` gives it of
any axis of a grid; :func:`solve_mass` keeps the reference's ``(N, n)``
layout, the view ``(N, n, 1)``.  Neither transposes.  A tensor on the CPU
goes to the plain sweep (:mod:`.ref`); a CUDA tensor launches the kernel or
raises — there is no fallback.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from ...core import mgard
from . import ref

launches = {"solve_mass": 0}

_SIGNATURES = {"tridiag_solve": [PTR, PTR, PTR, PTR, I64, INT, I64, ctypes.c_float, PTR]}


def reset_launches() -> None:
    launches["solve_mass"] = 0


def solve_columns(v: torch.Tensor, h: float,
                  coeffs: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Solve ``M x = v`` along axis -2 of ``v`` (float32, contiguous,
    ``(n, B)`` or ``(P, n, Q)``: system ``(p, q)`` is ``v[p, :, q]``);
    ``coeffs`` are the ``(cp, dinv)`` float32 tables of ``(n, h)`` on
    ``v``'s device (built for this call when missing).  Returns a contiguous
    tensor of ``v``'s shape."""
    if route(v, "tridiag"):
        return ref.sweep_columns(v, h, coeffs)
    if v.ndim not in (2, 3):
        raise ValueError(f"v must be (n, B) or (P, n, Q), got shape {tuple(v.shape)}")
    n = v.shape[-2]
    if not 1 <= n < (1 << 31):
        raise ValueError(f"the solve axis must have 1 to 2^31 - 1 nodes, got {n}")
    dev = v.device
    require(v, "v", torch.float32, tuple(v.shape), dev)
    cp, dinv = coeffs if coeffs is not None else mgard.thomas_tables(n, h, dev)
    require(cp, "cp", torch.float32, (n,), dev)
    require(dinv, "dinv", torch.float32, (n,), dev)
    out = torch.empty_like(v)
    p, q = (v.shape[0] if v.ndim == 3 else 1), v.shape[-1]
    if v.numel():
        rc = library("tridiag", _SIGNATURES).tridiag_solve(
            v.data_ptr(), out.data_ptr(), cp.data_ptr(), dinv.data_ptr(), p, n, q,
            mgard.thomas_sub(h), stream(dev),
        )
        raise_on(rc, "tridiag_solve")
        count_launch(launches, "solve_mass")
    return out


def solve_mass(rhs: torch.Tensor, h: float) -> torch.Tensor:
    """``(N, n)`` float32 — N independent systems — solved along axis 1."""
    if route(rhs, "tridiag"):
        return ref.solve_mass(rhs, h)
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be (N, n), got shape {tuple(rhs.shape)}")
    return solve_columns(rhs.contiguous().unsqueeze(-1), h).squeeze(-1)
