"""Plain PyTorch version of the tridiag kernel (the CUDA kernel's oracle and
the CPU path of ``core.mgard.tridiag_solve_1d``; counterpart of
``repro.kernels.tridiag.ref``).

The Thomas sweep is a Python loop over the solve axis, in the reference's
exact float32 operation order (``d = (r - sub * d_prev) * dinv``, then
``x = d - cp * x_next``), one separate tensor operation each, so no device
contracts a pair into an FMA.
"""

from __future__ import annotations

import torch

from ...core import mgard


def sweep_columns(v: torch.Tensor, h: float,
                  coeffs: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Solve ``M x = v`` along axis 0 of ``v`` (``(n, ...)`` float32); every
    other axis is a batch of independent systems."""
    n = v.shape[0]
    cp, dinv = coeffs if coeffs is not None else mgard.thomas_tables(n, h, v.device)
    sub = mgard.thomas_sub(h)
    out = torch.empty_like(v)
    d = torch.zeros_like(v[0])
    for i in range(n):
        d = (v[i] - sub * d) * dinv[i]
        out[i] = d
    x = torch.zeros_like(v[0])
    for i in range(n - 1, -1, -1):
        x = out[i] - cp[i] * x
        out[i] = x
    return out


def solve_mass(rhs: torch.Tensor, h: float) -> torch.Tensor:
    """``(N, n)`` float32 — N independent systems — solved along axis 1."""
    return sweep_columns(rhs.t(), h).t()
