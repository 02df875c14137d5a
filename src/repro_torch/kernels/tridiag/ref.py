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
    """Solve ``M x = v`` along axis -2 of ``v`` (``(n, B)`` or ``(P, n, Q)``
    float32, the kernel's views); every other axis is a batch of
    independent systems.  Returns a contiguous tensor of ``v``'s shape."""
    n = v.shape[-2]
    cp, dinv = coeffs if coeffs is not None else mgard.thomas_tables(n, h, v.device)
    sub = mgard.thomas_sub(h)
    r = v.movedim(-2, 0)
    out = torch.empty_like(r)
    d = torch.zeros_like(r[0])
    for i in range(n):
        d = (r[i] - sub * d) * dinv[i]
        out[i] = d
    x = torch.zeros_like(r[0])
    for i in range(n - 1, -1, -1):
        x = out[i] - cp[i] * x
        out[i] = x
    return out.movedim(0, -2).contiguous()


def solve_mass(rhs: torch.Tensor, h: float) -> torch.Tensor:
    """``(N, n)`` float32 — N independent systems — solved along axis 1."""
    return sweep_columns(rhs.unsqueeze(-1), h).squeeze(-1)
