"""ZFP's fixed-point scale tables, worked out from the format's formula.

The format scales a block by ``exp2(30 - emax)`` on encode and by
``exp2(emax - 30)`` on decode, with ``exp2(x)`` evaluated as
``exp(0.693147182 * x)`` in float32: the product rounded to float32, its
exponential rounded to float32, and a result below float32's smallest normal
flushed to zero.  That is not an exact power of two at most exponents
(``exp2(30)`` is 1073740860, not 2^30), and the payload bytes depend on it,
so the reference does not compute ``ldexp``.  Entry ``i`` of a table is the
value for ``emax = EMIN + i``; both tables saturate (to ``inf`` or 0) before
their ends, so clamping ``emax`` into ``[EMIN, EMAX]`` gives the format's value.

The program carries the same tables as constants, checked entry by entry
against JAX's ``exp2`` in its own tests; ``hpdr_bench/tests/test_bench_reference.py``
holds these against them, every entry of both.
"""

from __future__ import annotations

import numpy as np
import torch

EMIN = -160
EMAX = 191
LN2 = np.float32(0.693147182)


def scale_values(sign: int) -> np.ndarray:
    """``exp2(sign * (emax - 30))`` as the format evaluates it, for every
    ``emax`` of ``[EMIN, EMAX]``: ``sign`` -1 is the encode table, +1 decode."""
    x = (sign * (np.arange(EMIN, EMAX + 1) - 30)).astype(np.float32)
    with np.errstate(over="ignore"):
        v = np.exp((LN2 * x).astype(np.float64)).astype(np.float32)
    v[v < np.finfo(np.float32).tiny] = 0.0
    return v


def scale_table(sign: int, device) -> torch.Tensor:
    """A table (``scale_values``) as a float32 tensor on ``device``."""
    return torch.from_numpy(scale_values(sign)).to(device)


def table_index(emax: torch.Tensor) -> torch.Tensor:
    """Row of each ``emax`` in a scale table (clamped: the tables saturate)."""
    return emax.to(torch.int64).clamp(EMIN, EMAX) - EMIN
