"""Fields made from the seed, on the device, as the configuration describes them.

``nyx_like`` is a smooth, positive, skewed stand-in for a cosmology density
snapshot: ``exp(sin x cos y sin z + 0.5 sin(2x + 1) cos 3z + 0.05 N(0, 1))``
on ``linspace(0, 8 pi, n)`` along each dim of ``n`` nodes.  Each field of a
configuration draws its noise from a sub-seed of its own, on a
``torch.Generator`` on the device, in one call, so a seed gives the same
fields on every run.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, index: int) -> int:
    """A 63-bit seed for field ``index`` of run ``seed`` (any integer seed)."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def nyx_like(shape: tuple[int, int, int], seed: int, device, noise: float = 0.05) -> torch.Tensor:
    """One float32 field of ``shape`` on ``device``."""
    x, y, z = (torch.linspace(0.0, 8.0 * math.pi, n, device=device, dtype=torch.float32)
               for n in shape)
    x, y, z = x[:, None, None], y[None, :, None], z[None, None, :]
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    f.mul_(noise)
    f.add_(torch.sin(x) * torch.cos(y) * torch.sin(z))
    f.add_(0.5 * torch.sin(2.0 * x + 1.0) * torch.cos(3.0 * z))
    return f.exp_()


GENERATORS = {"nyx_like": nyx_like}


def make_fields(data: dict, seed: int, device) -> list[torch.Tensor]:
    """The configuration's fields (``data``: its ``"data"`` entry) for ``seed``."""
    make = GENERATORS[data["generator"]]
    params = dict(data.get("params", {}))
    return [make(tuple(int(n) for n in data["shape"]), sub_seed(seed, i), device, **params)
            for i in range(len(data["fields"]))]
