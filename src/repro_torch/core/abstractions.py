"""Block helpers and the Map&Process parameter gather of the parallel
abstractions (counterpart of ``repro.core.abstractions``; only what the ZFP
and MGARD paths use is ported)."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def padded_shape(shape: Sequence[int], block_shape: Sequence[int]) -> tuple[int, ...]:
    return tuple(int(math.ceil(d / b)) * b for d, b in zip(shape, block_shape))


def pad_to_blocks(data: torch.Tensor, block_shape: Sequence[int]) -> torch.Tensor:
    """Pad every dim of ``data`` up to a multiple of ``block_shape`` by
    repeating its last element (the reference's ``edge`` mode).

    Done by gathering clamped indices along each padded dim, which behaves
    the same for any rank (``F.pad(mode="replicate")`` does not cover
    1-D through 4-D alike).
    """
    target = padded_shape(data.shape, block_shape)
    for dim, (d, t) in enumerate(zip(data.shape, target)):
        if t != d:
            idx = torch.arange(t, device=data.device).clamp_(max=d - 1)
            data = data.index_select(dim, idx)
    return data


def num_blocks(shape: Sequence[int], block_shape: Sequence[int]) -> int:
    return int(math.prod(math.ceil(d / b) for d, b in zip(shape, block_shape)))


def map_and_process_param(
    data: torch.Tensor, subset_ids: torch.Tensor, fn: Callable, params: torch.Tensor
) -> torch.Tensor:
    """Map&Process with one ``fn`` and per-subset parameters: ``params[k]``
    is gathered per element, then ``fn(data, param)`` runs densely (how
    MGARD applies its per-level bins without a pass per level)."""
    return fn(data, params[subset_ids])
