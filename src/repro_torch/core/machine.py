"""Block views of the group execution model (counterpart of
``repro.core.machine``; only the views the ZFP path uses are ported)."""

from __future__ import annotations

from typing import Sequence

import torch


def block_view(
    data: torch.Tensor, block_shape: Sequence[int]
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Reshape ``data`` into ``(num_blocks, *block_shape)`` (a contiguous copy).

    Requires every dim divisible by the block dim (pad first via
    ``abstractions.pad_to_blocks``).
    """
    bs = tuple(block_shape)
    if data.ndim != len(bs):
        raise ValueError(f"rank mismatch: data {tuple(data.shape)} vs block {bs}")
    counts = []
    for d, b in zip(data.shape, bs):
        if d % b:
            raise ValueError(f"dim {d} not divisible by block {b}; pad first")
        counts.append(d // b)
    # (c0, b0, c1, b1, ...) -> (c0, c1, ..., b0, b1, ...)
    interleaved = data.reshape(tuple(x for cb in zip(counts, bs) for x in cb))
    perm = tuple(range(0, 2 * len(bs), 2)) + tuple(range(1, 2 * len(bs), 2))
    blocked = interleaved.permute(perm)
    return blocked.reshape((-1,) + bs), tuple(counts)


def unblock_view(
    blocks: torch.Tensor, counts: tuple[int, ...], block_shape: tuple[int, ...]
) -> torch.Tensor:
    nd = len(block_shape)
    expanded = blocks.reshape(tuple(counts) + tuple(block_shape))
    perm = tuple(x for pair in zip(range(nd), range(nd, 2 * nd)) for x in pair)
    interleaved = expanded.permute(perm)
    full = tuple(c * b for c, b in zip(counts, block_shape))
    return interleaved.reshape(full)
