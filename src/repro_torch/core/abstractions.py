"""Parallel abstractions — HPDR §III-A (Fig. 3), in PyTorch (counterpart of
``repro.core.abstractions``).

Four abstractions through which reduction algorithms express fine-grain
parallelism, with the paper's Table I mapping onto the execution models of
``machine.py`` (Locality/Iterative → GEM, Map&Process/Global → DEM):

  locality        block-wise f over (optionally halo'd) blocks     → GEM
  iterative       sequential f along one axis, batched over vectors → GEM
  map_and_process per-subset functions over a decomposed hierarchy  → DEM
  global_pipeline whole-domain multi-stage program                  → DEM

Each runs where its input lies; a user's ``fn`` sees tensors on that device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from .machine import DEMProgram, GEMProgram, run_dem, run_gem, unblock_view

# ---------------------------------------------------------------------------
# block helpers
# ---------------------------------------------------------------------------


def padded_shape(shape: Sequence[int], block_shape: Sequence[int]) -> tuple[int, ...]:
    return tuple(int(math.ceil(d / b)) * b for d, b in zip(shape, block_shape))


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of a dim of ``n`` edge-padded by ``lo`` before and ``hi`` after."""
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


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
            data = data.index_select(dim, _edge_index(d, 0, t - d, data.device))
    return data


def num_blocks(shape: Sequence[int], block_shape: Sequence[int]) -> int:
    return int(math.prod(math.ceil(d / b) for d, b in zip(shape, block_shape)))


def _crop(out: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return out[tuple(slice(0, d) for d in shape)]


# ---------------------------------------------------------------------------
# 1) Locality abstraction  (paper Fig. 3a)
# ---------------------------------------------------------------------------


def locality(
    data: torch.Tensor,
    fn: Callable,
    block_shape: Sequence[int],
    *args,
    halo: int = 0,
    name: str = "locality",
):
    """Apply ``fn`` cooperatively to each block of ``block_shape``.

    Every dim is edge-padded up to the block and the result cropped back.
    Blocks map 1:1 to GEM groups (Table I); the hot-spot operations have
    hand-written kernels with the same block decomposition.  ``halo``
    extends each block read-only by ``halo`` elements a side (MGARD's lerp
    needs coarse-node neighbours): the padded field is edge-padded by
    ``halo`` on every side and ``fn`` maps over one ``(b + 2·halo)^d`` patch
    a block, in row-major block order.  Where ``fn`` keeps the block shape
    the blocks are laid back into the field; otherwise they come back as
    they are, ``(num_blocks, ...)``.
    """
    block_shape = tuple(block_shape)
    padded = pad_to_blocks(data, block_shape)
    if halo == 0:
        prog = GEMProgram(block_shape=block_shape, stages=(fn,), name=name)
        out = run_gem(prog, padded, *args)
        if tuple(out.shape) == tuple(padded.shape):
            return _crop(out, data.shape)
        return out
    # halo path: every patch gathered at once (one unfold a dim)
    halo_pad = padded
    for dim, n in enumerate(padded.shape):
        halo_pad = halo_pad.index_select(dim, _edge_index(n, halo, halo, data.device))
    counts = tuple(p // b for p, b in zip(padded.shape, block_shape))
    patches = halo_pad
    for dim, b in enumerate(block_shape):
        patches = patches.unfold(dim, b + 2 * halo, b)  # (c..., p...) after every dim
    patch_shape = tuple(b + 2 * halo for b in block_shape)
    patches = patches.reshape((-1,) + patch_shape)
    out_blocks = torch.vmap(lambda p: fn(p, *args))(patches)
    if tuple(out_blocks.shape[1:]) == block_shape:
        return _crop(unblock_view(out_blocks, counts, block_shape), data.shape)
    return out_blocks


# ---------------------------------------------------------------------------
# 2) Iterative abstraction  (paper Fig. 3b)
# ---------------------------------------------------------------------------


def iterative(
    data: torch.Tensor,
    step: Callable,
    init_carry,
    axis: int,
    reverse: bool = False,
):
    """Run ``step`` sequentially along ``axis``, in parallel over all other dims.

    ``step(carry, x_slice) -> (carry, y_slice)`` where ``x_slice`` is the
    data with ``axis`` removed; the carry may be a tensor or a tuple or dict
    of tensors.  This is the B-vectors-per-group pattern (the paper's B:1
    vector→group mapping): every other axis is a batch lane of each step.
    The steps run in Python, one a slice (the reference's ``lax.scan``);
    with ``reverse=True`` the slices are visited last to first and
    ``ys[i]`` still belongs to ``xs[i]``.  Returns ``(carry, ys)`` with the
    ys stacked back on ``axis``.
    """
    moved = data.movedim(axis, 0)
    n = moved.shape[0]
    ys: list = [None] * n
    carry = init_carry
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        carry, ys[i] = step(carry, moved[i])
    flat = [pytree.tree_flatten(y) for y in ys]
    spec = flat[0][1]
    leaves = [torch.stack([f[0][j] for f in flat]).movedim(0, axis)
              for j in range(len(flat[0][0]))]
    return carry, pytree.tree_unflatten(leaves, spec)


# ---------------------------------------------------------------------------
# 3) Map & Process abstraction  (paper Fig. 3c)
# ---------------------------------------------------------------------------


def map_and_process(
    data: torch.Tensor,
    subset_ids: torch.Tensor,
    fns: Sequence[Callable],
):
    """Map elements to subsets, then process each subset with its own fn.

    Every ``fn`` is evaluated on the whole tensor and the results are
    combined with subset masks (the reference's masked-dense idiom), so a
    ``fn`` that is not elementwise (a mean, a stencil) sees the same input
    it sees there; a per-subset gather would change its result.  An id
    outside ``[0, K)`` keeps ``fns[0]``'s value.
    """
    out = None
    for k, fn in enumerate(fns):
        val = fn(data)
        out = torch.where(subset_ids == k, val, out if out is not None else val)
    return out


def map_and_process_param(
    data: torch.Tensor, subset_ids: torch.Tensor, fn: Callable, params: torch.Tensor
) -> torch.Tensor:
    """Map&Process with one ``fn`` and per-subset parameters: ``params[k]``
    is gathered per element, then ``fn(data, param)`` runs densely (how
    MGARD applies its per-level bins without a pass per level)."""
    return fn(data, params[subset_ids])


# ---------------------------------------------------------------------------
# 4) Global pipeline abstraction  (paper Fig. 3d)
# ---------------------------------------------------------------------------


def global_pipeline(*stages: Callable, name: str = "global"):
    """Whole-domain multi-stage program with a global sync between stages (DEM)."""
    prog = DEMProgram(stages=tuple(stages), name=name)

    def run(data, *args):
        return run_dem(prog, data, *args)

    return run
