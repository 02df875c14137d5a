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


def _reflect_index(n: int, p: int, symmetric: bool) -> list[int]:
    """Indices of a dim of ``n`` padded by ``p`` after it in ``reflect`` or
    ``symmetric`` mode.  Past one reflection the pattern repeats on the grown
    dim, as ``jnp.pad`` (and numpy) build it: a dim of one element repeats it."""
    idx = list(range(n))
    offset = 1 if (not symmetric and n > 1) else 0
    while p > 0:
        cur = min(p, n - offset)
        p -= cur
        stop = len(idx) if (symmetric or n == 1) else len(idx) - 1
        idx += idx[len(idx) - cur - offset:stop][::-1]
    return idx


def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The float dtype ``jnp`` computes a statistic of ``dtype`` in (float32
    for integers, as JAX without 64-bit types promotes them)."""
    return dtype if dtype.is_floating_point else torch.float32


def _index_pad(x: torch.Tensor, dim: int, idx) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(idx, dtype=torch.long, device=x.device))


def _fill(x: torch.Tensor, dim: int, p: int, value: torch.Tensor) -> torch.Tensor:
    """``x`` followed along ``dim`` by ``p`` copies of ``value`` (size 1 on ``dim``)."""
    shape = list(x.shape)
    shape[dim] = p
    return torch.cat([x, value.to(x.dtype).expand(shape)], dim)


def _stat_fill(x: torch.Tensor, dim: int, p: int, stat: torch.Tensor) -> torch.Tensor:
    if stat.dtype.is_floating_point and not x.dtype.is_floating_point:
        stat = torch.round(stat)  # jnp rounds a statistic of integers half to even
    return _fill(x, dim, p, stat)


def _pad_mean(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """The mean as XLA's CPU reduction gives it on an axis of up to 32: the
    sum in index order, times the reciprocal of the count.  An elementwise
    loop, so a card gives the CPU's bits; on a longer axis XLA sums in
    another order and the two may differ in the last place."""
    comp = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) else _inexact(x.dtype)
    v = x.to(comp)
    n = x.shape[dim]
    acc = v.narrow(dim, 0, 1)
    for i in range(1, n):
        acc = acc + v.narrow(dim, i, 1)
    return _stat_fill(x, dim, p, acc * (torch.ones((), dtype=comp, device=x.device) / n))


def _pad_median(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """``jnp.median``: the midpoint of the two middle sorted values, NaN
    where the axis holds one."""
    v = x.to(_inexact(x.dtype))
    n = x.shape[dim]
    s = v.sort(dim).values
    mid = (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1)) * 0.5
    nan = torch.isnan(v).any(dim, keepdim=True)
    return _stat_fill(x, dim, p, torch.where(nan, torch.full_like(mid, float("nan")), mid))


def _pad_linear_ramp(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """``jnp.linspace(0, edge, p, endpoint=False)`` reversed: from next to
    the edge value down to 0, in the float type of ``x`` (float32 for
    integers, then floored)."""
    comp = _inexact(x.dtype)
    edge = x.narrow(dim, x.shape[dim] - 1, 1).to(comp)
    start = torch.zeros_like(edge)
    if p == 1:
        ramp = start
    else:
        shape = [1] * x.dim()
        shape[dim] = p
        step = (torch.arange(p, dtype=comp, device=x.device) / p).reshape(shape)
        ramp = start * (1 - step) + edge * step
    if not x.dtype.is_floating_point:
        ramp = torch.floor(ramp)
    return torch.cat([x, ramp.to(x.dtype).flip(dim)], dim)


def _zeros(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    return _fill(x, dim, p, x.new_zeros(()))


# mode -> pad(x, dim, p): ``x`` followed by ``p`` elements along ``dim``,
# each as ``jnp.pad`` builds them with no extra keyword (``empty`` is zeros there)
_PADS = {
    "constant": _zeros,
    "edge": lambda x, dim, p: _index_pad(x, dim, _edge_index(x.shape[dim], 0, p, x.device)),
    "reflect": lambda x, dim, p: _index_pad(x, dim, _reflect_index(x.shape[dim], p, False)),
    "symmetric": lambda x, dim, p: _index_pad(x, dim, _reflect_index(x.shape[dim], p, True)),
    "wrap": lambda x, dim, p: _index_pad(
        x, dim, torch.arange(x.shape[dim] + p, device=x.device) % x.shape[dim]),
    "maximum": lambda x, dim, p: _stat_fill(x, dim, p, x.amax(dim, keepdim=True)),
    "minimum": lambda x, dim, p: _stat_fill(x, dim, p, x.amin(dim, keepdim=True)),
    "mean": _pad_mean,
    "median": _pad_median,
    "linear_ramp": _pad_linear_ramp,
    "empty": _zeros,
}


def pad_to_blocks(
    data: torch.Tensor, block_shape: Sequence[int], mode: str = "edge"
) -> torch.Tensor:
    """Pad every dim of ``data`` up to a multiple of ``block_shape``, at its
    high end, as ``jnp.pad(data, pad, mode=mode)`` pads it.

    ``edge`` (the default) repeats the last element, which keeps block
    statistics (max exponent, value range) close to the real data so padded
    blocks stay compressible, the same choice as zfp's partial-block
    extension.  ``constant`` pads zeros and ``linear_ramp`` ramps to 0; the
    statistics (``maximum``, ``minimum``, ``mean``, ``median``) are taken
    over the whole dim.  The dims are padded in order, each over the result
    of the ones before, as ``jnp.pad`` does.  Any other mode raises
    ``ValueError``.
    """
    pad = _PADS.get(mode)
    if pad is None:
        raise ValueError(f"pad_to_blocks: unsupported mode {mode!r}; one of {sorted(_PADS)}")
    target = padded_shape(data.shape, block_shape)
    for dim, (d, t) in enumerate(zip(data.shape, target)):
        if t != d:
            data = pad(data, dim, t - d)
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
    ys stacked back on ``axis``.  Over an axis of length 0 the carry comes
    back as given and every y is an empty stack: ``step`` is called once on
    a zero slice to learn the ys' structure, dtypes and shapes, as
    ``lax.scan`` traces it once.
    """
    moved = data.movedim(axis, 0)
    n = moved.shape[0]
    if n == 0:
        _, y = step(init_carry, moved.new_zeros(moved.shape[1:]))
        leaves, spec = pytree.tree_flatten(y)
        return init_carry, pytree.tree_unflatten(
            [leaf.new_empty((0,) + tuple(leaf.shape)).movedim(0, axis) for leaf in leaves], spec)
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
