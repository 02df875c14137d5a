"""Machine abstraction — HPDR §III-B: the GEM and DEM execution models
(counterpart of ``repro.core.machine``).

GEM (Group Execution Model): threads partitioned into independent groups;
a multi-stage GEM program stages its working data in a fast memory tier
between stages.  On the H100 a group is a CUDA thread block that stages its
block in shared memory, and the fused stages run inside one kernel body so
that intermediates never leave the SM.

DEM (Domain Execution Model): all threads in one synchronised domain; a
multi-stage DEM program shares its working data through HBM, with a global
synchronisation between stages: on the card, the whole grid, one kernel
(or one PyTorch operation) a stage, ordered on one CUDA stream.

PyTorch mapping
---------------
* GEM → the hand-written kernels in ``repro_torch/kernels/*/csrc/`` are that
  form: one CTA (or one thread) a block, its block staged in shared memory
  or registers (``zfp_block.cu``: persistent CTAs walking tiles of blocks
  fetched by bulk copies).  :func:`run_gem` is the generic path for any
  algorithm-defined ``f`` (paper Fig. 3a): :func:`block_view`, then the
  fused stages over the group axis with ``torch.vmap``, then
  :func:`unblock_view` where the stages keep the block shape.
* DEM → the composed stages over the whole tensor, each stage's result a
  tensor in HBM, the global sync the stream order of the stages.  The port
  runs eager: :func:`jitted_dem` caches the fused callable per program and
  compiles nothing (no ``torch.compile``).

These descriptors are what the parallel abstractions (``abstractions.py``)
lower to, mirroring Table I of the paper.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch


@dataclass(frozen=True)
class GEMProgram:
    """A (possibly multi-stage) group-execution program.

    ``stages`` are functions ``block -> block_like``; they are fused so that
    between-stage data stays with its group.  ``staging`` names the tier
    (shared memory on the card).
    """

    block_shape: tuple[int, ...]
    stages: tuple[Callable, ...]
    name: str = "gem"
    staging: str = "shared"

    def fused(self) -> Callable:
        def run(block, *args):
            out = block
            for stage in self.stages:
                out = stage(out, *args)
            return out

        return run


@dataclass(frozen=True)
class DEMProgram:
    """A (possibly multi-stage) domain-execution program over the whole tensor."""

    stages: tuple[Callable, ...]
    name: str = "dem"

    def fused(self) -> Callable:
        def run(data, *args):
            out = data
            for stage in self.stages:
                out = stage(out, *args)
            return out

        return run


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


def run_gem(prog: GEMProgram, data: torch.Tensor, *args, adapter: str | None = None):
    """Execute a GEM program: the fused stages mapped over the groups with
    ``torch.vmap``, where ``data`` lies.

    The hot-spot operations ship hand-written kernels (``repro_torch/kernels``)
    that their ``ops.py`` wrappers dispatch through the adapter registry;
    this generic executor runs any algorithm-defined ``f`` everywhere.
    """
    del adapter  # the generic executor is adapter-agnostic; kernels dispatch themselves
    blocks, counts = block_view(data, prog.block_shape)
    fused = prog.fused()
    out_blocks = torch.vmap(lambda b: fused(b, *args))(blocks)
    if tuple(out_blocks.shape[1:]) == tuple(prog.block_shape):
        return unblock_view(out_blocks, counts, prog.block_shape)
    return out_blocks  # a stage changed the block shape (e.g. block -> packed words)


def run_dem(prog: DEMProgram, data, *args):
    """Execute a DEM program: the fused stages over the whole domain."""
    return prog.fused()(data, *args)


@functools.cache
def jitted_dem(prog: DEMProgram) -> Callable:
    """The fused callable of ``prog``, cached per program (the reference's
    ``jax.jit``); eager, nothing is compiled."""
    return prog.fused()
