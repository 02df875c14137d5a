"""Error-feedback gradient compression for data parallelism across hosts
(counterpart of ``repro.optim.grad_compress``).

HPDR's insight applied to training: the cross-host gradient reduction is
the slowest collective of a data-parallel run, and its payload is the kind
of low-entropy float field the paper compresses.  ZFP-style fixed-rate
block quantization (a float32 scale per 256-value block from its largest
magnitude, int8/intN mantissas) is applied to the gradient *before* it
crosses the group:

  all-reduce(bf16 grads)  →  all-gather(int8 blocks + f32 scales) + local sum

and error feedback (the residual replayed into the next step) keeps SGD
unbiased in the limit.  The mantissas and scales are the reference's bit
for bit: ``round`` half to even, the scale ``where(absmax > 0, absmax /
qmax, 1.0)``, and XLA's flush of subnormal inputs and results done
explicitly (a block whose largest magnitude is below 2^-126 gets scale 1.0
and zero mantissas; one whose scale underflows gets scale 0.0, ±127 where
it holds a value and 0 where ``0 / 0`` is NaN).  Dequantized values go to
their dtype as XLA converts them (``float32_to``).

:func:`pod_compressed_mean` runs over a ``torch.distributed`` process
group (the reference's ``shard_map`` over the "pod" axis); on one card the
group has one rank.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.distributed as dist

from ..core.context import GLOBAL_CMM, ReductionContext, context_key
from ..core.stages.library import float32_to
from ..core.zfp import flush_subnormal

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def quantize_blocks(g: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 mantissas ``(nb, 256)``, float32 per-block scales ``(nb,)``)."""
    flat, _ = _pad_to_block(g)
    blocks = flush_subnormal(flat.reshape(-1, BLOCK).to(torch.float32))
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    qmax = float(2 ** (bits - 1) - 1)
    scale = flush_subnormal(torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax)))
    q = torch.clip(torch.round(blocks / scale), -qmax, qmax).nan_to_num_(0.0)
    return q.to(torch.int8), scale[:, 0]


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...],
                      dtype=torch.float32) -> torch.Tensor:
    vals = flush_subnormal(q.to(torch.float32) * scale[:, None])
    n = math.prod(shape)
    return float32_to(vals.reshape(-1)[:n].reshape(shape), dtype)


def _ef_core(grad: torch.Tensor, residual: torch.Tensor, bits: int):
    corrected = flush_subnormal(flush_subnormal(grad.to(torch.float32))
                                + flush_subnormal(residual))
    q, s = quantize_blocks(corrected, bits)
    approx = dequantize_blocks(q, s, tuple(grad.shape))
    return (q, s), flush_subnormal(corrected - approx)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _ef_plan(shape: tuple[int, ...], dtype: torch.dtype, bits: int):
    """The CMM-cached error-feedback plan, one per (shape, dtype, bits), under
    the reference's key: the optimizer's per-step gradient compression is
    the repeated same-characteristics reduction the paper's CMM targets.
    (The reference's plan is a jitted callable; eager PyTorch has nothing
    to compile, so the plan is the bound function.)"""
    key = context_key("grad-ef", shape, _dtype_name(dtype), bits=bits)

    def build():
        return ReductionContext(key=key, plan=partial(_ef_core, bits=bits))

    return GLOBAL_CMM.get_or_create(key, build).plan


def compress_decompress(g: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Round trip (for error-feedback residual computation)."""
    q, s = quantize_blocks(g, bits)
    return dequantize_blocks(q, s, tuple(g.shape), g.dtype)


def ef_step(grad: torch.Tensor, residual: torch.Tensor, bits: int = 8):
    """Error feedback: compress (grad + residual), return (compressed, new_residual)."""
    return _ef_plan(tuple(grad.shape), grad.dtype, bits)(grad, residual)


def pod_compressed_mean(grad: torch.Tensor, group=None, bits: int = 8) -> torch.Tensor:
    """Mean-reduce a gradient across ``group`` (default: the default process
    group) with a compressed payload: quantize locally, all-gather the int8
    mantissas and the float32 scales, reduce locally in float32."""
    q, s = quantize_blocks(grad, bits)
    world = dist.get_world_size(group)
    q_all = torch.empty((world * q.shape[0], BLOCK), dtype=q.dtype, device=q.device)
    s_all = torch.empty((world * s.shape[0],), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, s, group=group)
    vals = flush_subnormal(
        q_all.reshape(world, -1, BLOCK).to(torch.float32) * s_all.reshape(world, -1)[..., None])
    mean_blocks = flush_subnormal(vals.mean(dim=0))
    n = math.prod(grad.shape)
    return float32_to(mean_blocks.reshape(-1)[:n].reshape(grad.shape), grad.dtype)


def tree_pod_compressed_mean(grads, group=None, bits: int = 8):
    from ..core import api

    flat = dict(api.flatten_with_keys(grads))
    return api.unflatten_like(
        grads, lambda k: pod_compressed_mean(flat[k], group=group, bits=bits))
