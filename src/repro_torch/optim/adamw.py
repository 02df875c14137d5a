"""AdamW over pytrees of tensors (counterpart of ``repro.optim.adamw``).

State mirrors the parameter tree: ``{"m": tree, "v": tree, "step": 0-d
int32}``, the moments in ``moment_dtype`` (``"bfloat16"`` halves the
optimizer's memory).  The arithmetic is the reference's, in float32 and in
its order: the global-norm clip ``scale``, ``bc1``/``bc2`` from ``b **
step`` in float32, then per leaf ``g·scale``, ``m``, ``v``, ``m̂/(√v̂ + eps)
+ wd·p`` and ``p − lr·delta``.  XLA flushes subnormal inputs and results to
zero (DAZ / FTZ); the port does so explicitly wherever a product or sum
can land below 2^-126: the norm's squares, ``b1·m``, ``(1 − b1)·g``,
``b2·v``, ``(1 − b2)·g²`` and m's sum.  (``g·scale`` and ``g²`` need no
flush of their own: each is multiplied by a factor below one and flushed
after, which gives the reference's zero of the same sign; nor does v's
sum, of two terms that are each +0 or at least 2^-126.)

Two forms:

* :func:`apply_updates` returns new trees, as the reference does (it keeps
  the parity tests simple);
* :func:`apply_updates_` updates the parameters, the moments and the step
  in place, one leaf at a time, with one temporary the size of a leaf
  (three with bfloat16 moments).  The reference's new trees cost nothing
  extra because XLA donates the old buffers; eagerly, a second set of
  parameters and moments beside the first (37 GB at qwen2.5-3b) would not
  fit on the card beside the gradients.  It also takes the reference's non-finite guard
  (``fault.skip_nonfinite_update``) into the update: ``finite`` comes from
  the gradients before anything changes, the moments and the step advance
  always (NaN moments included, as in the reference), and the parameters
  change only where ``finite`` holds, chosen on the device without a host
  sync.

Placed trees (DTensor leaves, over a mesh) take the same arithmetic on
each rank's local block: a gradient is first redistributed onto its
moment's placement (under ZeRO-1 the moments are sharded while the
parameters are replicated: the update runs on the moment's block of the
parameter and the new block is all-gathered back), the global norm sums
each leaf's local squares over the ranks that hold distinct blocks (all
leaves in one reduction), and ``finite`` holds on every rank only if it
holds on all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..core import api
from ..runtime.fault import all_finite
from ..runtime.sharding import is_placed

_F32 = torch.float32
# the largest subnormal float32: ``hardshrink`` at it keeps exactly the
# normal values (and inf, NaN) and writes +0 for the rest
_SUBNORMAL_MAX = 2.0 ** -126 - 2.0 ** -149


def _ftz_(x: torch.Tensor, scratch: torch.Tensor | None = None) -> torch.Tensor:
    """XLA's flush of float32 ``x``, in place: subnormals become zero of
    their sign, everything else stays.  ``scratch`` (``x``'s shape and
    dtype) holds the unsigned flush."""
    y = torch.ops.aten.hardshrink.out(x, _SUBNORMAL_MAX,
                                      out=torch.empty_like(x) if scratch is None else scratch)
    return torch.copysign(y, x, out=x)


def _ftz_nonneg_(x: torch.Tensor) -> torch.Tensor:
    """:func:`_ftz_` for values that are ``>= +0`` or NaN (``v``, squares),
    whose zeros are +0 in the reference too: one pass."""
    return torch.ops.aten.hardshrink.out(x, _SUBNORMAL_MAX, out=x)


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"    # "bfloat16" halves optimizer memory
    grad_clip: float = 1.0


def _leaves(tree: Any) -> list[torch.Tensor]:
    return [x for _k, x in api.flatten_with_keys(tree)]


def map_tree(fn, *trees):
    """``fn`` over matching leaves of ``trees``, in the first tree's shape."""
    flats = [dict(api.flatten_with_keys(t)) for t in trees]
    return api.unflatten_like(trees[0], lambda k: fn(*(f[k] for f in flats)))


def init_state(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = _leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {
        "m": map_tree(zeros, params),
        "v": map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if is_placed(x) else x


def _over_ranks(parts: list, leaves: list) -> list:
    """Each leaf's sum over the mesh of its local-block sum in ``parts``,
    for placed ``leaves`` (``Shard`` or ``Replicate``): all the leaves' sums
    in one reduction over the mesh (one all-reduce a mesh dim, as DTensor
    runs it).  A rank contributes a leaf's sum only where it
    is the first of the ranks that hold the same block (coordinate 0 on
    each mesh dim the leaf is replicated over), and an exact zero
    elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = next(x.device_mesh for x in leaves if is_placed(x))
    coord = mesh.get_coordinate()
    first = [all(coord[d] == 0 for d, pl in enumerate(x.placements) if not isinstance(pl, Shard))
             if is_placed(x) else not any(coord) for x in leaves]
    local = torch.stack([p if f else torch.zeros_like(p) for p, f in zip(parts, first)])
    return list(DTensor.from_local(local, mesh, [Partial()] * mesh.ndim).full_tensor().unbind(0))


def _global_norm(tree) -> torch.Tensor:
    leaves = _leaves(tree)
    parts = [torch.sum(_ftz_nonneg_(torch.square(_local(x).to(_F32)))) for x in leaves]
    if any(is_placed(x) for x in leaves):
        parts = _over_ranks(parts, leaves)
    total = 0
    for part in parts:
        total = total + part
    return torch.sqrt(torch.as_tensor(total, dtype=_F32))


def _scale_and_corrections(grads, step: torch.Tensor, cfg: AdamWConfig):
    """``(gnorm, scale, bc1, bc2)`` for the new ``step``, float32."""
    gnorm = _global_norm(grads)
    if cfg.grad_clip:
        scale = torch.minimum(torch.ones((), dtype=_F32, device=gnorm.device),
                              cfg.grad_clip / (gnorm + 1e-12))
    else:
        scale = 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=_F32, device=step.device), step.to(_F32))
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=_F32, device=step.device), step.to(_F32))
    return gnorm, scale, bc1, bc2


def apply_updates(params, grads, state, lr, cfg: AdamWConfig) -> tuple[Any, dict, dict]:
    """One AdamW step; returns ``(new_params, new_state, metrics)`` and leaves
    its arguments as they are."""
    step = state["step"] + 1
    gnorm, scale, bc1, bc2 = _scale_and_corrections(grads, _local(step), cfg)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, m, v):
        g = g.to(_F32) * scale
        m_new = _ftz_(_ftz_(b1 * m.to(_F32)) + _ftz_((1 - b1) * g))
        v_new = _ftz_nonneg_(b2 * v.to(_F32)) + _ftz_nonneg_((1 - b2) * torch.square(g))
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(_F32)
        p_new = p.to(_F32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    flats = [dict(api.flatten_with_keys(t)) for t in (params, grads, state["m"], state["v"])]
    out = {k: upd(*(f[k] for f in flats)) for k in flats[0]}
    pick = lambda i: api.unflatten_like(params, lambda k: out[k][i])  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, {"grad_norm": gnorm}


@torch.no_grad()
def apply_updates_(params, grads, state, lr, cfg: AdamWConfig) -> dict:
    """One AdamW step in place, with the non-finite guard: ``params``, the
    moments and ``state["step"]`` are updated, ``grads`` are consumed
    (scaled in place).  Returns ``{"grad_norm", "finite"}``; the result
    equals :func:`apply_updates` followed by
    ``fault.skip_nonfinite_update(new_params, params, grads)``."""
    if is_placed(lr):
        lr = lr.to_local()
    flat_g = dict(api.flatten_with_keys(grads))
    flat_m = dict(api.flatten_with_keys(state["m"]))
    flat_v = dict(api.flatten_with_keys(state["v"]))
    for k, g in flat_g.items():  # each gradient on its moment's placement
        if is_placed(g) and tuple(g.placements) != tuple(flat_m[k].placements):
            flat_g[k] = g.redistribute(g.device_mesh, flat_m[k].placements)
    finite = all_finite(flat_g)
    state["step"] += 1
    gnorm, scale, bc1, bc2 = _scale_and_corrections(flat_g, _local(state["step"]), cfg)
    b1, b2 = cfg.b1, cfg.b2
    for k, p in api.flatten_with_keys(params):
        g, m, v = flat_g[k], flat_m[k], flat_v[k]
        whole = None
        if is_placed(p):
            if tuple(p.placements) != tuple(m.placements):  # ZeRO-1: m's block of p
                whole, p = p, p.redistribute(p.device_mesh, m.placements).to_local().clone()
            else:
                p = p.to_local()
            g, m, v = g.to_local(), m.to_local(), v.to_local()
        if g.dtype != _F32:
            g = g.to(_F32)
        g.mul_(scale)
        # each product rounded and flushed on its own, then the sum flushed
        # (the reference's order; no fused multiply-add); v first, so that
        # g can then hold (1 − b1)·g and, later, m̂
        t = torch.square(g)
        _ftz_nonneg_(t.mul_(1 - b2))
        v32 = v.mul_(b2) if v.dtype == _F32 else v.to(_F32).mul_(b2)
        _ftz_nonneg_(v32).add_(t)
        _ftz_(g.mul_(1 - b1), t)
        m32 = m.mul_(b1) if m.dtype == _F32 else m.to(_F32).mul_(b1)
        _ftz_(_ftz_(m32, t).add_(g), t)
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
        # delta = m̂ / (√v̂ + eps) + wd·p, then p − lr·delta where finite
        mhat = torch.div(m32, bc1, out=g if m32 is m else m32)
        vhat = torch.div(v32, bc2, out=t)
        vhat.sqrt_().add_(cfg.eps)
        mhat.div_(vhat)
        torch.mul(p.to(_F32), cfg.weight_decay, out=t)
        mhat.add_(t).mul_(lr)
        torch.sub(p.to(_F32), mhat, out=mhat)
        p.copy_(torch.where(finite, mhat, p.to(_F32), out=mhat))
        del t, m32, v32, mhat, vhat
        if whole is not None:  # the new block gathered back onto p's placement
            from torch.distributed.tensor import DTensor

            block = DTensor.from_local(p, whole.device_mesh, flat_m[k].placements)
            whole.to_local().copy_(block.redistribute(whole.device_mesh, whole.placements)
                                   .to_local())
    return {"grad_norm": gnorm, "finite": finite}
