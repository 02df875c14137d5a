"""Mixture-of-Experts layer: GShard/Switch-style dense dispatch
(counterpart of ``repro.models.moe``: ``init_moe``, ``_top_k_gating`` and
``moe_layer``).

Token-choice top-k routing with capacity, einsum dispatch and combine,
optional shared experts (DeepSeek-V3: 1 shared + 256 routed top-8;
Llama-4 Scout: 1 shared + 16 routed top-1), and the Switch load-balancing
auxiliary loss.

The reference's arithmetic is kept, and so are its routing decisions:

* top-k takes the lower expert index first among equal probabilities, as
  ``jax.lax.top_k`` does (``torch.topk`` promises no order among ties): a
  stable descending sort, cut to k.  Routing fixes the capacity positions,
  so one flipped index would move whole rows.
* one-hots are comparisons with an ``arange`` (``F.one_hot`` checks its
  range on the host, a synchronisation on the card at every call).
* the dispatch and combine are the reference's one-hot einsums over
  ``(T, E, C)``: deterministic, and exact where each ``(t, e, c)`` gathers
  one non-zero term (no ``index_add_`` / ``scatter_add_`` of floats).

The reference's group-blocked (``moe_group_size > 0``) and shard_map
all-to-all (``moe_impl="a2a"``) dispatches are layouts for a mesh of
devices; the port raises for them (``ROADMAP.md``) rather than quietly
running another dispatch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _randn, init_swiglu, swiglu


def check_dispatch(cfg: ModelConfig) -> None:
    """Refuse the reference's mesh dispatches, which the port does not run."""
    if cfg.moe_group_size > 0 or cfg.moe_impl == "a2a":
        raise NotImplementedError(
            f"MoE dispatch moe_group_size={cfg.moe_group_size}, moe_impl={cfg.moe_impl!r} lays "
            "experts out over a device mesh and is not ported yet (see ROADMAP.md); the port "
            "runs the dense GShard dispatch (moe_group_size=0, moe_impl='gshard')")


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
             dtype=torch.float32) -> dict:
    m = cfg.moe
    e = m.n_experts
    d, f = cfg.d_model, m.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": _randn(gen, lead + (d, e), s_in, dtype),
        "wg": _randn(gen, lead + (e, d, f), s_in, dtype),
        "wu": _randn(gen, lead + (e, d, f), s_in, dtype),
        "wd": _randn(gen, lead + (e, f, d), s_out, dtype),
    }
    if m.n_shared:
        p["shared"] = init_swiglu(gen, d, m.d_ff_expert * m.n_shared, lead=lead, dtype=dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype)``: a comparison with ``arange(n)``
    (an index outside [0, n) gives a zero row)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_gating(logits: torch.Tensor, k: int):
    """Top-k gates normalised over the selected experts (DeepSeek-V3 style):
    ``(probs (T, E), gates (T, k), idx (T, k))``, the lower index first
    among equal probabilities."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = vals[..., :k], idx[..., :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), idx


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, capacity_factor: float):
    """The routing of ``moe_layer``: ``(probs (T, E), gates (T, k), idx (T,
    k), pos (k, T), keep (k, T), capacity)``, each token's slots placed
    slot-major (every token's first choice before any second choice, as
    GShard orders them) at its expert's next free position."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    e, k = m.n_experts, m.top_k
    logits = x.reshape(t, -1).float() @ router.float()
    probs, gates, idx = _top_k_gating(logits, k)
    capacity = max(1, int(math.ceil(t * k / e * capacity_factor)))
    slot_major = _one_hot(idx, e, torch.int32).transpose(0, 1)    # (k, T, E)
    pos_in_expert = (slot_major.reshape(k * t, e).cumsum(dim=0).reshape(k, t, e)
                     - slot_major)
    pos = (pos_in_expert * slot_major).sum(dim=-1)                # (k, T)
    return probs, gates, idx, pos, pos < capacity, capacity


def moe_layer(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output (B, S, D), aux_loss)``.  Dense dispatch: FLOPs ∝
    top_k·T·d·f + dispatch."""
    check_dispatch(cfg)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xt = x.reshape(t, d)
    probs, gates, idx, pos, keep, capacity = route(x, p["router"], cfg, capacity_factor)
    slot_major = _one_hot(idx, e, torch.float32).transpose(0, 1)  # (k, T, E)
    gates_km = gates.transpose(0, 1) * keep.float()               # (k, T)

    # dispatch / combine tensors (T, E, C): one (k, t) term each
    pos_onehot = _one_hot(pos, capacity, torch.float32) * keep[..., None]
    disp = torch.einsum("kte,ktc->tec", slot_major, pos_onehot)
    comb = torch.einsum("kte,ktc->tec", slot_major, pos_onehot * gates_km[..., None])

    dt = x.dtype
    xin = torch.einsum("tec,td->ecd", disp.to(dt), xt)              # (E, C, D)
    g = F.silu(torch.einsum("ecd,edf->ecf", xin, p["wg"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", xin, p["wu"].to(dt))
    hexp = torch.einsum("ecf,efd->ecd", g * u, p["wd"].to(dt))      # (E, C, D)
    y = torch.einsum("tec,ecd->td", comb.to(dt), hexp)

    if m.n_shared:
        y = y + swiglu(xt, p["shared"])

    # load-balance aux loss (Switch): E · Σ_e fraction_e · router_prob_e
    frac = slot_major.sum(dim=0).mean(dim=0)  # (E,) share of tokens routed to e
    prob_mean = probs.mean(dim=0)
    aux = e * (frac * prob_mean).sum() * m.aux_loss_coef
    return y.reshape(b, s, d), aux
