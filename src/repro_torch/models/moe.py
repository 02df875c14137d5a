"""Mixture-of-Experts layer: GShard/Switch-style dense dispatch
(counterpart of ``repro.models.moe``: ``init_moe``, ``_top_k_gating``,
``moe_layer``, the group-blocked ``moe_layer_grouped`` and the
expert-parallel all-to-all ``moe_layer_a2a``).

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

``moe_layer`` picks the dispatch as the reference does: ``moe_impl="a2a"``
first (:func:`moe_layer_a2a`, which returns None where its conditions
fail: no ambient mesh, experts not one a rank of the ("data","model")
axes, tokens not dividing over the mesh), then ``moe_group_size > 0``
(:func:`moe_layer_grouped`), else the dense dispatch.  The grouped
dispatch's placement constraints act only on DTensors under an ambient
mesh (``launch.mesh.use_mesh``); elsewhere they are no-ops, as the
reference's ``with_sharding_constraint`` is without a mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import sharding as shr
from .layers import _randn, init_swiglu, swiglu


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
    logits = shr.reshape(x, t, -1).float() @ router.float()
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
    if cfg.moe_impl == "a2a":
        out = moe_layer_a2a(x, p, cfg, capacity_factor)
        if out is not None:
            return out
    if cfg.moe_group_size > 0:
        return moe_layer_grouped(x, p, cfg, capacity_factor)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xt = shr.reshape(x, t, d)
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
    return shr.reshape(y, b, s, d), aux


# ---------------------------------------------------------------------------
# group-blocked dispatch (GShard groups)
# ---------------------------------------------------------------------------


def _mesh_axes_for(dim: int, include_model: bool = True):
    """Largest prefix of the ambient mesh's (pod, data[, model]) axes whose
    size divides ``dim``; None under no mesh."""
    mesh = shr.AMBIENT_MESH.get()
    if mesh is None:
        return None
    names = shr.axis_names(mesh)
    pool = ("pod", "data", "model") if include_model else ("pod", "data")
    avail = [n for n in pool if n in names]
    best = None
    for kk in range(1, len(avail) + 1):
        if dim % shr._axis_size(mesh, tuple(avail[:kk])) == 0:
            best = tuple(avail[:kk])
    return best


def _wsc(v, spec: tuple):
    """The reference's ``with_sharding_constraint``: a DTensor under the
    ambient mesh redistributed to ``spec``; anything else as it is."""
    mesh = shr.AMBIENT_MESH.get()
    if mesh is None or not shr.is_placed(v):
        return v
    want = shr.to_placements(shr.P(*spec), v.device_mesh)
    return v if tuple(v.placements) == want else v.redistribute(v.device_mesh, list(want))


def moe_layer_grouped(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard *group-blocked* dispatch: tokens in groups of ``Tg =
    cfg.moe_group_size``, a capacity per group ∝ Tg, dispatch tensors (G,
    Tg, E, Cg); groups on the DP axes, experts over the whole mesh (under
    an ambient mesh).  One-hots in the compute dtype, as the reference's."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    tg = min(cfg.moe_group_size, t)
    if t % tg:
        raise ValueError(f"{t} tokens do not divide into groups of {tg}")
    g = t // tg
    cap = max(1, int(math.ceil(tg * k / e * capacity_factor)))
    dt = x.dtype

    eax = _mesh_axes_for(e)
    gax = _mesh_axes_for(g, include_model=False)  # groups ride the DP axes
    xg = shr.reshape(x, g, tg, d)
    if gax:
        xg = _wsc(xg, (gax, None, None))
    logits = xg.float() @ p["router"].float()                         # (G, Tg, E)
    probs, gates, idx = _top_k_gating(logits, k)                       # (G, Tg, k)

    onehot = _one_hot(idx, e, torch.int32)                             # (G, Tg, k, E)
    slot_major = onehot.movedim(2, 1)                                  # (G, k, Tg, E)
    flat = slot_major.reshape(g, k * tg, e)
    pos = flat.cumsum(dim=1) - flat                                    # pos within (g, e)
    pos = (pos.reshape(g, k, tg, e) * slot_major).sum(dim=-1)          # (G, k, Tg)
    keep = pos < cap
    gates_km = gates.movedim(2, 1) * keep.float()                      # (G, k, Tg)
    pos_oh = _one_hot(pos, cap, dt) * keep[..., None].to(dt)

    sm = slot_major.to(dt)
    disp = torch.einsum("gkte,gktc->gtec", sm, pos_oh)
    comb = torch.einsum("gkte,gktc->gtec", sm, pos_oh * gates_km.to(dt)[..., None])
    if gax:
        disp = _wsc(disp, (gax, None, None, None))
        comb = _wsc(comb, (gax, None, None, None))

    xin = torch.einsum("gtec,gtd->egcd", disp, xg)                     # (E, G, Cg, D)
    if eax:
        xin = _wsc(xin, (eax, None, None, None))
    gact = F.silu(torch.einsum("egcd,edf->egcf", xin, p["wg"].to(dt)))
    uact = torch.einsum("egcd,edf->egcf", xin, p["wu"].to(dt))
    hexp = torch.einsum("egcf,efd->egcd", gact * uact, p["wd"].to(dt))
    if eax:
        hexp = _wsc(hexp, (eax, None, None, None))
    y = torch.einsum("gtec,egcd->gtd", comb, hexp)

    if m.n_shared:
        y = y + shr.reshape(swiglu(shr.reshape(xg, t, d), p["shared"]), g, tg, d)

    frac = onehot.float().sum(dim=2).mean(dim=(0, 1))
    prob_mean = probs.mean(dim=(0, 1))
    aux = e * (frac * prob_mean).sum() * m.aux_loss_coef
    return shr.reshape(y, b, s, d), aux


# ---------------------------------------------------------------------------
# expert-parallel all-to-all dispatch
# ---------------------------------------------------------------------------


def moe_layer_a2a(
    x: torch.Tensor,  # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    capacity_factor: float = 1.25,
):
    """Explicit expert-parallel MoE over the ambient mesh: each rank routes
    its own ``T / n_dev`` tokens (the tokens split over every mesh axis),
    sends each expert its (C, D) rows with an all-to-all over the
    ("data","model") ranks, runs the one expert it holds, and sends the
    rows back; the aux loss is averaged over all ranks.  The reference's
    shard_map body, line for line.

    Needs an ambient mesh, E equal to the ("data","model") ranks and T
    dividing over all ranks; returns None otherwise, and ``moe_layer``
    takes the next dispatch, as the reference's does.  ``x`` placed
    (a DTensor) gives placed outputs; a plain ``x`` (the same on every
    rank) gives plain ones, gathered whole.
    """
    import torch.distributed._functional_collectives as funcol

    mesh = shr.AMBIENT_MESH.get()
    if mesh is None:
        return None
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    names = shr.axis_names(mesh)
    a2a_axes = tuple(n for n in ("data", "model") if n in names)
    all_axes = tuple(n for n in ("pod", "data", "model") if n in names)
    n_a2a = shr._axis_size(mesh, a2a_axes) if a2a_axes else 1
    n_dev = shr._axis_size(mesh, all_axes)
    if not a2a_axes or e != n_a2a or t % n_dev != 0 or all_axes != names:
        return None

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    t_loc = t // n_dev
    cap = max(1, int(math.ceil(t_loc * k / e * capacity_factor)))
    dt = x.dtype
    a2a_group = (mesh[a2a_axes]._flatten() if len(a2a_axes) > 1 else mesh[a2a_axes[0]]).get_group()
    world_group = (mesh._flatten() if mesh.ndim > 1 else mesh).get_group()
    coord = mesh.get_coordinate()
    shape = shr.mesh_shape(mesh)
    me = 0
    for name, c in zip(names, coord):  # the rank's index over (pod, data, model)
        me = me * shape[name] + c
    expert = me % n_a2a  # its index over (data, model): the expert it holds
    placed = shr.is_placed(x)
    every = [Shard(0)] * mesh.ndim
    pod_partial = [Partial() if n == "pod" else Shard(0) for n in names]

    def local(w, grad):
        """A parameter's local tensor, whole, its gradient a rank's share."""
        if not shr.is_placed(w):
            return w
        return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)

    def expert_weight(w):
        if not shr.is_placed(w):
            return w[expert:expert + 1]
        lay = [Replicate() if n == "pod" else Shard(0) for n in names]
        return w.redistribute(mesh, lay).to_local(grad_placements=pod_partial)

    x_loc = (shr.reshape(x, t, d).redistribute(mesh, every).to_local() if placed
             else x.reshape(t, d)[me * t_loc:(me + 1) * t_loc])
    partial = [Partial()] * mesh.ndim
    router = local(p["router"], partial)
    logits = x_loc.float() @ router.float()
    probs, gates, idx = _top_k_gating(logits, k)                       # (T_loc, E), (T_loc, k)

    onehot = _one_hot(idx, e, torch.int32)                             # (T_loc, k, E)
    slot_major = onehot.transpose(0, 1)                                # (k, T_loc, E)
    flat = slot_major.reshape(k * t_loc, e)
    pos = (flat.cumsum(dim=0) - flat).reshape(k, t_loc, e)
    pos = (pos * slot_major).sum(dim=-1)                               # (k, T_loc)
    keep = pos < cap
    gates_km = gates.transpose(0, 1) * keep.float()
    pos_oh = _one_hot(pos, cap, dt) * keep[..., None].to(dt)
    sm = slot_major.to(dt)
    disp = torch.einsum("kte,ktc->tec", sm, pos_oh)
    comb = torch.einsum("kte,ktc->tec", sm, pos_oh * gates_km.to(dt)[..., None])

    send = torch.einsum("tec,td->ecd", disp, x_loc)                    # (E, C, D)
    recv = funcol.all_to_all_single_autograd(send.contiguous(), None, None, a2a_group)
    h = recv.reshape(e * cap, d)                                       # my expert's rows
    wg, wu, wd = (expert_weight(p[n]) for n in ("wg", "wu", "wd"))
    g_act = F.silu(h @ wg[0].to(dt))
    u_act = h @ wu[0].to(dt)
    h_out = (g_act * u_act) @ wd[0].to(dt)                            # (E·C, D)
    back = funcol.all_to_all_single_autograd(h_out.reshape(e, cap, d).contiguous(), None, None,
                                             a2a_group)                # (E, C, D) back home
    y = torch.einsum("tec,ecd->td", comb, back)
    if m.n_shared:
        shared = {n: local(w, partial) for n, w in p["shared"].items()}
        y = y + swiglu(x_loc, shared)
    frac = onehot.float().sum(dim=1).mean(dim=0)
    prob_mean = probs.mean(dim=0)
    aux = e * (frac * prob_mean).sum() * m.aux_loss_coef
    if placed:
        if b % n_dev == 0:  # the rank's tokens are whole batch rows
            y = DTensor.from_local(y.reshape(b // n_dev, s, d), mesh, every)
        else:
            y = DTensor.from_local(y, mesh, every).redistribute(
                mesh, [Replicate()] * mesh.ndim).reshape(b, s, d)
        # pmean: each rank's share, summed where the value is read
        return y, DTensor.from_local(aux / n_dev, mesh, partial)
    y = funcol.all_gather_tensor_autograd(y, 0, world_group)
    aux = funcol.all_reduce(aux, "sum", world_group) / n_dev
    return y.reshape(b, s, d), aux
