"""Mamba-2 block: the SSD (state-space duality) chunked algorithm
(counterpart of ``repro.models.ssm``).

Train and prefill use the chunked SSD form (arXiv:2405.21060 §6): an
intra-chunk attention-like product plus an inter-chunk state recurrence.
Decode keeps the (H, P, N) state and makes one rank-1 update a token.

Shapes: x (B, L, D); inner D_i = expand·D split into H heads of P =
head_dim; the B/C projections have G groups of state size N, each shared
by H/G consecutive heads (``jnp.repeat``'s order, ``repeat_interleave``'s,
not ``Tensor.repeat``'s tiling).

The reference's formulation defines the numbers and is kept: the four steps
of :func:`ssd_chunked` in float32, the input cast back to ``x.dtype`` only
after ``+ x·D``, the causal depthwise conv as the sum over its taps in
order, ``softplus`` as ``logaddexp(x, 0)`` (``torch.nn.functional.softplus``
returns ``x`` itself above 20).  Where the reference writes a three-operand
einsum the port names the pairing: the elementwise factor first, then one
contraction (``torch.einsum`` would pick its own order); the sums differ
from XLA's in their last bits only.  The reference's ``lax.scan`` over
chunks is a loop over them with a float32 state.  A group's B (C) is not
copied out per head: its products are taken per group and broadcast over
the group's heads, the values of the reference's repeated operands.

:func:`mamba2_decode` writes the layer's cache in place: the conv buffer
takes the concatenation's last ``d_conv - 1`` rows (the concatenation is a
new tensor, so the shift reads no row it has written), and the state
becomes ``state·decay + Δt·x ⊗ B`` in its own storage.  The cache keeps
its dtype (the reference's returned conv buffer takes the promoted dtype of
the cache and the step's input, which is the cache's at a float32 cache).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import sharding as shr
from .layers import META, _randn, init_linear, init_rms_norm, linear, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.n_groups, s.d_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _a_log_values(h: int) -> np.ndarray:
    """``log(linspace(1, 16, h))`` in float32: ``jnp.linspace``'s arithmetic
    (``1·(1 − i/(h−1)) + 16·i/(h−1)``, each op rounded to float32, the end
    point appended), then the logarithm rounded from float64 (XLA's float32
    ``log`` is not correctly rounded: within 1 ulp of it)."""
    f = np.float32
    if h == 1:
        grid = np.ones(1, f)
    else:
        step = np.arange(h - 1, dtype=f) / f(h - 1)
        grid = np.append(f(1) * (f(1) - step) + f(16) * step, f(16))
    return np.log(grid.astype(np.float64)).astype(f)


def _const(gen, values: np.ndarray, lead: tuple, dtype) -> torch.Tensor:
    """``values`` (float32) as ``dtype``, repeated along ``lead``, on the
    generator's device (its own storage a layer: they are trained)."""
    shape = lead + values.shape
    if gen is META:
        return torch.empty(shape, dtype=dtype, device=gen.device)
    t = torch.from_numpy(values).to(dtype)
    return t.to(gen.device).expand(shape).clone()


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
                dtype=torch.float32) -> dict:
    """The reference's leaves: ``in_proj``/``out_proj`` N(0, 1/d_in),
    ``conv_w`` N(0, 0.1²), ``conv_b`` 0, ``A_log = log(linspace(1, 16, H))``,
    ``D`` 1, ``dt_bias = log(expm1(0.01))`` and the gated norm's scale 0."""
    s = cfg.ssm
    d_inner, h, _p, g, n = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * g * n + h
    conv_dim = d_inner + 2 * g * n
    # float32 log and expm1 (torch's give XLA's bits at 0.01)
    dt_bias = torch.log(torch.expm1(torch.tensor(0.01, dtype=torch.float32))).item()
    return {
        "in_proj": init_linear(gen, cfg.d_model, d_in_proj, False, lead=lead, dtype=dtype),
        "conv_w": _randn(gen, lead + (s.d_conv, conv_dim), 0.1, dtype),
        "conv_b": _const(gen, np.zeros(conv_dim, np.float32), lead, dtype),
        "A_log": _const(gen, _a_log_values(h), lead, dtype),
        "D": _const(gen, np.ones(h, np.float32), lead, dtype),
        "dt_bias": _const(gen, np.full(h, dt_bias, np.float32), lead, dtype),
        "norm": init_rms_norm(gen, d_inner, lead=lead, dtype=dtype),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, False, lead=lead, dtype=dtype),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., q) log-decays → (..., q, q) lower-triangular segment sums,
    ``-inf`` above the diagonal (where ``torch.where`` sends no gradient)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H): positive step sizes
    A: torch.Tensor,    # (H,): negative decay rates
    Bm: torch.Tensor,   # (B, L, G, N)
    Cm: torch.Tensor,   # (B, L, G, N)
    chunk: int,
) -> torch.Tensor:
    """The chunked SSD scan: ``y_t = Σ_{j<=t} C_t·(Π_{j<i<=t} exp(Δt_i A)) Δt_j
    x_j ⊗ B_j``, (B, L, H, P); ``l`` is padded to a multiple of ``chunk``
    with zeros and the tail dropped."""
    b, l, h, p_ = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    lq = x.shape[1]
    nc = lq // chunk
    q = chunk

    # heads as (group, head within the group): h = group·rep + r
    xc = shr.reshape(x, b, nc, q, g, rep, p_)
    dtc = shr.reshape(dt, b, nc, q, g, rep)
    Bc = shr.reshape(Bm, b, nc, q, g, n)
    Cc = shr.reshape(Cm, b, nc, q, g, n)

    a = dtc * A.reshape(g, rep)               # (b,nc,q,g,r) log decay per step (negative)
    a_hq = a.permute(0, 1, 3, 4, 2)           # (b,nc,g,r,q)
    L = torch.exp(_segsum(a_hq))              # (b,nc,g,r,q,q)

    dtx = xc * dtc[..., None]                 # Δt·x (b,nc,q,g,r,p)

    # 1) intra-chunk (diagonal blocks): Y_d = (C Bᵀ ⊙ L) · (Δt X)
    cb = torch.einsum("bzqgn,bzkgn->bzgqk", Cc, Bc)[:, :, :, None]   # (b,nc,g,1,q,k)
    yd = torch.einsum("bzgrqk,bzkgrp->bzqgrp", cb * L, dtx)

    # 2) chunk-final states: S_z = Σ_j exp(Σ_{i>j} a_i) Δt x_j ⊗ B_j
    cum = torch.cumsum(a_hq, dim=-1)
    decay_to_end = torch.exp(cum[..., -1:] - cum)                       # (b,nc,g,r,q)
    states = torch.einsum("bzqgn,bzqgrp->bzgrpn", Bc,
                          dtx * decay_to_end.permute(0, 1, 4, 2, 3)[..., None])

    # 3) inter-chunk recurrence over the chunk states (float32)
    chunk_decay = torch.exp(torch.sum(a_hq, dim=-1))                    # (b,nc,g,r)
    s = torch.zeros((b, g, rep, p_, n), dtype=torch.float32, device=x.device)
    before = []
    for z in range(nc):
        before.append(s)
        s = s * chunk_decay[:, z, ..., None, None] + states[:, z].float()
    s_before = torch.stack(before, 1)       # (b,nc,g,r,p,n): the state entering each chunk

    # 4) inter-chunk contribution: Y_off = C_t · exp(cum_t) · S_before
    decay_in = torch.exp(cum).permute(0, 1, 4, 2, 3)                    # (b,nc,q,g,r)
    yoff = torch.einsum("bzqgn,bzgrpn->bzqgrp", Cc, s_before.to(Cc.dtype)) * decay_in[..., None]

    y = shr.reshape(yd + yoff, b, lq, h, p_)
    return y[:, :l]


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """``in_proj``'s output as (z, x·B·C, Δt)."""
    d_inner, h, _p, g, n = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, h], dim=-1)


def mamba2_forward(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The whole Mamba-2 mixer over a sequence (the train and prefill path)."""
    s = cfg.ssm
    d_inner, h, p_, g, n = _dims(cfg)
    b, l, _ = x.shape
    z, xbc, dt = _split_in_proj(linear(x, p["in_proj"]), cfg)
    # causal depthwise conv over (x, B, C): the taps summed in order
    xbc_pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    conv = sum(xbc_pad[:, k:k + l, :] * p["conv_w"][k][None, None, :]
               for k in range(s.d_conv)) + p["conv_b"][None, None, :]
    xbc = F.silu(conv)
    xs, Bm, Cm = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = shr.reshape(xs, b, l, h, p_)
    Bm = shr.reshape(Bm, b, l, g, n)
    Cm = shr.reshape(Cm, b, l, g, n)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd_chunked(xs.float(), dt, A, Bm.float(), Cm.float(), s.chunk)
    y = y + xs.float() * p["D"].float()[None, None, :, None]
    y = shr.reshape(y, b, l, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"]["scale"], cfg.norm_eps)
    return linear(y, p["out_proj"])


def mamba2_decode(
    x: torch.Tensor,    # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache: dict,        # {"state": (B, H, P, N) float32, "conv": (B, d_conv-1, conv_dim)}
) -> tuple[torch.Tensor, dict]:
    """One token: ``(out (B, 1, D), cache)``, the cache written in place."""
    d_inner, h, p_, g, n = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_in_proj(linear(x, p["in_proj"])[:, 0], cfg)
    conv_buf = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # the promoted dtype
    conv = torch.sum(conv_buf * p["conv_w"][None, :, :], dim=1) + p["conv_b"][None, :]
    xbc_t = F.silu(conv)
    xs, Bm, Cm = torch.split(xbc_t, [d_inner, g * n, g * n], dim=-1)
    xs = shr.reshape(xs, b, h, p_).float()
    rep = h // g
    Bh = torch.repeat_interleave(shr.reshape(Bm, b, g, n).float(), rep, dim=1)  # (B,H,N)
    Ch = torch.repeat_interleave(shr.reshape(Cm, b, g, n).float(), rep, dim=1)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)  # (B,H)
    state = cache["state"]
    state.mul_(decay[..., None, None]).add_((xs * dt[..., None])[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xs * p["D"].float()[None, :, None]
    y = shr.reshape(y, b, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None, :]), p["norm"]["scale"], cfg.norm_eps)
    cache["conv"].copy_(conv_buf[:, 1:, :])
    return linear(y, p["out_proj"]), cache
