"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427; counterpart of
``repro.models.rglru``).

Recurrence: h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t), with
a_t = exp(c · r_t · log σ(Λ)), r/i input gates.  The block has two
branches, a GELU gate and a causal conv1d followed by the RG-LRU, merged
multiplicatively, then an output projection.

Training and prefill scan the recurrence as the reference does, with
``jax.lax.associative_scan``'s own algorithm (:func:`_associative_scan`):
combine adjacent pairs, recurse on the half, combine the odd results with
the even inputs, interleave.  The sums come in its order, so the scan
equals the reference's bit for bit on the same gates (a sequential loop
adds in another order); it is log₂ L levels of strided elementwise ops.
Decode is one step on the (B, W) state, written in place
(:func:`rglru_block_decode`), as ``mamba2_decode`` writes its cache.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import META, _randn, gelu, init_linear, linear

_C = 8.0  # paper constant


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _lam(gen: torch.Generator, shape: tuple, dtype) -> torch.Tensor:
    """The reference's Λ (the paper's appendix): u ~ U[0.9², 0.999²] in
    float32, Λ = log(√u / √(1 − u))."""
    if gen is META:
        return torch.empty(shape, dtype=dtype, device=gen.device)
    u = torch.empty(shape, dtype=torch.float32, device=gen.device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    return torch.log(torch.sqrt(u) / torch.sqrt(1.0 - u)).to(dtype)


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
                     dtype=torch.float32) -> dict:
    w = _lru_width(cfg)
    return {
        "in_x": init_linear(gen, cfg.d_model, w, True, lead=lead, dtype=dtype),
        "in_gate": init_linear(gen, cfg.d_model, w, True, lead=lead, dtype=dtype),
        "conv_w": _randn(gen, lead + (cfg.hybrid.conv_width, w), 0.1, dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=gen.device),
        "wr": init_linear(gen, w, w, True, lead=lead, dtype=dtype),
        "wi": init_linear(gen, w, w, True, lead=lead, dtype=dtype),
        "lam": _lam(gen, lead + (w,), dtype),
        "out": init_linear(gen, w, cfg.d_model, False, lead=lead, dtype=dtype),
    }


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, softplus as
    ``logaddexp(x, 0)``."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """a_t (float32) and the gated input contribution (float32)."""
    r = torch.sigmoid(linear(x, p["wr"]).float())
    i = torch.sigmoid(linear(x, p["wi"]).float())
    log_a = _C * r * _log_sigmoid(p["lam"].float())  # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    contrib = beta * (i * x.float())
    return a, contrib


def _combine(a1, b1, a2, b2):
    """The linear recurrence's composition: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).reshape(
        (odd.shape[0], 2 * n) + odd.shape[2:])
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) pairs under :func:`_combine` along dim 1,
    in ``jax.lax.associative_scan``'s order of operations."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(x: torch.Tensor, p: dict) -> torch.Tensor:
    """(B, L, W) linear recurrence from a zero state, in ``x``'s dtype."""
    a, contrib = _gates(x, p)
    _aa, bb = _associative_scan(a, contrib)
    return bb.to(x.dtype)


def rglru_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full recurrent block: conv1d + RG-LRU branch ⊙ GELU gate branch."""
    cw = cfg.hybrid.conv_width
    gate = gelu(linear(x, p["in_gate"]))
    u = linear(x, p["in_x"])
    u_pad = torch.nn.functional.pad(u, (0, 0, cw - 1, 0))
    l = u.shape[1]
    conv = u_pad[:, 0:l, :] * p["conv_w"][0].to(u.dtype)[None, None, :]
    for k in range(1, cw):  # the reference's sum over taps, in order
        conv = conv + u_pad[:, k:k + l, :] * p["conv_w"][k].to(u.dtype)[None, None, :]
    conv = conv + p["conv_b"].to(u.dtype)[None, None, :]
    h = rglru_scan(conv, p)
    return linear(h * gate, p["out"])


def rglru_block_decode(
    x: torch.Tensor,    # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache: dict,        # {"h": (B, W) float32, "conv": (B, cw-1, W)}, written in place
) -> tuple[torch.Tensor, dict]:
    """One token: ``(out (B, 1, D), cache)``.  The conv buffer takes the
    concatenation's last ``cw - 1`` rows (a new tensor: the shift reads no
    row it has written) and keeps its dtype; ``h`` becomes
    ``a ⊙ h + contribution`` in its own storage."""
    gate = gelu(linear(x, p["in_gate"]))
    u = linear(x, p["in_x"])[:, 0]  # (B, W)
    conv_buf = torch.cat([cache["conv"], u[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = (torch.sum(conv_buf * p["conv_w"].to(conv_buf.dtype)[None, :, :], dim=1)
            + p["conv_b"].to(conv_buf.dtype)[None, :])
    a, contrib = _gates(conv[:, None, :], p)
    h = cache["h"]
    h.mul_(a[:, 0]).add_(contrib[:, 0])
    y = linear(h[:, None, :].to(x.dtype) * gate, p["out"])
    cache["conv"].copy_(conv_buf[:, 1:, :])
    return y, cache
