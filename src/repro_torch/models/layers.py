"""Shared layers: norms, embeddings, MLPs, rotary embeddings
(counterpart of ``repro.models.layers``, the dense decoder's part).

Parameters are plain nested dicts of tensors.  The init functions take an
explicit ``torch.Generator`` (its device is where the weights are made) and
a ``lead`` shape: a stack of per-layer parameters is made as one tensor of
shape ``lead + shape``, the layout the reference's ``vmap``-ed init gives.
The arithmetic is the reference's, op for op: casts to the compute dtype
where it casts, float32 where it computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _randn(gen: torch.Generator, shape: tuple, std: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype) * std


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def init_rms_norm(gen: torch.Generator, d: int, *, lead: tuple = (),
                  dtype=torch.float32) -> dict:
    return {"scale": torch.zeros(lead + (d,), dtype=dtype, device=gen.device)}


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False, *,
                lead: tuple = (), dtype=torch.float32, scale: float | None = None) -> dict:
    std = float(scale) if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _randn(gen, lead + (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W_g) ⊙ x W_u) W_d."""
    g = F.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, *, lead: tuple = (),
                dtype=torch.float32) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "wg": _randn(gen, lead + (d_model, d_ff), s_in, dtype),
        "wu": _randn(gen, lead + (d_model, d_ff), s_in, dtype),
        "wd": _randn(gen, lead + (d_ff, d_model), s_out, dtype),
    }


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32) -> dict:
    return {"table": _randn(gen, (vocab, d_model), 0.02, dtype)}


def embed(tokens: torch.Tensor, p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    # the reference casts the whole table, then gathers: the same values
    return p["table"][tokens].to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for standard RoPE (half the head dim)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., None].float() * inv  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
