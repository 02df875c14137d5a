"""Shared layers: norms, embeddings, the SwiGLU and GELU MLPs, rotary
embeddings and the multimodal rotary embedding (M-RoPE) of the VLM family
(counterpart of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  The init functions take an
explicit ``torch.Generator`` (its device is where the weights are made) and
a ``lead`` shape: a stack of per-layer parameters is made as one tensor of
shape ``lead + shape``, the layout the reference's ``vmap``-ed init gives.
:data:`META` stands in for a generator to make the parameters' shapes
alone, on the ``meta`` device (the reference's ``jax.eval_shape`` of init).
The arithmetic is the reference's, op for op: casts to the compute dtype
where it casts, float32 where it computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime.sharding import is_placed


class _MetaGenerator:
    """No random state: init with it makes tensors on the ``meta`` device."""

    device = torch.device("meta")


META = _MetaGenerator()
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _randn(gen: torch.Generator, shape: tuple, std: float, dtype: torch.dtype) -> torch.Tensor:
    if gen is META:
        return torch.empty(shape, dtype=dtype, device=gen.device)
    # scaled in place: no second tensor of the draw's size (15 GB for one of
    # deepseek-v3's float32 expert stacks); the values are the same
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype).mul_(std)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, op for op in ``x``'s dtype:
    ``x · ½(1 + tanh(√(2/π)(x + 0.044715 x³)))`` (``F.gelu``'s default is
    the erf form; its tanh form rounds once in float32, where the
    reference rounds every op in bfloat16)."""
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """GELU MLP (seamless-m4t / classic transformer FFN)."""
    h = gelu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, lead: tuple = (),
                  dtype=torch.float32) -> dict:
    return {
        "w1": _randn(gen, lead + (d_model, d_ff), 1.0 / math.sqrt(d_model), dtype),
        "b1": torch.zeros(lead + (d_ff,), dtype=dtype, device=gen.device),
        "w2": _randn(gen, lead + (d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype),
        "b2": torch.zeros(lead + (d_model,), dtype=dtype, device=gen.device),
    }


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32) -> dict:
    return {"table": _randn(gen, (vocab, d_model), 0.02, dtype)}


class _Embed(torch.autograd.Function):
    """Gather the rows, then cast them: the values of the reference's
    cast-the-table-then-gather without a pass over the whole table.  The
    backward is the reference's: the rows' gradients summed into a zero
    table in the compute dtype, token by token in order (so repeated tokens
    round at every add under bfloat16, as XLA's scatter-add does), then
    cast to the table's dtype."""

    @staticmethod
    def forward(ctx, table, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.table_meta = (table.shape, table.dtype)
        return table[tokens].to(dtype)

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        shape, dtype = ctx.table_meta
        acc = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
        acc.index_put_((tokens.reshape(-1).long(),), grad.reshape(-1, shape[-1]),
                       accumulate=True)
        return acc.to(dtype), None, None


def embed(tokens: torch.Tensor, p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    table = p["table"]
    if is_placed(table):
        return _embed_placed(table, tokens, dtype)
    return _Embed.apply(table, tokens, dtype)


def _embed_placed(table, tokens, dtype):
    """:class:`_Embed` on a placed table (DTensor has no strategy for its
    backward's ``index_put_``): each rank gathers its tokens' rows from the
    whole table (made whole first, as a vocab-sharded gather needs), and
    the rows come back placed as the tokens are.  The table's gradient on
    a rank is its tokens' share: a partial sum over the mesh dims the
    tokens are split on, which autograd reduces onto the table's
    placement."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_placed(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    split = [isinstance(pl, Shard) for pl in tokens.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    local = whole.to_local(grad_placements=[Partial() if s else Replicate() for s in split])
    rows = _Embed.apply(local, tokens.to_local(), dtype)
    return DTensor.from_local(rows, mesh, list(tokens.placements))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for standard RoPE (half the head dim)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The rotary rotation of ``x`` (..., seq, heads, head_dim) by float32
    ``angles`` (..., seq, head_dim/2), computed in float32."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)  # angles (..., seq, hd/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (..., seq, heads, head_dim), positions
    (..., seq, 3) the (t, h, w) triplets; ``sections`` split head_dim/2's
    frequencies across t, h and w.  Each frequency takes its section's
    coordinate (a gather over float32 positions), then the rotation of
    :func:`apply_rope`: text tokens (t = h = w) get RoPE's values."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(head_dim, theta, x.device)
    sect_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                      torch.tensor(sections, device=x.device),
                                      output_size=half)  # (half,); a meta x needs the size
    pos = positions.float()
    pos_per_freq = torch.take_along_dim(pos, sect_id.expand(pos.shape[:-1] + (half,)), dim=-1)
    return _rotate(x, pos_per_freq * inv)
