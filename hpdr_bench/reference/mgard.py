"""Plain MGARD-X, the yardstick of the MGARD cells.

A frozen, self-contained statement of what an ``mgard`` container holds for
a field at a relative L-infinity bound:

1. every dim edge-padded to 2^k + 1 nodes;
2. the multilevel decomposition, fine to coarse: per level, the
   multilinear interpolation of the coarse nodes subtracted from the fine
   ones, then the coarse nodes corrected by ``M_c^-1 R M_f`` of those
   coefficients (mass matrix ``h tridiag(1/6, 2/3, 1/6)``, ``h/3`` at the
   ends; restriction ``R = P^T``), each 1-D solve a Thomas sweep;
3. the bound ``eb = eps (max - min)``, the range subtracted in float32, and
   the bins ``2 eb / ((L + 1) 2)``, half that on the nodal subset;
4. each coefficient quantized by its level's bin (round half to even,
   subnormals as zero, int32 saturation), zig-zagged to a key; keys at or
   past ``dict_size - 1`` escape and are stored as (index, value) outliers;
5. the keys Huffman-coded (``huffman.py``) in chunks of 4096 symbols.

Reconstruction dequantizes (``q * bin`` in float32, subnormals flushed) and
recomposes coarse to fine.  Every operation is one plain ``torch`` operation
with its own rounding, on whatever device the field lies, in ``dtype``:
float32 is the format, a lower precision the benchmark's control.  It
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import huffman

SAFETY = 2.0
CHUNK = 4096
FLT_MIN = float(np.finfo(np.float32).tiny)
SIXTH = float(np.float32(1.0 / 6.0))
TWO_THIRDS = float(np.float32(2.0 / 3.0))
THIRD = float(np.float32(1.0 / 3.0))


def dim_levels(n: int) -> int:
    return 0 if n < 3 else int(math.ceil(math.log2(n - 1)))


def padded_dim(n: int) -> int:
    k = dim_levels(n)
    return (1 << k) + 1 if k > 0 else n


def _levels(shape):
    ks = [dim_levels(n) for n in shape]
    return [(float(1 << lv), tuple(slice(None, None, 1 << min(lv, k)) for k in ks))
            for lv in range(max(ks))]


def _axes(shape):
    return [a for a, n in enumerate(shape) if n >= 3 and (n - 1) % 2 == 0]


def level_map(padded, device) -> torch.Tensor:
    """Quantization subset of every node: its decomposition level, or L if nodal."""
    ks = [dim_levels(n) for n in padded]
    score = None
    for axis, (n, k) in enumerate(zip(padded, ks)):
        idx = np.arange(n)
        tz = np.zeros(n, dtype=np.int64)
        tz[1:] = [(int(i) & -int(i)).bit_length() - 1 for i in idx[1:]]
        s = np.where((k > 0) & (idx % (1 << max(k, 1)) != 0), tz, np.iinfo(np.int32).max)
        s = torch.from_numpy(s.astype(np.int32)).to(device)
        s = s.reshape([-1 if a == axis else 1 for a in range(len(padded))])
        score = s if score is None else torch.minimum(score, s)
    return score.clamp_max(max(ks)).expand(tuple(padded)).contiguous()


def level_bins(eb: float, levels: int) -> np.ndarray:
    w = np.ones(levels + 1)
    w[levels] = 0.5
    return (2.0 * eb / ((levels + 1) * SAFETY) * w).astype(np.float64)


def _interp(coarse, axis):
    c = coarse.movedim(axis, 0)
    out = torch.empty((2 * (c.shape[0] - 1) + 1,) + tuple(c.shape[1:]), dtype=c.dtype,
                      device=c.device)
    out[0::2] = c
    out[1::2] = 0.5 * (c[:-1] + c[1:])
    return out.movedim(0, axis)


def _mass(x, axis, h):
    v = x.movedim(axis, 0)
    zero = torch.zeros_like(v[:1])
    left = torch.cat([zero, v[:-1]], 0)
    right = torch.cat([v[1:], zero], 0)
    diag = torch.full((v.shape[0],) + (1,) * (v.ndim - 1), TWO_THIRDS, dtype=v.dtype,
                      device=v.device)
    diag[0] = THIRD
    diag[-1] = THIRD
    return (h * (diag * v + SIXTH * (left + right))).movedim(0, axis)


def _restrict(m, axis):
    v = m.movedim(axis, 0)
    odd = v[1::2]
    zero = torch.zeros_like(odd[:1])
    b = v[0::2] + 0.5 * (torch.cat([zero, odd], 0) + torch.cat([odd, zero], 0))
    return b.movedim(0, axis)


def _thomas(n: int, h: float, dtype, device):
    """Forward-elimination constants ``cp`` and ``1 / d'`` (float64 → ``dtype``)."""
    a, c = h / 6.0, h / 6.0
    b = np.full(n, 2.0 * h / 3.0)
    b[0] = b[-1] = h / 3.0
    cp = np.zeros(n)
    dinv = np.zeros(n)
    denom = b[0]
    dinv[0], cp[0] = 1.0 / denom, c / denom
    for i in range(1, n):
        denom = b[i] - a * cp[i - 1]
        dinv[i], cp[i] = 1.0 / denom, c / denom
    cast = (lambda t: torch.from_numpy(t.astype(np.float32)).to(device=device, dtype=dtype))
    return cast(cp), cast(dinv), float(np.float32(h / 6.0))


def _solve(rhs, axis, h):
    """``M x = rhs`` along ``axis``, one Thomas sweep over all other axes."""
    cp, dinv, sub = _thomas(rhs.shape[axis], h, rhs.dtype, rhs.device)
    r = rhs.movedim(axis, 0)
    out = torch.empty_like(r)
    d = torch.zeros_like(r[0])
    for i in range(r.shape[0]):
        d = (r[i] - sub * d) * dinv[i]
        out[i] = d
    x = torch.zeros_like(r[0])
    for i in range(r.shape[0] - 1, -1, -1):
        x = out[i] - cp[i] * x
        out[i] = x
    return out.movedim(0, axis)


def _transfer(mc, axes, h):
    b = mc
    for a in axes:
        b = _restrict(_mass(b, a, h), a)
    for a in axes:
        b = _solve(b, a, 2.0 * h)
    return b


def _coarse(shape, axes):
    return tuple(slice(None, None, 2) if a in axes else slice(None) for a in range(len(shape)))


def decompose(field: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Multilevel coefficients of ``field`` on the padded grid, in ``dtype``."""
    u = field.to(dtype)
    for dim, n in enumerate(u.shape):
        t = padded_dim(n)
        if t != n:
            u = u.index_select(dim, torch.arange(t, device=u.device).clamp_(max=n - 1))
    u = u.contiguous().clone()
    for h, sl in _levels(tuple(field.shape)):
        view = u[sl]
        axes = _axes(tuple(view.shape))
        csl = _coarse(tuple(view.shape), axes)
        coarse = view[csl]
        interp = coarse
        for a in axes:
            interp = _interp(interp, a)
        mc = view - interp
        mc[csl] = coarse + _transfer(mc, axes, h)
        u[sl] = mc
    return u


def recompose(coeffs: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`decompose`: the float32 field of ``shape``."""
    u = coeffs.to(dtype).clone()
    for h, sl in reversed(_levels(tuple(shape))):
        view = u[sl]
        axes = _axes(tuple(view.shape))
        csl = _coarse(tuple(view.shape), axes)
        mc = view.clone()
        mc[csl] = 0.0
        interp = view[csl] - _transfer(mc, axes, h)
        for a in axes:
            interp = _interp(interp, a)
        u[sl] = mc + interp
    return u[tuple(slice(0, n) for n in shape)].to(torch.float32).contiguous()


def _flush(x):
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def quantize(coeffs, lmap, bins_f32):
    """Signed int32 quantized values of float32 ``coeffs`` by their level's bin."""
    x = _flush(coeffs.to(torch.float32)) / _flush(bins_f32)[lmap.to(torch.int64)]
    x = torch.round(x)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big, small = x >= 2.0 ** 31, x < -(2.0 ** 31)
    q = torch.where(big | small, torch.zeros_like(x), x).to(torch.int32)
    q = torch.where(big, torch.full_like(q, 2 ** 31 - 1), q)
    return torch.where(small, torch.full_like(q, -(2 ** 31)), q)


def dequantize(q, lmap, bins_f32):
    return _flush(q.to(torch.float32) * _flush(bins_f32)[lmap.to(torch.int64)])


def zigzag(q):
    return (q << 1) ^ (q >> 31)


def error_bound(field: torch.Tensor, eps: float) -> float:
    vmin, vmax = torch.aminmax(field)
    span = float(np.float32(vmax.item()) - np.float32(vmin.item()))
    eb = eps * span
    return eb if eb > 0 else eps


def compress(field: torch.Tensor, eps: float, dict_size: int, dtype=torch.float32) -> dict:
    """The sections and metadata of the container of ``field`` (arrays on the host)
    and the signed quantized values ``q`` on the field's device."""
    shape = tuple(field.shape)
    padded = tuple(padded_dim(n) for n in shape)
    levels = max(dim_levels(n) for n in padded)
    eb = error_bound(field, eps)
    bins = level_bins(eb, levels)
    bins_f32 = torch.as_tensor(bins, dtype=torch.float32, device=field.device)
    lmap = level_map(padded, field.device)
    q = quantize(decompose(field, dtype), lmap, bins_f32)
    del lmap
    u = zigzag(q).reshape(-1)
    escape = dict_size - 1
    inlier = (u >= 0) & (u < escape)
    keys = torch.where(inlier, u, escape)
    out_idx = torch.nonzero(~inlier).reshape(-1)
    out_val = q.reshape(-1)[out_idx]
    del u, inlier
    freq = huffman.histogram(keys, dict_size)
    lengths, codes = huffman.codebook(freq)
    words, chunk_offsets, total_bits = huffman.pack(keys, lengths, codes, CHUNK)
    return {
        "meta": {"shape": list(shape), "dtype": "float32", "chunk_size": CHUNK,
                 "total_bits": total_bits, "n_symbols": math.prod(padded),
                 "num_keys": dict_size, "padded": list(padded), "error_bound": eb,
                 "dict_size": dict_size},
        "arrays": {"words": words, "chunk_offsets": chunk_offsets,
                   "length_table": lengths.astype(np.int32),
                   "outlier_idx": out_idx.cpu().numpy().astype(np.int64),
                   "outlier_val": out_val.cpu().numpy().astype(np.int32),
                   "bins": bins},
        "q": q,
    }


def reconstruct(q: torch.Tensor, bins: np.ndarray, shape, dtype=torch.float32) -> torch.Tensor:
    """The field that quantized values ``q`` (padded grid) and ``bins`` give back."""
    padded = tuple(q.shape)
    bins_f32 = torch.as_tensor(bins, dtype=torch.float32, device=q.device)
    coeffs = dequantize(q, level_map(padded, q.device), bins_f32)
    return recompose(coeffs, shape, dtype)
