"""MGARD-X lossy compression in PyTorch (counterpart of ``repro.core.mgard``).

Multigrid decomposition on uniform tensor grids: for each level l (fine →
coarse),

  1. ``lerp``        multilinear-interpolation coefficients mc = (I − Π) u;
  2. ``mass_trans``  load vector b = R · M_f · mc;
  3. ``tridiag``     correction c = M_c^{-1} b, solved dimension by
                     dimension (the mass matrix of multilinear elements is a
                     Kronecker product) — the ``tridiag`` kernel on a CUDA
                     tensor, the plain sweep on a CPU tensor;
  4. ``add``         coarse values += c;

then per-level linear quantization (the ``quantize_map`` kernels), which
the codec (``codecs/mgard_codec.py``) follows with the Huffman entropy tail.
The plan-bound quantize/dequantize executables
(:func:`planned_quantize_stage`, :func:`planned_dequantize_stage`) are what
the progressive tier (``core/progressive.py``) runs per precision tier.
The reference's standalone :func:`compress` / :func:`decompress` (paper
Algorithm 1 end to end, :class:`MGARDCompressed`) run the codec's stages
where the data lies: the decomposition's solves (the ``tridiag`` kernel on
a CUDA tensor), the planned quantize and dequantize stages (the
``quantize_map`` kernels there), the codec's outlier split
(:func:`split_outliers`) and the entropy tail (``huffman.compress``: the
``histogram``, ``encode_lookup`` and ``decode_chunks`` kernels there).
Their stream equals the ``mgard`` codec's container on the same device at
the same absolute bound.

Grid handling: each dim is edge-padded to 2^k+1, and dims stop decomposing
when they reach 2 nodes.  Level-l coefficients stay at their node positions
(stride-2^l nodes with an odd view coordinate); the level map is a
closed-form function of the index's trailing zeros.

Every operator is written with separate ``+``, ``−`` and ``×`` tensor
operations (no fused forms), so the CPU and the card round each one alike
and a stream does not depend on the device that wrote it.  Compared with the
reference (XLA, which flushes subnormals), coefficients agree to a float32
rounding, not bit for bit.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import Any

import numpy as np
import torch

from . import adapters, huffman
from .quantize import unsigned_to_signed

# float32 constants of the mass matrix, as the reference rounds them.  A
# product with a float32-exact scalar is the same whether the scalar is taken
# as float32 or float64 (the exact product fits a double), so these stay
# Python floats and never cross to the device.
_SIXTH = float(np.float32(1.0 / 6.0))
_TWO_THIRDS = float(np.float32(2.0 / 3.0))
_THIRD = float(np.float32(1.0 / 3.0))

# ---------------------------------------------------------------------------
# dyadic grid bookkeeping
# ---------------------------------------------------------------------------


def dim_levels(n: int) -> int:
    """k such that the padded dim is 2^k + 1 (0 for dims too small to split)."""
    if n < 3:
        return 0
    return int(math.ceil(math.log2(n - 1)))


def padded_dim(n: int) -> int:
    k = dim_levels(n)
    return (1 << k) + 1 if k > 0 else n


def pad_to_dyadic(u: torch.Tensor) -> torch.Tensor:
    """Edge-pad every dim of ``u`` to its dyadic size (repeat the last entry)."""
    for dim, n in enumerate(u.shape):
        t = padded_dim(n)
        if t != n:
            idx = torch.arange(t, device=u.device).clamp_(max=n - 1)
            u = u.index_select(dim, idx)
    return u


def total_levels(shape: tuple[int, ...]) -> int:
    return max(dim_levels(n) for n in shape)


@lru_cache(maxsize=None)
def _level_scores_1d(n: int, k: int) -> np.ndarray:
    """Per-index decomposition step score along one dim (∞ → stays nodal)."""
    idx = np.arange(n)
    tz = np.zeros(n, dtype=np.int64)
    nz = idx > 0
    tz[nz] = np.array([int(i & -i).bit_length() - 1 for i in idx[nz]])
    score = np.where((k > 0) & (idx % (1 << max(k, 1)) != 0), tz, np.iinfo(np.int32).max)
    return score.astype(np.int32)


def level_map(shape: tuple[int, ...], device=None) -> torch.Tensor:
    """Map node → quantization subset id: step l (0..L-1) or L for nodal
    values; int32, made on ``device`` (by default the CPU) from the 1-D
    scores (a broadcast minimum there: no full-grid host array or copy)."""
    ks = [dim_levels(n) for n in shape]
    score = None
    for axis, (n, k) in enumerate(zip(shape, ks)):
        s = torch.from_numpy(_level_scores_1d(n, k)).to(device)
        s = s.reshape([-1 if a == axis else 1 for a in range(len(shape))])
        score = s if score is None else torch.minimum(score, s)
    return score.clamp_max(max(ks)).expand(shape).contiguous()


def _levels(shape: tuple[int, ...]) -> list[tuple[float, tuple[slice, ...]]]:
    """``(h, strided slice)`` of each decomposition level l, fine → coarse:
    ``h = 2^l`` and stride ``2^min(l, k)`` along a dim of k levels."""
    ks = [dim_levels(n) for n in shape]
    return [(float(1 << l), tuple(slice(None, None, 1 << min(l, k)) for k in ks))
            for l in range(max(ks))]


def _participating(shape: tuple[int, ...]) -> list[int]:
    """Axes with an odd-size view ≥ 3 (still decomposable)."""
    return [a for a, n in enumerate(shape) if n >= 3 and (n - 1) % 2 == 0]


# ---------------------------------------------------------------------------
# 1-D operators (applied per axis; tensor-product structure)
# ---------------------------------------------------------------------------


def interp_1d(coarse: torch.Tensor, axis: int) -> torch.Tensor:
    """Prolongation along ``axis``: size m+1 → 2m+1 (linear midpoints)."""
    c = coarse.movedim(axis, 0)
    mids = 0.5 * (c[:-1] + c[1:])
    out = torch.empty((2 * (c.shape[0] - 1) + 1,) + tuple(c.shape[1:]),
                      dtype=c.dtype, device=c.device)
    out[0::2] = c
    out[1::2] = mids
    return out.movedim(0, axis)


def mass_mult_1d(x: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """y = M x along ``axis``; M = h·tridiag(1/6, 2/3, 1/6), boundary h/3."""
    v = x.movedim(axis, 0)
    n = v.shape[0]
    zero = torch.zeros_like(v[:1])
    left = torch.cat([zero, v[:-1]], dim=0)
    right = torch.cat([v[1:], zero], dim=0)
    diag = torch.full((n,) + (1,) * (v.ndim - 1), _TWO_THIRDS, dtype=v.dtype, device=v.device)
    diag[0] = _THIRD
    diag[-1] = _THIRD
    y = h * (diag * v + _SIXTH * (left + right))
    return y.movedim(0, axis)


def restrict_1d(m: torch.Tensor, axis: int) -> torch.Tensor:
    """R = P^T along ``axis``: size 2m+1 → m+1: b_j = m_2j + ½(m_2j−1 + m_2j+1)."""
    v = m.movedim(axis, 0)
    even = v[0::2]
    odd = v[1::2]
    zero = torch.zeros_like(odd[:1])
    left = torch.cat([zero, odd], dim=0)   # odd node left of coarse j
    right = torch.cat([odd, zero], dim=0)  # odd node right of coarse j
    b = even + 0.5 * (left + right)
    return b.movedim(0, axis)


@lru_cache(maxsize=None)
def _thomas_coeffs(n: int, h: float) -> tuple[np.ndarray, np.ndarray]:
    """Thomas forward-elimination constants of the 1-D mass matrix, in
    float64: ``cp[i] = c_i / d'_i`` and ``denom_inv[i] = 1 / d'_i``.

    Data-independent (the solver context a plan keeps), so each sweep step
    is one multiply and one subtract.
    """
    a = np.full(n, h / 6.0)  # sub-diagonal
    b = np.full(n, 2.0 * h / 3.0)
    b[0] = b[-1] = h / 3.0
    c = np.full(n, h / 6.0)  # super-diagonal
    cp = np.zeros(n)
    denom_inv = np.zeros(n)
    denom = b[0]
    denom_inv[0] = 1.0 / denom
    cp[0] = c[0] / denom
    for i in range(1, n):
        denom = b[i] - a[i] * cp[i - 1]
        denom_inv[i] = 1.0 / denom
        cp[i] = c[i] / denom
    return cp, denom_inv


def thomas_tables(n: int, h: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cp, dinv)`` of :func:`_thomas_coeffs`, rounded to float32, on ``device``."""
    cp, dinv = _thomas_coeffs(int(n), float(h))
    return (torch.from_numpy(cp.astype(np.float32)).to(device),
            torch.from_numpy(dinv.astype(np.float32)).to(device))


def thomas_sub(h: float) -> float:
    """The sub-diagonal ``h / 6`` as the float32 the sweep multiplies by."""
    return float(np.float32(h / 6.0))


ThomasTables = dict[tuple[int, float], tuple[torch.Tensor, torch.Tensor]]


def plan_thomas_tables(shape: tuple[int, ...], device) -> ThomasTables:
    """Every ``(n, h)`` solver context that decomposing a grid of ``shape``
    uses, staged once on ``device`` (a plan's persistent workspace)."""
    padded = tuple(padded_dim(n) for n in shape)
    tables: ThomasTables = {}
    for h, sl in _levels(shape):
        view = tuple(len(range(n)[s]) for n, s in zip(padded, sl))
        for a in _participating(view):
            n = (view[a] - 1) // 2 + 1
            if (n, 2.0 * h) not in tables:
                tables[(n, 2.0 * h)] = thomas_tables(n, 2.0 * h, device)
    return tables


def tridiag_solve_1d(rhs: torch.Tensor, axis: int, h: float,
                     thomas: ThomasTables | None = None) -> torch.Tensor:
    """Solve M x = rhs along ``axis`` (Thomas; the Iterative abstraction).

    ``rhs`` is viewed as ``(P, n, Q)`` with the solve axis in the middle, the
    ``tridiag`` kernel's layout, so no axis is moved (only an ``rhs`` that is
    not contiguous is copied, as it lies); a CUDA tensor launches the kernel
    (or raises), a CPU tensor runs the plain sweep.  Both round every step alike, so the result does not
    depend on the device.  Returns a contiguous tensor of ``rhs``'s shape.
    """
    from ..kernels.tridiag import kernel as tridiag_kernel  # lazy: layer order

    shape = tuple(rhs.shape)
    axis = axis % len(shape)
    n = shape[axis]
    p, q = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    coeffs = thomas.get((n, float(h))) if thomas is not None else None
    x = tridiag_kernel.solve_columns(rhs.contiguous().view(p, n, q), h, coeffs)
    return x.view(shape)


# ---------------------------------------------------------------------------
# per-level decompose / recompose
# ---------------------------------------------------------------------------


def _coarse_slice(shape: tuple[int, ...], axes: list[int]) -> tuple[slice, ...]:
    return tuple(slice(None, None, 2) if a in axes else slice(None) for a in range(len(shape)))


def _mass_transfer(mc: torch.Tensor, axes: list[int], h: float,
                   thomas: ThomasTables | None) -> torch.Tensor:
    """c = M_c^{-1} · R · M_f · mc (dimension by dimension)."""
    b = mc
    for a in axes:
        b = restrict_1d(mass_mult_1d(b, a, h), a)
    c = b
    for a in axes:
        c = tridiag_solve_1d(c, a, 2.0 * h, thomas)
    return c


def _decompose_level(view: torch.Tensor, h: float,
                     thomas: ThomasTables | None = None) -> torch.Tensor:
    """One level of MGARD decomposition on the current strided view."""
    axes = _participating(tuple(view.shape))
    sl = _coarse_slice(tuple(view.shape), axes)
    coarse = view[sl]
    interp = coarse
    for a in axes:
        interp = interp_1d(interp, a)
    mc = view - interp
    corrected = coarse + _mass_transfer(mc, axes, h, thomas)
    mc[sl] = corrected
    return mc


def _recompose_level(view: torch.Tensor, h: float,
                     thomas: ThomasTables | None = None) -> torch.Tensor:
    """Exact inverse of :func:`_decompose_level`."""
    axes = _participating(tuple(view.shape))
    sl = _coarse_slice(tuple(view.shape), axes)
    mc = view.clone()
    mc[sl] = 0.0
    coarse = view[sl] - _mass_transfer(mc, axes, h, thomas)
    interp = coarse
    for a in axes:
        interp = interp_1d(interp, a)
    # coarse nodes: mc was zeroed there and interp(coarse) = coarse → exact
    return mc + interp


class GraphedTransform:
    """``fn(x, *args)`` on a CUDA tensor, replayed from a CUDA graph.

    A chunk's :func:`decompose` or :func:`recompose` is some 700 small torch
    operations; launched one by one from a stream's compute lane, their host
    cost, not the card, sets the lane's pace.  The first call of an input
    shape runs ``fn`` as it is (it loads the kernels); the second captures
    it once, on a side stream, into a graph with a static input and output;
    every later call copies its input in, replays the graph on the current
    stream and returns a copy of the output.  A replay waits on the event
    recorded after the previous replay's output copy, so threads may share
    one instance.  The kernels are the eager call's, so the values are the
    same bit for bit.  ``args`` are the same at every call (a plan's
    tables).  A CPU tensor runs ``fn``.
    """

    def __init__(self, fn):
        self.fn = fn
        self._lock = threading.Lock()
        self._graphs: dict[tuple, Any] = {}

    def __call__(self, x: torch.Tensor, *args) -> torch.Tensor:
        if not x.is_cuda:
            return self.fn(x, *args)
        key = (tuple(x.shape), x.stride(), x.dtype, x.device)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                self._graphs[key] = "eager"
                return self.fn(x, *args)
            if entry == "eager":
                entry = self._graphs[key] = self._capture(x, args)
            stream = torch.cuda.current_stream(x.device)
            if entry["done"] is not None:
                stream.wait_event(entry["done"])
            entry["input"].copy_(x)
            entry["graph"].replay()
            out = entry["output"].clone()
            entry["done"] = torch.cuda.Event()
            entry["done"].record(stream)
            _count_replayed(entry["launches"])
            return out

    def _capture(self, x: torch.Tensor, args: tuple) -> dict:
        from ..kernels.tridiag import kernel as tridiag_kernel  # lazy: layer order

        current = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            static_in = x.clone()
            graph = torch.cuda.CUDAGraph()
            before = dict(tridiag_kernel.launches)
            # thread-local: the stream's other lanes go on copying meanwhile
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = self.fn(static_in, *args)
            finally:
                graph.capture_end()
            captured = {k: tridiag_kernel.launches[k] - n for k, n in before.items()}
            _count_replayed({k: -n for k, n in captured.items()})  # captured, not run
        current.wait_stream(side)
        return {"graph": graph, "input": static_in, "output": static_out,
                "launches": captured, "done": None}


def _count_replayed(counts: dict[str, int]) -> None:
    """Add a replay's kernel launches to the ``tridiag`` wrapper's counters."""
    from ..kernels import _launch  # lazy: layer order
    from ..kernels.tridiag import kernel as tridiag_kernel

    with _launch._COUNT_LOCK:
        for k, n in counts.items():
            tridiag_kernel.launches[k] += n


def decompose(u: torch.Tensor, shape: tuple[int, ...],
              thomas: ThomasTables | None = None) -> torch.Tensor:
    """Full multilevel decomposition, coefficients in place, on ``u``'s device.

    Returns a new float32 tensor of the padded shape; ``u`` is not changed.
    Each level's result is written in place into a strided view of that
    tensor (the reference's ``u.at[sl].set``).  ``thomas`` is the plan's
    solver context (:func:`plan_thomas_tables`); missing entries are built
    per call.
    """
    src = u
    u = pad_to_dyadic(u.reshape(shape).to(torch.float32)).contiguous()
    if u.data_ptr() == src.data_ptr():
        u = u.clone()
    for h, sl in _levels(tuple(shape)):
        u[sl] = _decompose_level(u[sl], h, thomas)
    return u


def recompose(coeffs: torch.Tensor, shape: tuple[int, ...],
              thomas: ThomasTables | None = None) -> torch.Tensor:
    """Inverse of :func:`decompose`; a float32 tensor of the original ``shape``.

    Works on a copy of ``coeffs``, each level written in place into its
    strided view.
    """
    u = coeffs.to(torch.float32).clone()
    for h, sl in reversed(_levels(tuple(shape))):
        u[sl] = _recompose_level(u[sl], h, thomas)
    return u[tuple(slice(0, n) for n in shape)].contiguous()


# ---------------------------------------------------------------------------
# the quantization step of the codec (Map&Process)
# ---------------------------------------------------------------------------

# Empirically calibrated L∞ safety factor of the per-level bin schedule (the
# reference's): covers the interpolation gain plus the correction feedback
# of the quantization noise during recomposition.
_SAFETY = 2.0


def level_bins(eb: float, L: int) -> np.ndarray:
    """Per-level quantization bin sizes τ_l: the budget split evenly over the
    L+1 levels, the nodal (coarsest) subset with a tighter bin."""
    w = np.ones(L + 1)
    w[L] = 0.5  # nodal values: tighter bin (seed of the recomposition)
    return (2.0 * eb / ((L + 1) * _SAFETY) * w).astype(np.float64)


@dataclass
class MGARDCompressed:
    """A standalone MGARD-X stream (:func:`compress`): the entropy-coded keys,
    the outliers on the padded grid and the per-level bins."""

    entropy: huffman.Encoded
    outlier_idx: torch.Tensor    # int64[n_out] flat indices (padded grid)
    outlier_val: torch.Tensor    # int32[n_out] quantized values
    bins: np.ndarray             # float64[L+1]
    shape: tuple[int, ...]
    padded: tuple[int, ...]
    error_bound: float
    dict_size: int
    dtype: str = "float32"

    def nbytes(self) -> int:
        return int(self.entropy.nbytes() + self.outlier_idx.nbytes
                   + self.outlier_val.nbytes + self.bins.nbytes)


def _quantize_stage_impl(coeffs, lmap, bins, shape, dict_size, adapter):
    """``(q, keys, inlier)``: the signed quantized values, the Huffman keys
    (escape key ``dict_size - 1`` for outliers) and the inlier mask.

    ``adapter`` binds the ``quantize_map`` kernel.  Keys are uint32 bits in
    int32, so the escape test compares as unsigned: a zig-zagged key of
    2^31 or more is negative here and escapes too.
    """
    from ..kernels.quantize_map import ops as quantize_ops  # lazy: layer order

    u = quantize_ops.quantize(coeffs, lmap, bins, adapter=adapter).reshape(shape)
    q = unsigned_to_signed(u)
    escape = dict_size - 1
    inlier = (u >= 0) & (u < escape)
    keys = torch.where(inlier, u, escape)
    return q, keys, inlier


def split_outliers(q: torch.Tensor, inlier: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The escaped nodes, stored losslessly (sparse) as MGARD's escape path:
    their flat int64 indices on the padded grid and their int32 values."""
    where = torch.nonzero(~inlier.reshape(-1)).reshape(-1)
    return where, q.reshape(-1)[where].to(torch.int32)


def planned_quantize_stage(shape: tuple[int, ...], dict_size: int, adapter: str):
    """Plan-bound quantize executable: ``(coeffs, lmap, bins) -> (q, keys,
    inlier, lmap)``, the ``quantize_map`` kernel on a CUDA plan.

    The level map comes back as the last output, the reference's donation
    contract; the plan re-stores it (``ReductionPlan.recycle``).  PyTorch
    has no donation, so it is the same tensor.
    """

    def stage(coeffs, lmap, bins):
        q, keys, inlier = _quantize_stage_impl(coeffs, lmap, bins, shape, dict_size, adapter)
        return q, keys, inlier, lmap

    return stage


def planned_dequantize_stage(adapter: str):
    """Plan-bound dequantize executable: signed ``q`` → ``(coeffs, lmap)``
    (the level map handed back as in :func:`planned_quantize_stage`)."""

    def stage(q, lmap, bins):
        from ..kernels.quantize_map import ops as quantize_ops  # lazy: layer order
        from .quantize import signed_to_unsigned

        coeffs = quantize_ops.dequantize(signed_to_unsigned(q), lmap, bins, adapter=adapter)
        return coeffs.reshape(q.shape), lmap

    return stage


# ---------------------------------------------------------------------------
# the standalone end-to-end path (paper Algorithm 1)
# ---------------------------------------------------------------------------


def compress(
    data: torch.Tensor,
    error_bound: float,
    dict_size: int = 4096,
    chunk_size: int = huffman.DEFAULT_CHUNK,
    device=None,
) -> MGARDCompressed:
    """MGARD-X end-to-end compression (paper Algorithm 1) at the absolute
    ``error_bound``, where ``data`` lies (other data: on ``device``, by
    default the card; ``api.place``).  Outliers are stored losslessly
    (sparse), as MGARD's escape path.  The record keeps the input's dtype,
    a 64-bit one too, as :func:`repro_torch.core.zfp.compress` does."""
    from .api import dtype_name, place  # lazy: api sits above this module

    dtype = dtype_name(data)
    data = place(data, device)
    shape = tuple(data.shape)
    coeffs = decompose(data, shape)
    padded = tuple(coeffs.shape)
    bins = level_bins(error_bound, total_levels(padded))
    quantize = planned_quantize_stage(padded, dict_size, adapters.for_tensor(None, coeffs))
    q, keys, inlier, _ = quantize(
        coeffs, level_map(padded, coeffs.device),
        torch.as_tensor(bins, dtype=torch.float32, device=coeffs.device))
    out_idx, out_val = split_outliers(q, inlier)
    enc = huffman.compress(keys, dict_size, chunk_size=chunk_size)
    return MGARDCompressed(
        entropy=enc, outlier_idx=out_idx, outlier_val=out_val, bins=bins, shape=shape,
        padded=padded, error_bound=float(error_bound), dict_size=dict_size,
        dtype=dtype,
    )


def decompress(obj: MGARDCompressed) -> torch.Tensor:
    """Inverse of :func:`compress`, on the stream's device: the outliers are
    scattered into the decoded keys there, then the planned dequantize
    stage and the recomposition run there; a 64-bit record comes back as
    its 32-bit type (``api.canonical_dtype``)."""
    from .api import canonical_dtype  # lazy: api sits above this module
    from .stages.library import float32_to  # lazy: stages sit above this module

    keys = huffman.decompress(obj.entropy)
    q = unsigned_to_signed(keys).reshape(-1)  # a new tensor: the scatter is its own
    q[obj.outlier_idx.to(q.device)] = obj.outlier_val.to(device=q.device, dtype=torch.int32)
    dequantize = planned_dequantize_stage(adapters.for_tensor(None, q))
    coeffs, _ = dequantize(q.reshape(obj.padded), level_map(obj.padded, q.device),
                           torch.as_tensor(obj.bins, dtype=torch.float32, device=q.device))
    return float32_to(recompose(coeffs, obj.shape), canonical_dtype(obj.dtype))


def compression_ratio(obj: MGARDCompressed) -> float:
    orig = math.prod(obj.shape) * torch.empty((), dtype=getattr(torch, obj.dtype)).element_size()
    return orig / obj.nbytes()
