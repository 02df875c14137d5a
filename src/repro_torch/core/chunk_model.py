"""Adaptive chunk sizing — HPDR §V-C (Algorithm 4, Fig. 11); the port's own
copy of ``repro.core.chunk_model`` (numpy only, same arithmetic).

Two estimation functions drive the adaptive pipeline:

  Φ(C)  reduction throughput at chunk size C — the paper's *modified roofline
        model*: linear while the accelerator is under-occupied, constant γ
        once saturated::

            Φ(C) = α·C + β₀   if C < C_threshold
                 = γ          otherwise

  Θ(t)  max bytes transferable host→device in time t: Θ(t) = t / β, with β
        the per-byte transfer cost (interconnect treated as saturated).

Next chunk: C_next = min(Θ(C_curr / Φ(C_curr)), C_limit) — grow the chunk so
its transfer hides entirely under the current chunk's compute.

The model is fitted from profile points exactly as §V-C describes: γ is the
largest-chunk throughput; walk down through smaller chunks until throughput
drops below f·γ (f = 0.1 default); the linear segment is a least-squares fit
over the remaining (smaller) chunk sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PhiModel:
    """Piecewise linear→constant throughput model Φ(C) (bytes/s vs bytes)."""

    alpha: float          # slope of the unsaturated segment ((bytes/s)/byte)
    beta0: float          # intercept (bytes/s)
    gamma: float          # saturated throughput (bytes/s)
    c_threshold: float    # saturation chunk size (bytes)

    def __call__(self, chunk_bytes) -> np.ndarray:
        c = np.asarray(chunk_bytes, dtype=np.float64)
        lin = self.alpha * c + self.beta0
        return np.where(c < self.c_threshold, np.minimum(lin, self.gamma), self.gamma)

    def time_for(self, chunk_bytes: float) -> float:
        return float(chunk_bytes) / float(self(chunk_bytes))


def fit_phi(
    chunk_sizes: np.ndarray, throughputs: np.ndarray, f: float = 0.1
) -> PhiModel:
    """Fit Φ from profile points (paper §V-C fitting procedure).

    Degenerate sweeps fit gracefully instead of raising: a single point or
    an all-saturated (flat) profile yields the constant model Φ ≡ γ; a
    noisy profile whose least-squares slope comes out non-positive is
    likewise treated as saturated (the linear segment carries no signal).
    An all-unsaturated (still-rising) profile fits the linear segment over
    every point and places ``c_threshold`` at the largest observed chunk.
    Empty or non-finite/non-positive profiles raise ``ValueError``.
    """
    c = np.atleast_1d(np.asarray(chunk_sizes, np.float64))
    p = np.atleast_1d(np.asarray(throughputs, np.float64))
    if c.size == 0:
        raise ValueError("fit_phi: need at least one (chunk_size, throughput) "
                         "profile point, got an empty sweep")
    if c.size != p.size:
        raise ValueError(f"fit_phi: {c.size} chunk sizes vs {p.size} "
                         "throughputs — profile arrays must align")
    if not (np.all(np.isfinite(c)) and np.all(np.isfinite(p))):
        raise ValueError("fit_phi: profile points must be finite")
    if np.any(c <= 0) or np.any(p <= 0):
        raise ValueError("fit_phi: chunk sizes and throughputs must be > 0")
    order = np.argsort(c)
    c, p = c[order], p[order]
    gamma = float(p[-1])
    if c.size == 1:
        return PhiModel(alpha=0.0, beta0=gamma, gamma=gamma,
                        c_threshold=float(c[0]))
    # walk down from the largest chunk until throughput < f·gamma
    cut = 0
    for i in range(len(c) - 1, -1, -1):
        if p[i] < f * gamma:
            cut = i + 1
            break
    lin_c, lin_p = c[:max(cut, 2)], p[:max(cut, 2)]
    if len(lin_c) >= 2 and np.ptp(lin_c) > 0:
        alpha, beta0 = np.polyfit(lin_c, lin_p, 1)
    else:  # degenerate profile: flat model
        alpha, beta0 = 0.0, gamma
    if not np.isfinite(alpha) or alpha <= 0:
        # saturated everywhere (or noise-dominated slope): constant Φ ≡ γ
        return PhiModel(alpha=0.0, beta0=gamma, gamma=gamma,
                        c_threshold=float(c[0]))
    c_threshold = float(np.clip((gamma - beta0) / alpha, c[0], c[-1]))
    return PhiModel(alpha=float(alpha), beta0=float(beta0), gamma=gamma,
                    c_threshold=c_threshold)


@dataclass(frozen=True)
class AffineCost:
    """Affine stage-cost model t(C) = t₀ + C/bps.

    The fixed term t₀ captures per-call latency (dispatch, syscall, GIL
    handoff) that dominates tiny chunks — exactly the regime where the
    auto-tuner must notice that pipelining cannot pay for itself.
    """

    t0: float    # fixed seconds per call
    bps: float   # marginal throughput, bytes/s

    def time_for(self, nbytes: float) -> float:
        return self.t0 + float(nbytes) / self.bps


def fit_affine(sizes_bytes: np.ndarray, times_s: np.ndarray) -> AffineCost:
    """Least-squares fit of t = t₀ + C/bps over measured (C, t) points."""
    c = np.atleast_1d(np.asarray(sizes_bytes, np.float64))
    t = np.atleast_1d(np.asarray(times_s, np.float64))
    if c.size == 0 or c.size != t.size:
        raise ValueError("fit_affine: need matched, non-empty size/time arrays")
    if np.any(c <= 0) or np.any(t <= 0) or not np.all(np.isfinite(t)):
        raise ValueError("fit_affine: sizes and times must be finite and > 0")
    if c.size == 1 or np.ptp(c) == 0:
        return AffineCost(t0=0.0, bps=float(c[0] / t[0]))
    slope, t0 = np.polyfit(c, t, 1)
    if not np.isfinite(slope) or slope <= 0:
        # noise-dominated: fall back to the largest point's secant rate
        return AffineCost(t0=0.0, bps=float(c[-1] / t[-1]))
    return AffineCost(t0=float(max(t0, 0.0)), bps=float(1.0 / slope))


@dataclass(frozen=True)
class ThetaModel:
    """Θ(t) = t/β : bytes transferable host→device in time t."""

    beta: float  # seconds per byte (1 / H2D bandwidth)

    def __call__(self, t: float) -> float:
        return float(t) / self.beta

    def time_for(self, nbytes: float) -> float:
        return float(nbytes) * self.beta


def adaptive_chunk_schedule(
    total_bytes: int,
    c_init: int,
    c_limit: int,
    phi: PhiModel,
    theta: ThetaModel,
) -> list[int]:
    """Chunk-size sequence of Algorithm 4 (host-side planning loop).

    Starts small (fast pipeline lead-in), grows each chunk to the largest
    size whose H2D transfer still hides under the current chunk's compute.
    """
    if total_bytes <= 0:
        return []
    sizes = []
    c_curr = int(min(c_init, total_bytes, c_limit))
    rest = total_bytes
    while rest > 0:
        c_curr = min(c_curr, rest)
        sizes.append(c_curr)
        rest -= c_curr
        if rest <= 0:
            break
        compute_t = phi.time_for(c_curr)
        c_next = int(min(theta(compute_t), c_limit, rest))
        c_curr = max(c_next, 1)
    return sizes


def fixed_chunk_schedule(total_bytes: int, chunk: int) -> list[int]:
    sizes = []
    rest = int(total_bytes)
    chunk = int(chunk)
    while rest > 0:
        sizes.append(min(chunk, rest))
        rest -= sizes[-1]
    return sizes
