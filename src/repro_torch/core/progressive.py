"""Progressive multi-precision retrieval — the HP-MDR side of MGARD
(counterpart of ``repro.core.progressive``).

Store a field as a sequence of *precision components*, so a reader fetches
only the bytes a requested error bound needs and refines incrementally
later:

  * ``refactor``          — MGARD-decompose once, then quantize the residual
                            coefficients at a geometric ladder of error
                            bounds (tier 0 coarsest); each tier's keys go
                            through the ``huffman`` codec and become one
                            self-contained, separately addressable component;
  * ``ProgressiveStream`` — the manifest + component blobs, serialisable as
                            a v2 container (per-section crc32) or written as
                            an ``AggregatedWriter`` segment file;
  * ``ProgressiveReader`` — opens either form and answers ``retrieve(err=…)``
                            by pread-ing exactly the component prefix that
                            bound needs; ``refine(err'=…)`` preads only the
                            delta and extends the cached coefficient sum, so
                            earlier bytes are never re-read.

Error contract: after loading tiers ``0..t`` the reconstruction satisfies
``max|x − x̂| ≤ tier_bounds[t]`` — the residual left after tier ``t`` is
exactly tier ``t``'s quantization error.  Retrieval accumulates dequantized
tiers in a fixed coarse→fine order, which makes ``retrieve(e)`` +
``refine(e')`` bit-identical to a direct ``retrieve(e')``.

Every plan resolves through the CMM: the MGARD executables come from the
geometry-keyed ``mgard`` plan (one per shape whatever the bound; on a
``cuda`` plan they launch ``solve_mass`` and the ``quantize_map`` kernels),
and each tier's keys go through ``api.encode``/``api.decode`` on a shared
``huffman`` spec (the ``histogram``, ``encode_lookup`` and
``decode_chunks`` kernels).  The quantized keys, the inlier mask and the
outlier gather stay on the plan's device; only what a component stores
(the entropy sections and the outliers) is copied to the host.  Streams are
the reference's bytes format: either package reads the other's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import api, container, mgard
from .codecs import get_codec
from .codecs.base import ReductionSpec
from .container import Compressed, ContainerError
from .quantize import unsigned_to_signed

METHOD = "mgard-progressive"
DEFAULT_TIERS = 3
DEFAULT_TIER_RATIO = 8.0


def component_name(tier: int) -> str:
    """Canonical section/segment name of one precision component."""
    return f"component/{int(tier):05d}"


def tier_bounds(
    error_bound: float,
    tiers: int = DEFAULT_TIERS,
    tier_ratio: float = DEFAULT_TIER_RATIO,
) -> list[float]:
    """Geometric ladder of absolute bounds, coarsest first; the last entry
    is ``error_bound`` itself (full precision)."""
    eb = float(error_bound)
    tiers = int(tiers)
    ratio = float(tier_ratio)
    if eb <= 0:
        raise ValueError(f"error_bound must be positive, got {eb}")
    if tiers < 1:
        raise ValueError(f"need at least one tier, got {tiers}")
    if ratio <= 1.0:
        raise ValueError(f"tier_ratio must exceed 1, got {ratio}")
    return [eb * ratio ** (tiers - 1 - t) for t in range(tiers)]


def _mgard_plan(shape: tuple[int, ...], dict_size: int, backend=None):
    """CMM-cached MGARD plan keyed on geometry only (no error bound): every
    tier, every retrieval and plain ``mgard`` decoding of the same shape
    share one set of executables and one level map."""
    kwargs = {} if backend is None else {"backend": backend}
    spec = ReductionSpec.create("mgard", shape, "float32", dict_size=int(dict_size), **kwargs)
    return api.get_plan(spec)


def _huffman_spec(n: int, backend=None) -> ReductionSpec:
    """Shared CMM spec for per-tier key streams (one plan per grid size)."""
    kwargs = {} if backend is None else {"backend": backend}
    return get_codec("huffman").make_spec((int(n),), "int32", **kwargs)


def _level_bins(eb: float, L: int, device) -> torch.Tensor:
    return torch.from_numpy(mgard.level_bins(eb, L).astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# stream object: manifest + component blobs
# ---------------------------------------------------------------------------


@dataclass
class ProgressiveStream:
    """A refactored field: JSON-able manifest + per-tier component blobs.

    ``components`` may be a *prefix* of the manifest's tiers (a reader that
    only fetched the coarse tiers still holds a valid stream); component
    ``t`` is a self-contained v2 container (Huffman key stream + outliers).
    """

    manifest: dict
    components: list = field(default_factory=list)

    # ------------------------------------------------------------ accessors

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.manifest["shape"])

    @property
    def padded(self) -> tuple[int, ...]:
        return tuple(self.manifest["padded"])

    @property
    def dict_size(self) -> int:
        return int(self.manifest["dict_size"])

    @property
    def tier_bounds(self) -> list[float]:
        return [float(b) for b in self.manifest["tier_bounds"]]

    @property
    def tiers(self) -> int:
        return len(self.manifest["tier_bounds"])

    def tiers_for(self, err: float | None) -> int:
        """Smallest component prefix whose bound satisfies ``err``."""
        return _tiers_for(self.tier_bounds, err)

    def nbytes_upto(self, k: int) -> int:
        return sum(int(n) for n in self.manifest["component_nbytes"][:k])

    def nbytes(self) -> int:
        return self.nbytes_upto(self.tiers)

    # ----------------------------------------------- monolithic container

    def to_container(self) -> Compressed:
        """One v2 container: manifest in meta, one uint8 section per tier.

        Per-section crc32 entries let :meth:`ProgressiveReader.from_bytes`
        verify and decode a component prefix without touching the later
        sections' bytes.
        """
        arrays = {
            component_name(t): np.frombuffer(blob, np.uint8)
            for t, blob in enumerate(self.components)
        }
        meta = dict(self.manifest)
        meta.setdefault("dtype", "float32")
        return Compressed(method=METHOD, meta=meta, arrays=arrays)

    @classmethod
    def from_container(cls, c: Compressed) -> "ProgressiveStream":
        manifest = {
            k: c.meta[k]
            for k in ("shape", "padded", "L", "dict_size", "tier_bounds", "component_nbytes")
        }
        components = []
        for t in range(len(manifest["tier_bounds"])):
            name = component_name(t)
            if name not in c.arrays:
                break  # a reader may hold only a prefix
            components.append(np.asarray(c.arrays[name], np.uint8).tobytes())
        return cls(manifest=manifest, components=components)

    def to_bytes(self) -> bytes:
        return self.to_container().to_bytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ProgressiveStream":
        return cls.from_container(Compressed.from_bytes(raw))

    # ------------------------------------------------------ aggregated file

    def write(self, path, *, align: int = 4096, **writer_kwargs) -> dict:
        """Write an ``AggregatedWriter`` segment file: one crc-checked
        segment per component, manifest in the directory meta.  Returns the
        writer's closing directory."""
        from ..runtime.io import AggregatedWriter  # lazy: core ↔ runtime

        with AggregatedWriter(
            path, align=align, meta=container._jsonable(self.manifest), **writer_kwargs,
        ) as w:
            for t, blob in enumerate(self.components):
                w.add(component_name(t), blob)
        return w.directory()


def _tiers_for(bounds: list[float], err: float | None) -> int:
    if err is None:
        return len(bounds)
    for k, b in enumerate(bounds, start=1):
        if b <= float(err):
            return k
    return len(bounds)


# ---------------------------------------------------------------------------
# refactor: decompose once, residual-quantize per tier
# ---------------------------------------------------------------------------


def refactor(
    data,
    error_bound: float,
    *,
    tiers: int = DEFAULT_TIERS,
    tier_ratio: float = DEFAULT_TIER_RATIO,
    dict_size: int = 4096,
    backend=None,
) -> ProgressiveStream:
    """Refactor ``data`` (a tensor or array) into ``tiers`` precision
    components.

    ``error_bound`` is the *absolute* L∞ bound of the finest tier; tier
    ``t`` targets ``error_bound * tier_ratio**(tiers-1-t)``.  Each tier
    quantizes the residual the previous tiers left, so components telescope
    and a prefix read honours that prefix's bound exactly.  ``backend``
    binds the plans (``auto``/``None`` is ``cuda``).
    """
    data = api.as_tensor(data)
    shape = tuple(data.shape)
    plan = _mgard_plan(shape, dict_size, backend)
    data = data.to(plan.device, torch.float32)
    padded, L = plan.meta["padded"], plan.meta["L"]
    bounds = tier_bounds(error_bound, tiers, tier_ratio)
    escape = int(dict_size) - 1

    coeffs = plan.executables["decompose"](data)
    partial = None
    hspec = _huffman_spec(max(1, math.prod(padded)), backend)
    components: list[bytes] = []
    for t, eb_t in enumerate(bounds):
        bins = _level_bins(eb_t, L, plan.device)
        residual = coeffs if partial is None else coeffs - partial
        with plan.lock:
            q, keys, inlier, lmap = plan.executables["quantize"](
                residual, plan.workspace["lmap"], bins)
            plan.recycle("lmap", lmap)
        # the outliers are found and gathered where the keys lie; only they
        # cross to the host
        out_idx = torch.nonzero(~inlier.reshape(-1)).reshape(-1)
        out_val = q.reshape(-1)[out_idx]

        c = api.encode(hspec, keys.reshape(-1))
        c.meta.update(tier=t, error_bound=float(eb_t), escape=escape)
        c.arrays.update(outlier_idx=out_idx.cpu().numpy().astype(np.int64),
                        outlier_val=out_val.cpu().numpy().astype(np.int32))
        components.append(c.to_bytes())

        # Advance the encoder's partial with exactly what a reader will
        # reconstruct for this tier (dequantized unclamped q), so the next
        # residual telescopes without drift.
        with plan.lock:
            coeffs_t, lmap = plan.executables["dequantize"](q, plan.workspace["lmap"], bins)
            plan.recycle("lmap", lmap)
        partial = coeffs_t if partial is None else partial + coeffs_t

    manifest = {
        "shape": list(shape),
        "padded": list(padded),
        "L": int(L),
        "dict_size": int(dict_size),
        "tier_bounds": [float(b) for b in bounds],
        "component_nbytes": [len(b) for b in components],
    }
    return ProgressiveStream(manifest=manifest, components=components)


# ---------------------------------------------------------------------------
# retrieval: decode a component prefix, accumulate coarse→fine
# ---------------------------------------------------------------------------


def _component_q(blob: bytes, padded: tuple[int, ...], plan) -> torch.Tensor:
    """Decode one component blob to its signed quantized values, shaped
    ``padded``, on the plan's device."""
    c = Compressed.from_bytes(blob)
    n = math.prod(padded)
    if int(math.prod(c.meta.get("shape", (-1,)))) != n:
        raise ContainerError(
            f"corrupt progressive component: {c.meta.get('shape')} keys for a grid of {n} nodes")
    out_idx = np.ascontiguousarray(
        c.arrays.get("outlier_idx", np.empty(0, np.int64)), np.int64).reshape(-1)
    out_val = np.ascontiguousarray(
        c.arrays.get("outlier_val", np.empty(0, np.int32)), np.int32).reshape(-1)
    # checked on the host: an index past the grid would fault the device
    if out_idx.size != out_val.size or (out_idx.size and (out_idx.min() < 0 or out_idx.max() >= n)):
        raise ContainerError(
            f"corrupt progressive component: {out_idx.size} outlier indices (range "
            f"[{out_idx.min(initial=0)}, {out_idx.max(initial=0)}]) and {out_val.size} values "
            f"for a grid of {n} nodes")
    q = unsigned_to_signed(api.decode(c, plan.spec.backend).reshape(-1))
    if out_idx.size:
        q[torch.from_numpy(out_idx).to(q.device)] = torch.from_numpy(out_val).to(q.device)
    return q.reshape(padded)


def _accumulate(plan, manifest: dict, blobs: list, start: int, coeff_sum):
    """Dequantize components ``start..start+len(blobs)`` into ``coeff_sum``.

    Both the whole-stream path and :meth:`ProgressiveReader.refine` run
    through here, with the same left-to-right float accumulation order —
    that shared order is what makes retrieve+refine bit-identical to a
    direct retrieve at the finer bound.
    """
    padded = tuple(manifest["padded"])
    L = int(manifest["L"])
    bounds = manifest["tier_bounds"]
    for i, blob in enumerate(blobs):
        t = start + i
        q = _component_q(blob, padded, plan)
        bins = _level_bins(float(bounds[t]), L, plan.device)
        with plan.lock:
            coeffs_t, lmap = plan.executables["dequantize"](q, plan.workspace["lmap"], bins)
            plan.recycle("lmap", lmap)
        coeff_sum = coeffs_t if coeff_sum is None else coeff_sum + coeffs_t
    return coeff_sum


def retrieve(
    stream: ProgressiveStream,
    err: float | None = None,
    *,
    tiers: int | None = None,
    backend=None,
) -> torch.Tensor:
    """Reconstruct from the component prefix satisfying ``err`` (or the
    first ``tiers`` components; default: everything the stream holds), as a
    float32 tensor on the plan's device."""
    if tiers is None:
        k = stream.tiers_for(err)
    else:
        k = max(1, min(int(tiers), stream.tiers))
    k = max(1, min(k, len(stream.components)))
    plan = _mgard_plan(stream.shape, stream.dict_size, backend)
    coeff = _accumulate(plan, stream.manifest, stream.components[:k], 0, None)
    return plan.executables["recompose"](coeff)


def error_curve(stream: ProgressiveStream, data, *, backend=None) -> list[dict]:
    """Achieved max-error and cumulative bytes after each component."""
    data = api.as_tensor(data)
    out = []
    for k in range(1, len(stream.components) + 1):
        approx = retrieve(stream, tiers=k, backend=backend)
        ref = data.to(approx.device, torch.float32)
        err = float((approx - ref).abs().max()) if ref.numel() else 0.0
        out.append({"tier": k - 1, "bound": stream.tier_bounds[k - 1],
                    "bytes": stream.nbytes_upto(k), "max_err": err})
    return out


# ---------------------------------------------------------------------------
# reader: prefix preads + delta refinement
# ---------------------------------------------------------------------------


class _SegmentSource:
    """Components from an aggregated segment file (one pread per tier)."""

    def __init__(self, path):
        from ..runtime.io import AggregatedReader  # lazy: core ↔ runtime

        self.reader = AggregatedReader(path)
        self.manifest = dict(self.reader.meta)

    def read(self, tier: int) -> bytes:
        return self.reader.read(component_name(tier))

    def close(self) -> None:
        self.reader.close()


class _SectionSource:
    """Components from a monolithic v2 container held in memory.

    Per-section crc32 entries verify each component alone; streams written
    before per-section checksums fall back to one whole-payload host
    verification (:func:`~repro_torch.core.container.read_section_bytes`).
    """

    def __init__(self, raw: bytes):
        self.raw = bytes(raw)
        header, _ = container.peek_header(self.raw)
        if header["method"] != METHOD:
            raise ContainerError(f"not a progressive stream: method {header['method']!r}")
        self.manifest = dict(header["meta"])

    def read(self, tier: int) -> bytes:
        return container.read_section_bytes(self.raw, component_name(tier))

    def close(self) -> None:
        pass


class ProgressiveReader:
    """Incremental reader: ``retrieve`` fetches a prefix, ``refine`` a delta.

    Accounting attributes:

    * ``bytes_fetched`` — component payload bytes read so far;
    * ``preads``        — component reads issued (one per tier, ever);
    * ``tiers_loaded``  — components decoded into the cached coefficient sum.

    A second call never re-reads earlier components: refinement decodes only
    the new tiers and extends the cached sum in the same accumulation order
    a direct retrieve would use, so the results are bit-identical.
    """

    def __init__(self, path=None, *, backend=None, _source=None):
        self._source = _source if _source is not None else _SegmentSource(path)
        self.manifest = self._source.manifest
        try:
            self._plan = _mgard_plan(
                tuple(self.manifest["shape"]), int(self.manifest["dict_size"]), backend)
        except BaseException:
            self._source.close()
            raise
        self.bytes_fetched = 0
        self.preads = 0
        self.tiers_loaded = 0
        self._coeff = None

    @classmethod
    def from_bytes(cls, raw: bytes, *, backend=None) -> "ProgressiveReader":
        """Reader over a monolithic container blob (section-prefix reads)."""
        return cls(backend=backend, _source=_SectionSource(raw))

    # ------------------------------------------------------------ accessors

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.manifest["shape"])

    @property
    def tier_bounds(self) -> list[float]:
        return [float(b) for b in self.manifest["tier_bounds"]]

    @property
    def tiers(self) -> int:
        return len(self.manifest["tier_bounds"])

    def tiers_for(self, err: float | None) -> int:
        return _tiers_for(self.tier_bounds, err)

    # ------------------------------------------------------------- retrieval

    def _load_upto(self, k: int) -> None:
        blobs = []
        for t in range(self.tiers_loaded, k):
            blob = self._source.read(t)  # crc-checked, names the component
            self.bytes_fetched += len(blob)
            self.preads += 1
            blobs.append(blob)
        if blobs:
            self._coeff = _accumulate(
                self._plan, self.manifest, blobs, self.tiers_loaded, self._coeff)
            self.tiers_loaded = k

    def retrieve(self, err: float | None = None, *, tiers: int | None = None) -> torch.Tensor:
        """Reconstruct at ``err`` (or a component count), fetching only the
        not-yet-loaded part of the needed prefix."""
        if tiers is None:
            k = self.tiers_for(err)
        else:
            k = max(1, min(int(tiers), self.tiers))
        # never discard precision already paid for: a coarser second call
        # reuses the finer cached sum (still within the requested bound)
        self._load_upto(max(k, self.tiers_loaded))
        return self._plan.executables["recompose"](self._coeff)

    def refine(self, err: float | None = None, *, tiers: int | None = None) -> torch.Tensor:
        """Tighten a previous retrieval; reads only the delta components."""
        return self.retrieve(err, tiers=tiers)

    # -------------------------------------------------------------- lifecycle

    def close(self) -> None:
        self._source.close()

    def __enter__(self) -> "ProgressiveReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
