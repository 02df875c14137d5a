"""Public HPDR compression API in PyTorch — codec registry + plan architecture.

Counterpart of ``repro.core.api`` (the subset the ported codecs need):

  1. **Specify** — :class:`ReductionSpec`: method, shape, dtype, parameters
     and backend; its ``key()`` is the CMM context key.
  2. **Plan** — :func:`get_plan` builds the codec's :class:`ReductionPlan`
     once per spec and keeps it in the global CMM.
  3. **Execute** — :func:`encode`/:func:`decode` run the plan and produce /
     consume :class:`Compressed` containers, byte-identical to the
     reference's.

  4. **Fan out** — :func:`compress_pytree`/:func:`decompress_pytree` run a
     nested ``dict``/``list``/``tuple`` of arrays or tensors on an
     :class:`~repro_torch.core.engine.ExecutionEngine`.
  5. **Stream** — :class:`CompressorStream` compresses one large array in
     chunks on the HDEM :class:`~repro_torch.core.pipeline.ChunkedPipeline`
     (page-locked staging, a copy stream, compute and io lanes), with its
     own framed byte format and aggregated file layout.

Entry points run on the CUDA card (backend ``auto`` = ``cuda``) unless the
caller passes ``backend="torch"``, which runs the plain versions on the CPU.
:func:`decode` returns a tensor on the plan's device.

Methods: ``mgard`` (the default), ``mgard-progressive``, ``zfp``,
``huffman`` and ``huffman-bytes``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import OrderedDict
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ..runtime.trace import span
from . import adapters
from . import pipeline as pl
from .codecs import available_methods, get_codec  # noqa: F401
from .codecs.base import Codec, ReductionPlan, ReductionSpec  # noqa: F401
from .codecs.huffman_codec import INT_DTYPES, byte_view
from .container import Compressed, ContainerError  # noqa: F401
from .context import GLOBAL_CMM, ReductionContext
from .stages.base import CallEnv, TransferStats

# numpy dtype names of the torch dtypes (container meta uses numpy's names)
_NP_NAMES = {
    torch.float16: "float16", torch.bfloat16: "bfloat16", torch.float32: "float32",
    torch.float64: "float64", torch.int8: "int8", torch.uint8: "uint8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
    torch.bool: "bool",
}
# the reference runs JAX with 64-bit types off: its ``jnp.asarray`` narrows
_CANONICAL = {"float64": "float32", "int64": "int32", "uint64": "uint32"}

METHODS = ("mgard", "mgard-progressive", "zfp", "huffman", "huffman-bytes")

_STREAM_MAGIC = b"HPDS"
_STREAM_VERSION = 1


def dtype_name(data: Any) -> str:
    """numpy name of ``data``'s dtype (``"float32"``, ``"bfloat16"``, ...)."""
    dtype = data.dtype
    return _NP_NAMES[dtype] if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))


def canonical_dtype(name: str) -> torch.dtype:
    """The torch dtype that an array recorded as numpy dtype ``name`` comes
    back in: float64, int64 and uint64 as their 32-bit types, as the
    reference's ``astype`` gives them without 64-bit types."""
    return getattr(torch, _CANONICAL.get(name, name))


def as_tensor(data: Any) -> torch.Tensor:
    """``data`` as a tensor with the reference's canonical dtype.

    The reference's ``compress`` goes through ``jnp.asarray``, so a float64
    input is compressed (and recorded) as float32, and int64/uint64 as
    int32/uint32 (with wrap); the port does the same.  A numpy bfloat16
    array (``ml_dtypes``) becomes a torch bfloat16 tensor.
    """
    data = pl.host_tensor(data)
    name = _CANONICAL.get(dtype_name(data))
    if name is not None:
        data = data.to(getattr(torch, name))
    return data


def place(data: Any, device: Any = None) -> torch.Tensor:
    """``data`` as a tensor with the canonical dtype (:func:`as_tensor`) for
    the standalone entry points (``zfp.compress``, ``mgard.compress``): a
    tensor stays where it lies unless ``device`` is given; any other data
    goes to ``device``, by default the card (raising without one, as the
    ``auto`` backend does)."""
    was_tensor = isinstance(data, torch.Tensor)
    data = as_tensor(data)
    if device is None and not was_tensor:
        device = adapters.device_for(adapters.AUTO)
    return data if device is None else data.to(device)


# ---------------------------------------------------------------------------
# spec / plan resolution (CMM-backed)
# ---------------------------------------------------------------------------


def make_spec(data: Any, method: str, **params: Any) -> ReductionSpec:
    """Build the canonical spec for compressing ``data`` with ``method``."""
    codec = get_codec(method)
    return codec.make_spec(tuple(data.shape), dtype_name(data), **params)


def _build_context(key, codec: Codec, spec: ReductionSpec) -> ReductionContext:
    with span("api.plan_build"):  # one a CMM miss
        plan = codec.plan(spec)
        if plan.device.type == "cuda":
            # the plan's tables were copied on this thread's stream; other
            # threads' streams read them as soon as the CMM holds the plan
            torch.cuda.current_stream(plan.device).synchronize()
    return ReductionContext(key=key, plan=plan, buffers=plan.workspace)


def get_plan(spec: ReductionSpec) -> ReductionPlan:
    """CMM-cached plan for ``spec``; built by the codec on the first miss."""
    codec = get_codec(spec.method)
    key = spec.key()
    ctx = GLOBAL_CMM.get_or_create(key, lambda: _build_context(key, codec, spec))
    return ctx.plan


def encode(spec: ReductionSpec, data: Any) -> Compressed:
    """Compress ``data`` according to ``spec`` (plan reused via the CMM)."""
    with span("api.encode"):
        return get_codec(spec.method).encode(get_plan(spec), as_tensor(data))


def encode_profiled(
    spec: ReductionSpec, data: Any
) -> tuple[Compressed, dict[str, float], TransferStats]:
    """Encode with per-stage wall seconds and host↔device transfer bytes."""
    with span("api.encode"):
        codec = get_codec(spec.method)
        plan = get_plan(spec)
        env = CallEnv(plan)
        profile: dict[str, float] = {}
        c = codec.encode(plan, as_tensor(data), env=env, profile=profile)
    return c, profile, env.transfers


def _decode_plan(c: Compressed, backend: str | None) -> tuple[Codec, ReductionPlan]:
    codec = get_codec(c.method)
    spec = codec.decode_spec(c)
    if backend is not None:
        spec = dataclasses.replace(spec, backend=adapters.resolve_backend(backend))
    return codec, get_plan(spec)


def decode(c: Compressed, backend: str | None = None) -> torch.Tensor:
    """Decompress a container into a tensor on the decode plan's device.

    Any backend decodes any stream; ``backend`` defaults to ``auto``
    (``cuda``).
    """
    with span("api.decode"):
        codec, plan = _decode_plan(c, backend)
        return codec.decode(plan, c)


def decode_profiled(
    c: Compressed, backend: str | None = None
) -> tuple[torch.Tensor, dict[str, float], TransferStats]:
    """Decode with per-stage wall seconds and host↔device transfer bytes."""
    with span("api.decode"):
        codec, plan = _decode_plan(c, backend)
        env = CallEnv(plan)
        profile: dict[str, float] = {}
        out = codec.decode(plan, c, env=env, profile=profile)
    return out, profile, env.transfers


# ---------------------------------------------------------------------------
# compress / decompress — thin wrappers over the registry
# ---------------------------------------------------------------------------


def compress(
    data: Any,
    method: str = "mgard",
    *,
    error_bound: float = 1e-2,
    relative: bool = True,
    rate: int = 16,
    dict_size: int = 4096,
    tiers: int = 3,
    tier_ratio: float = 8.0,
    backend: str | None = None,
    adapter: str | None = None,
) -> Compressed:
    """Compress ``data`` (a tensor or array) with the selected method.

    Takes the reference's keywords so calls written for it run unchanged;
    those the method does not use are dropped.  The default method is
    ``mgard``, as in the reference; ``error_bound`` is relative to the value
    range when ``relative=True``.  ``backend`` (alias: ``adapter``) binds
    the plan: ``auto`` (``cuda``), ``cuda`` or ``torch``.
    """
    data = as_tensor(data)
    spec = make_spec(
        data, method,
        error_bound=error_bound, relative=relative, rate=rate,
        dict_size=dict_size, tiers=tiers, tier_ratio=tier_ratio,
        backend=backend or adapter or adapters.AUTO,
    )
    return encode(spec, data)


def decompress(c: Compressed, backend: str | None = None) -> torch.Tensor:
    return decode(c, backend)


# ---------------------------------------------------------------------------
# leaf policy helpers (shared by checkpoint + serving layers)
# ---------------------------------------------------------------------------


def as_blocked_3d(flat: torch.Tensor) -> torch.Tensor:
    """Flat → (n, 32, 32) (edge-padded to 1024-multiples): ZFP blocks become
    4³ so the per-block emax header is amortised over 64 values."""
    x = flat.reshape(-1)
    pad = (-x.numel()) % 1024
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    return x.reshape(-1, 32, 32)


_HUFFMAN_MAX_ALPHABET = 1 << 16


def leaf_policy(
    arr: Any, method: str, params: dict | None = None
) -> tuple[torch.Tensor, str, dict]:
    """Shared shape/dtype policy: ``(tensor, method, params)`` to compress.

    The reference's policy: floating inputs (bfloat16 included) of the lossy
    codecs are cast to float32; ``zfp`` inputs are re-blocked to
    (n, 32, 32) and >4-D or 0-D ``mgard``/``mgard-progressive`` inputs
    flattened;
    ``huffman`` keeps genuine small-alphabet integer keys (non-negative,
    below 2^16) on the integer-key codec; anything else becomes a
    ``huffman-bytes`` byte view of the original tensor, taken where it lies.
    """
    params = dict(params or {})
    x = pl.host_tensor(arr)
    if method in ("zfp", "mgard", "mgard-progressive"):
        if x.dtype != torch.float32 and x.dtype.is_floating_point:
            x = x.to(torch.float32)
        if method == "zfp":
            x = as_blocked_3d(x)
        elif x.ndim > 4 or x.ndim == 0:
            x = x.reshape(-1)
        return x, method, params
    if method == "huffman" and x.dtype in INT_DTYPES and x.numel():
        flat = x.reshape(-1)
        if flat.dtype in (torch.uint16, torch.uint32, torch.uint64):  # no aminmax
            flat = flat.to(torch.int64)
        lo, hi = (int(v) for v in torch.aminmax(flat))
        if lo >= 0 and hi < _HUFFMAN_MAX_ALPHABET:
            return x, "huffman", params
    return byte_view(x), "huffman-bytes", {}


def finish_leaf_meta(c: Compressed, arr: Any) -> Compressed:
    """Record the pre-policy dtype/shape for :func:`decompress_leaf`."""
    c.meta["orig_dtype"] = dtype_name(arr)
    c.meta["orig_shape"] = [int(n) for n in arr.shape]
    return c


def compress_leaf(
    arr: Any, method: str, *, backend: str | None = None, **params: Any
) -> Compressed:
    """Compress one tensor with the shared shape/dtype policy.

    ``backend`` binds the plan as in :func:`compress` (the policy's
    ``huffman-bytes`` branch drops every other parameter, as the
    reference's does).
    """
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    x, pol_method, pol_params = leaf_policy(arr, method, params)
    c = compress(x, pol_method, backend=backend, **pol_params)
    return finish_leaf_meta(c, arr)


def restore_leaf(out: torch.Tensor, c: Compressed) -> torch.Tensor:
    """Undo :func:`leaf_policy` on a decoded tensor: original dtype + shape."""
    shape = tuple(c.meta["orig_shape"])
    n = math.prod(shape) if shape else 1
    dtype = getattr(torch, c.meta["orig_dtype"])
    if c.method == "huffman-bytes":
        out = out.reshape(-1).view(dtype) if out.dtype == torch.uint8 else out.to(dtype)
        return out.reshape(shape) if n == out.numel() else out
    return out.reshape(-1)[:n].to(dtype).reshape(shape)


def decompress_leaf(c: Compressed, backend: str | None = None) -> torch.Tensor:
    """Inverse of :func:`compress_leaf`: original dtype and shape, on the
    decode plan's device."""
    return restore_leaf(decode(c, backend), c)


# ---------------------------------------------------------------------------
# pytree / batch entry points
# ---------------------------------------------------------------------------
#
# PyTorch has no public pytree, so the port walks nested dicts, lists and
# tuples itself, in the order ``jax.tree_util.tree_flatten_with_path`` uses
# (dict keys sorted, an OrderedDict in its own order, sequences by index,
# ``None`` an empty subtree), and names each leaf as the reference does
# (``"layers/0/wq"``): the same tree of numpy arrays feeds both packages and
# gets the same keys.


def _children(node: Any):
    """``[(path entry, child)]`` of a container node, or None for a leaf."""
    if isinstance(node, OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _path_key(path: tuple, sep: str) -> str:
    return sep.join(str(e) for e in path)


def flatten_with_keys(tree: Any, sep: str = "/") -> Iterator[tuple[str, Any]]:
    """``(key, leaf)`` for every leaf of ``tree``, in the reference's order."""

    def walk(node: Any, path: tuple):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            yield _path_key(path, sep), node
            return
        for entry, child in kids:
            yield from walk(child, path + (entry,))

    yield from walk(tree, ())


def unflatten_like(like: Any, leaf_for: Callable[[str], Any], sep: str = "/") -> Any:
    """``like``'s structure with every leaf replaced by ``leaf_for(key)``."""

    def build(node: Any, path: tuple):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return leaf_for(_path_key(path, sep))
        vals = {entry: build(child, path + (entry,)) for entry, child in kids}
        if isinstance(node, dict):
            out = {k: vals[k] for k in node}
            return OrderedDict(out) if isinstance(node, OrderedDict) else out
        return type(node)(vals[i] for i in range(len(node)))

    return build(like, ())


def default_select(key: str, arr: Any) -> tuple[str, dict] | None:
    """Default per-leaf policy: ZFP for sizable float tensors (the reference's
    numpy kind ``f``: float16/32/64, not bfloat16), raw otherwise."""
    del key
    name = dtype_name(arr)
    size = arr.numel() if isinstance(arr, torch.Tensor) else int(np.size(arr))
    if name in ("float16", "float32", "float64") and size >= 4096:
        return "zfp", {"rate": 16}
    return None


def compress_pytree(
    tree: Any,
    select: Callable[[str, Any], tuple[str, dict] | None] | None = None,
    *,
    sep: str = "/",
    engine: Any = None,
) -> tuple[dict[str, Any], dict]:
    """Compress every selected leaf of a pytree, fanned out over devices.

    ``select(key, arr)`` returns ``(method, params)`` to compress a leaf or
    ``None`` to pass it through raw.  Returns ``(flat, stats)`` where
    ``flat`` maps path keys to :class:`Compressed` or raw leaves; the same
    structure restores via :func:`decompress_pytree`.  Runs on ``engine``
    (default: :func:`~repro_torch.core.engine.default_engine`, every visible
    CUDA device): leaves are bucketed by post-policy spec — one plan build
    per bucket, every further leaf a CMM hit.
    """
    from . import engine as engine_mod  # runtime import: peer layer

    eng = engine if engine is not None else engine_mod.default_engine()
    return eng.compress_pytree(tree, select, sep=sep)


def decompress_pytree(comp: dict[str, Any], like: Any, *, sep: str = "/",
                      engine: Any = None) -> Any:
    """Rebuild the pytree ``like`` from :func:`compress_pytree` output, with
    tensor leaves."""
    from . import engine as engine_mod

    eng = engine if engine is not None else engine_mod.default_engine()
    return eng.decompress_pytree(comp, like, sep=sep)


# ---------------------------------------------------------------------------
# chunked streaming (HDEM pipeline)
# ---------------------------------------------------------------------------


class CompressorStream:
    """Chunked streaming compression on the lane-overlapped HDEM pipeline.

    Chunks share a spec whenever their shapes agree, so every chunk after
    the first hits the CMM plan cache.  Each chunk runs as a *two-phase*
    encode: ``encode_begin`` on the executor's compute lane (the stage
    pipeline, device-resident, its CUDA stream synchronised) while the
    previous chunk's ``encode_finish`` — the fetch into page-locked host
    memory and the container build — runs on the io lane, and the next
    chunk stages through its slot's page-locked buffer and the copy stream:
    the paper's Fig. 9 overlap, bounded at ``window`` in-flight chunks.  A
    stream's bytes are those of the one-shot :func:`encode` of each chunk,
    at every window.

    ``backend`` binds the plans as in :func:`compress`: ``auto`` (``cuda``,
    which raises without a card) or ``torch`` (the plain versions on the
    CPU).  ``to_bytes``/``from_bytes`` frame the per-chunk containers with
    an offset index so chunks can be located (and fetched lazily)
    independently; ``to_file``/``from_file`` add an aligned, aggregated
    on-disk layout with a segment directory, so a reader ``pread``s exactly
    the chunks it needs.  Passing ``engine=`` places chunks round-robin
    over the engine's devices and runs the lanes on the engine's executor.

    ``chunk_size="auto"`` and/or ``window="auto"`` hand the decision to the
    auto-tuner (``core/tuner.py``): the calibrated machine cost model picks
    the (chunk, window) with the smallest predicted makespan.  The resolved
    values feed the same schedule and spec path as explicit settings, so
    auto streams are bit-identical to explicitly configured ones; the
    decision is at ``result.tuned``.  An explicit integer ``chunk_size``
    (elements) is shorthand for ``mode="fixed", c_fixed_elems=chunk_size``.
    """

    def __init__(
        self,
        method: str = "zfp",
        mode: str = "adaptive",
        *,
        c_init_elems: int = 1 << 20,
        c_fixed_elems: int = 8 << 20,
        c_limit_elems: int = 1 << 28,
        phi=None,
        theta=None,
        engine: Any = None,
        backend: str | None = None,
        window: int | str = 2,
        chunk_size: int | str | None = None,
        frame: bool = False,
        **params: Any,
    ):
        self.method = method
        self.params = params
        if backend is None and engine is not None:
            backend = engine.backend
        self.backend = adapters.resolve_backend(backend or adapters.AUTO)
        self.window = window if window == "auto" else max(1, int(window))
        # frame=True moves wire serialization (container framing + crc32)
        # onto the io lane too: each chunk's byte frame is produced while
        # the next chunk computes, and to_bytes/to_file reuse it
        self.frame = bool(frame)
        auto = chunk_size == "auto" or window == "auto"
        self.pipeline = pl.ChunkedPipeline(
            mode=mode,
            c_init_elems=c_init_elems,
            c_fixed_elems=c_fixed_elems,
            c_limit_elems=c_limit_elems,
            phi=phi,
            theta=theta,
            devices=engine.devices if engine is not None
            else [adapters.device_for(self.backend)],
            compute_fn=self._compute_chunk,
            finish_fn=self._finish_chunk,
            executor=engine.executor if engine is not None else None,
            window=window,
            chunk_size=chunk_size,
            tuner=self._tuned_plan if auto else None,
        )

    def _tuned_plan(self, total_elems: int, itemsize: int, dtype: str,
                    chunk_elems: int | None):
        """Tuner binding: this stream's codec/backend/params, the payload's
        size/dtype.  Called by the pipeline when resolving ``auto``."""
        from . import tuner as tuner_mod

        return tuner_mod.plan_stream(
            total_elems, itemsize, method=self.method, dtype=dtype,
            backend=self.backend, chunk_elems=chunk_elems,
            params=self.params,
        )

    # -- two-phase chunk encode ---------------------------------------------
    #
    # The reference gives every (plan, window slot) a private copy of the
    # plan's workspace, because XLA donates the workspace buffers its
    # executables take.  The port's stages only read the plan's workspace
    # (an executable hands back the tensor it was given), so concurrent
    # chunks share it and there is nothing to copy per slot.

    def _compute_chunk(self, chunk: torch.Tensor, slot: int):
        """Phase 1 (compute lane): the stage pipeline, state stays put."""
        del slot
        chunk = as_tensor(chunk)
        spec = make_spec(chunk, self.method, backend=self.backend, **self.params)
        codec = get_codec(spec.method)
        plan = get_plan(spec)
        if plan.pipeline is None:  # codec without a stage graph: one phase
            return ("container", codec.encode(plan, chunk))
        state, env = codec.encode_begin(plan, chunk, env=CallEnv(plan, graphs=True))
        # synchronise here, on the compute lane: serialization must only see
        # finished device buffers, and lane timings must be honest
        if chunk.is_cuda:
            torch.cuda.current_stream(chunk.device).synchronize()
        return ("state", codec, plan, state, env)

    def _finish_chunk(self, payload, slot: int) -> Compressed:
        """Phase 2 (io lane): exact-sized fetch into page-locked memory +
        container build."""
        del slot
        if payload[0] == "container":
            c = payload[1]
        else:
            _tag, codec, plan, state, env = payload
            c = codec.encode_finish(plan, state, env, pinned=True)
        if self.frame:
            c._frame_bytes = c.to_bytes()
        return c

    def compress(self, data: Any) -> pl.ChunkedResult:
        """Compress ``data`` (an array, or a tensor on the host or the card)."""
        return self.pipeline.run(data)

    @staticmethod
    def decompress(result: pl.ChunkedResult, backend: str | None = None, *,
                   out: torch.Tensor | None = None,
                   timings: list | None = None) -> torch.Tensor:
        """The field of ``result`` on ``backend``'s device, read back on the
        pipeline's reconstruction run
        (:func:`~repro_torch.core.pipeline.reconstruct_chunked`): chunk
        *i+1* is deserialised, its host tables built and its sections staged
        through a page-locked slot buffer on the calling thread while chunk
        *i* decodes on the compute lane into its own slice of the output,
        within the stream's ``window`` (2 for a stream read back from bytes
        or a file).  The values are those of :func:`decode` of each chunk.

        ``out``, a contiguous tensor of the stream's shape and decoded dtype
        on that device, receives the field, as MGARD-X's
        ``output_pre_allocated`` and ``zfp_decompress`` write into an array
        the caller holds; by default one is allocated up front.  A wrong
        ``out`` raises :class:`ValueError` before any work.  On the card the
        call returns once the caller's current stream is ordered after every
        chunk's work, so that stream may read ``out`` at once.  ``timings``,
        a list, receives each chunk's :class:`~repro_torch.core.pipeline.
        ChunkTiming` (``h2d`` the staging, ``compute`` the decode); on the
        card filling it waits for the last chunk's work.
        """
        device = adapters.device_for(backend or adapters.AUTO)
        out = _restore_target(result, device, out)
        return pl.reconstruct_chunked(
            result, lambda c: _stage_chunk(c, backend), _decode_staged, out,
            window=result.window or 2, timings=timings)

    # -- framed multi-chunk byte format -------------------------------------

    @staticmethod
    def _chunk_blobs(result: pl.ChunkedResult) -> list[bytes]:
        """Per-chunk wire frames (reusing io-lane frames from ``frame=True``)."""
        return [
            getattr(c, "_frame_bytes", None) or c.to_bytes()
            for c in result.chunks
        ]

    @staticmethod
    def to_bytes(result: pl.ChunkedResult) -> bytes:
        blobs = CompressorStream._chunk_blobs(result)
        offsets = []
        off = 0
        for b in blobs:
            offsets.append(off)
            off += len(b)
        header = {
            "axis": result.axis,
            "shape": list(result.shape),
            "boundaries": list(result.boundaries),
            "chunks": [
                {"offset": o, "nbytes": len(b)} for o, b in zip(offsets, blobs)
            ],
        }
        hbytes = json.dumps(header).encode()
        return b"".join([_STREAM_MAGIC, np.uint32(_STREAM_VERSION).tobytes(),
                         np.uint64(len(hbytes)).tobytes(), hbytes, *blobs])

    @staticmethod
    def from_bytes(raw: bytes, lazy: bool = True) -> pl.ChunkedResult:
        """Parse a framed stream; chunks are parsed lazily by default.

        Framing and every chunk's byte range are validated eagerly (a
        truncated stream raises here); the per-chunk containers are only
        materialised on first access.  ``lazy=False`` parses them all.
        """
        raw = bytes(raw)
        if len(raw) < 16 or raw[:4] != _STREAM_MAGIC:
            raise ContainerError("not an HPDR chunked stream")
        version = int(np.frombuffer(raw[4:8], np.uint32)[0])
        if version != _STREAM_VERSION:
            raise ContainerError(f"unsupported HPDR stream version {version}")
        hlen = int(np.frombuffer(raw[8:16], np.uint64)[0])
        if len(raw) < 16 + hlen:
            raise ContainerError("truncated HPDR chunked stream")
        try:
            header = json.loads(raw[16 : 16 + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ContainerError(f"corrupt HPDR stream header: {e}") from e
        base = 16 + hlen
        ranges = []
        for entry in header["chunks"]:
            lo = base + entry["offset"]
            hi = lo + entry["nbytes"]
            if hi > len(raw):
                raise ContainerError("truncated HPDR chunked stream")
            ranges.append((lo, hi))
        chunks: Sequence = LazyChunks(raw, ranges)
        if not lazy:
            chunks = list(chunks)
        return pl.ChunkedResult(
            chunks=chunks,
            boundaries=list(header["boundaries"]),
            axis=int(header["axis"]),
            shape=tuple(header["shape"]),
        )

    # -- aggregated on-disk layout (runtime/io segment directory) -----------

    @staticmethod
    def to_file(
        result: pl.ChunkedResult,
        path,
        *,
        align: int = 4096,
        parallel: bool = True,
    ) -> dict:
        """Write a framed stream to ``path`` with aligned, aggregated I/O.

        The layout is the ``to_bytes`` frame with every chunk placed at an
        ``align``-rounded offset (the header JSON is space-padded so the
        payload base is aligned too), written through
        :class:`repro_torch.runtime.io.AggregatedWriter`, whose segment
        directory trailer records every chunk's byte range and crc32.
        :meth:`from_bytes` still parses the file (the trailer is ignored).
        Returns the directory dict (``segments``, ``meta``).
        """
        from ..runtime.io import AggregatedWriter, align_up

        blobs = CompressorStream._chunk_blobs(result)
        offsets = []
        off = 0
        for b in blobs:
            offsets.append(off)
            off = align_up(off + len(b), align)
        header = {
            "axis": result.axis,
            "shape": list(result.shape),
            "boundaries": list(result.boundaries),
            "chunks": [
                {"offset": o, "nbytes": len(b)} for o, b in zip(offsets, blobs)
            ],
            "align": align,
        }
        hbytes = json.dumps(header).encode()
        # pad the header so the payload base (16 + len(hbytes)) is aligned:
        # aligned relative offsets then stay aligned absolutely
        pad = (-(16 + len(hbytes))) % align
        hbytes += b" " * pad
        meta = {k: header[k] for k in ("axis", "shape", "boundaries")}
        with AggregatedWriter(path, align=align, parallel=parallel, meta=meta) as writer:
            writer.write_raw(_STREAM_MAGIC)
            writer.write_raw(np.uint32(_STREAM_VERSION).tobytes())
            writer.write_raw(np.uint64(len(hbytes)).tobytes())
            writer.write_raw(hbytes)
            for i, b in enumerate(blobs):
                got = writer.add(f"chunk/{i:05d}", b)
                if got != 16 + len(hbytes) + offsets[i]:
                    raise ContainerError(f"chunk {i} placed at {got}, header says "
                                         f"{16 + len(hbytes) + offsets[i]}")
            directory = writer.close()
        return directory

    @staticmethod
    def from_file(path, lazy: bool = True) -> pl.ChunkedResult:
        """Open a :meth:`to_file` stream; chunks ``pread`` lazily on access.

        The segment directory locates every chunk, so restoring a prefix
        (or one chunk) reads exactly those byte ranges.  Files without a
        directory (raw :meth:`to_bytes` dumps) are parsed in memory through
        :meth:`from_bytes`.
        """
        from ..runtime import io as rio

        if not rio.has_directory(path):
            with open(path, "rb") as f:
                return CompressorStream.from_bytes(f.read(), lazy=lazy)
        reader = rio.AggregatedReader(path)
        # numeric sort: the zero-padded names widen past 5 digits on huge
        # streams, where a lexicographic sort would reorder chunks
        names = sorted(
            (n for n in reader.names() if n.startswith("chunk/")),
            key=lambda n: int(n.rsplit("/", 1)[1]),
        )
        chunks: Sequence = FileChunks(reader, names)
        if not lazy:
            chunks = list(chunks)
            reader.close()
        meta = reader.meta
        return pl.ChunkedResult(
            chunks=chunks,
            boundaries=list(meta["boundaries"]),
            axis=int(meta["axis"]),
            shape=tuple(meta["shape"]),
        )


def _restore_target(result: pl.ChunkedResult, device: torch.device,
                    out: torch.Tensor | None) -> torch.Tensor:
    """The tensor a stream's field is decoded into: ``out`` once checked, or
    a new one of the stream's shape and decoded dtype on ``device``."""
    shape = tuple(int(n) for n in result.shape)
    dtype = canonical_dtype(result.chunks[0].meta["dtype"]) if len(result.chunks) else None
    if out is None:
        return torch.empty(shape, dtype=dtype or torch.float32, device=device)
    if not isinstance(out, torch.Tensor):
        raise ValueError(f"out must be a tensor, got {type(out).__name__}")
    problems = []
    if tuple(out.shape) != shape:
        problems.append(f"shape {tuple(out.shape)}, the stream's is {shape}")
    if dtype is not None and out.dtype != dtype:
        problems.append(f"dtype {out.dtype}, the stream decodes to {dtype}")
    if out.device != device:
        problems.append(f"device {out.device}, the decode runs on {device}")
    if not out.is_contiguous():
        problems.append("not contiguous")
    if problems:
        raise ValueError("out: " + "; ".join(problems))
    return out


def _stage_chunk(c: Compressed, backend: str | None) -> tuple[tuple, dict]:
    """A stream chunk's host side, on the reconstruction run's main thread:
    ``((codec, plan, c, env), sections)``, its decode prepared
    (:meth:`Codec.decode_prepare`) with every operand already on the plan's
    device, so the compute lane does no host work and no copy.  A codec that
    decodes otherwise (``mgard-progressive``) comes with ``env`` None and no
    sections, and is decoded whole on the lane."""
    codec, plan = _decode_plan(c, backend)
    prepared = codec.decode_prepare(plan, c, env=CallEnv(plan, graphs=True))
    if prepared is None:
        return (codec, plan, c, None), {}
    sections, env = prepared
    for name in list(env.operands):
        env.operand(name)
    return (codec, plan, c, env), sections


def _decode_staged(payload: tuple, sections: dict) -> torch.Tensor:
    """A stream chunk's decode on the compute lane, from its staged sections."""
    codec, plan, c, env = payload
    if env is None:
        return codec.decode(plan, c)
    if plan.device.type == "cuda":  # tables made on the copy stream, read on this one
        stream = torch.cuda.current_stream(plan.device)
        for t in env.operands.values():
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
    return codec.decode_prepared(plan, c, sections, env)


class LazyChunks(Sequence):
    """Sequence of per-chunk containers, parsed on first access.

    Backed by the framed stream's bytes and the header's offset index;
    ``materialized`` counts how many chunks have been parsed.
    """

    def __init__(self, raw: bytes, ranges: list[tuple[int, int]]):
        self._raw = raw
        self._ranges = ranges
        self._cache: list[Compressed | None] = [None] * len(ranges)

    def __len__(self) -> int:
        return len(self._ranges)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        if self._cache[i] is None:
            lo, hi = self._ranges[i]
            self._cache[i] = Compressed.from_bytes(memoryview(self._raw)[lo:hi])
        return self._cache[i]

    @property
    def materialized(self) -> int:
        return sum(c is not None for c in self._cache)


class FileChunks(Sequence):
    """Sequence of per-chunk containers backed by segment-file ``pread``s.

    Accessing chunk *i* ``pread``s exactly that chunk's byte range
    (crc-checked) and caches the parsed container.  ``materialized`` counts
    parsed chunks and ``reader.preads`` the positional reads.
    """

    def __init__(self, reader, names: list[str]):
        self.reader = reader
        self._names = list(names)
        self._cache: list[Compressed | None] = [None] * len(names)

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        if self._cache[i] is None:
            self._cache[i] = Compressed.from_bytes(self.reader.read(self._names[i]))
        return self._cache[i]

    @property
    def materialized(self) -> int:
        return sum(c is not None for c in self._cache)
