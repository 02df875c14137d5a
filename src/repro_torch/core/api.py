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

Entry points run on the CUDA card (backend ``auto`` = ``cuda``) unless the
caller passes ``backend="torch"``, which runs the plain versions on the CPU.
:func:`decode` returns a tensor on the plan's device.

Methods: ``mgard`` (the default), ``mgard-progressive``, ``zfp``,
``huffman`` and ``huffman-bytes``.  Not yet ported: the chunk-pipelined
``CompressorStream``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Iterator

import numpy as np
import torch

from . import adapters
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


def dtype_name(data: Any) -> str:
    """numpy name of ``data``'s dtype (``"float32"``, ``"bfloat16"``, ...)."""
    dtype = data.dtype
    return _NP_NAMES[dtype] if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))


def as_tensor(data: Any) -> torch.Tensor:
    """``data`` as a tensor with the reference's canonical dtype.

    The reference's ``compress`` goes through ``jnp.asarray``, so a float64
    input is compressed (and recorded) as float32, and int64/uint64 as
    int32/uint32 (with wrap); the port does the same.  A numpy bfloat16
    array (``ml_dtypes``) becomes a torch bfloat16 tensor.
    """
    if not isinstance(data, torch.Tensor):
        data = _from_numpy(np.asarray(data))
    name = _CANONICAL.get(dtype_name(data))
    if name is not None:
        data = data.to(getattr(torch, name))
    return data


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    arr = arr if arr.flags.writeable else arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# spec / plan resolution (CMM-backed)
# ---------------------------------------------------------------------------


def make_spec(data: Any, method: str, **params: Any) -> ReductionSpec:
    """Build the canonical spec for compressing ``data`` with ``method``."""
    codec = get_codec(method)
    return codec.make_spec(tuple(data.shape), dtype_name(data), **params)


def _build_context(key, codec: Codec, spec: ReductionSpec) -> ReductionContext:
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
    return get_codec(spec.method).encode(get_plan(spec), as_tensor(data))


def encode_profiled(
    spec: ReductionSpec, data: Any
) -> tuple[Compressed, dict[str, float], TransferStats]:
    """Encode with per-stage wall seconds and host↔device transfer bytes."""
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
    codec, plan = _decode_plan(c, backend)
    return codec.decode(plan, c)


def decode_profiled(
    c: Compressed, backend: str | None = None
) -> tuple[torch.Tensor, dict[str, float], TransferStats]:
    """Decode with per-stage wall seconds and host↔device transfer bytes."""
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
    x = arr if isinstance(arr, torch.Tensor) else _from_numpy(np.asarray(arr))
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
