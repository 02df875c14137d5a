"""ZFP-X block kernels on Hopper — launch wrappers for ``csrc/zfp_block.cu``.

Counterpart of ``repro.kernels.zfp_block.kernel`` (the Pallas TPU kernels
``compress_blocks`` / ``decompress_blocks``).  Two entries per direction
launch the same kernel:

  * the field form, ``compress_field`` / ``decompress_field``: the padded,
    contiguous d-D field where it lies (every axis a multiple of 4), and
    payload rows and emax in ``machine.block_view``'s row-major block order;
    the ``cuda`` backend's ZFP path;
  * the TPU kernel's form, ``compress_blocks`` / ``decompress_blocks`` on
    ``(N, 4^d)`` blocks, which are the field ``(4N, 4, ..., 4)``.

The CUDA source says what bounds the kernels and how their design answers
it; this module checks what it is given, allocates the outputs, launches on
PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback, also not for a field
that is not contiguous or whose base is not 16-byte aligned.  ``launches``
counts kernel launches, and nothing else, whichever entry launched them, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch

from .._launch import I64, INT, PTR, count_launch, library, raise_on, require, route, stream
from ...core import zfp as core_zfp
from ...core import zfp_tables
from . import ref

launches = {"compress_blocks": 0, "decompress_blocks": 0}

_SIGNATURES = {
    "zfp_field_compress": [PTR, PTR, PTR, PTR, I64, I64, I64, I64, INT, INT, INT, PTR],
    "zfp_field_decompress": [PTR, PTR, PTR, PTR, I64, I64, I64, I64, INT, INT, PTR],
    "zfp_tile_blocks": [INT],
    "zfp_launch_info": [INT, INT, INT, PTR, PTR],
}

# perm tensors already held against the compiled-in permutation:
# id -> (weak reference, version at the check)
_checked_perms: dict[int, tuple[weakref.ref, int]] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_permutation(dims: int) -> np.ndarray:
    """The sequency permutation the kernel compiles in (``make_perm`` in the
    CUDA source, step for step): flat indices of a 4^d block by total
    sequency, ties by flat index."""
    order = []
    for s in range(3 * dims + 1):
        for i in range(4 ** dims):
            if sum((i >> (2 * a)) & 3 for a in range(dims)) == s:
                order.append(i)
    return np.asarray(order, np.int32)


def tile_blocks(dims: int) -> int:
    """Blocks per tile of the ``dims``-D kernels (builds the library)."""
    return int(library("zfp_block", _SIGNATURES).zfp_tile_blocks(dims))


def launch_info(dims: int, rate: int, decode: bool) -> dict[str, int]:
    """Dynamic shared memory (bytes) and CTAs per SM of one launch of the
    ``dims``-D encode or decode kernel at ``rate`` (builds the library)."""
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = library("zfp_block", _SIGNATURES).zfp_launch_info(
        dims, rate, int(decode), ctypes.byref(smem), ctypes.byref(per_sm))
    raise_on(rc, "zfp_launch_info")
    return {"smem_bytes": smem.value, "ctas_per_sm": per_sm.value}


def _check_params(rate: int, dims: int) -> None:
    if not 1 <= dims <= 4:
        raise ValueError(f"dims must be in [1, 4], got {dims}")
    if not 1 <= rate <= 32:
        raise ValueError(f"rate must be in [1, 32], got {rate}")


def _require_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary (bulk copies)")


def _check_perm(perm: torch.Tensor, dims: int) -> None:
    """The kernel reads no ``perm``: it must be the compiled-in one."""
    seen = _checked_perms.get(id(perm))
    if seen is not None and seen[0]() is perm and seen[1] == perm._version:
        return
    if not np.array_equal(perm.cpu().numpy(), kernel_permutation(dims)):
        raise ValueError("perm must be the sequency permutation the kernel compiles in")
    key = id(perm)
    _checked_perms[key] = (weakref.ref(perm, lambda _: _checked_perms.pop(key, None)),
                           perm._version)


def _tables(perm, scale, dims: int, device, which: str) -> torch.Tensor:
    """Check (or build) the plan's tables; returns the scale table."""
    if perm is None or scale is None:
        tables = ref.default_tables(dims, device)
        perm = tables["perm"] if perm is None else perm
        scale = tables[which] if scale is None else scale
    require(perm, "perm", torch.int32, (4 ** dims,), device)
    require(scale, "scale", torch.float32, (zfp_tables.EMAX - zfp_tables.EMIN + 1,), device)
    _check_perm(perm, dims)
    return scale


def _field_dims(shape: tuple[int, ...]) -> list[int]:
    return list(shape) + [0] * (4 - len(shape))


def _check_field_shape(shape: tuple[int, ...], dims: int) -> None:
    if len(shape) != dims or any(n % 4 for n in shape):
        raise ValueError(f"the padded field must be {dims}-D with every axis a multiple of 4, "
                         f"got shape {shape}")


def _encode(field: torch.Tensor, rate: int, dims: int, scale: torch.Tensor,
            given: torch.Tensor | None = None):
    dev = field.device
    n = field.numel() // 4 ** dims
    wpb = core_zfp.words_per_block(4 ** dims, rate)
    payload = torch.empty((n, wpb), dtype=torch.int32, device=dev)
    if given is None:
        emax = torch.empty((n,), dtype=torch.int32, device=dev)
    else:  # the kernel reads each block's exponent from its emax output
        require(given, "emax", torch.int32, (n,), dev)
        emax = given.clone()
    if n:
        rc = library("zfp_block", _SIGNATURES).zfp_field_compress(
            field.data_ptr(), payload.data_ptr(), emax.data_ptr(), scale.data_ptr(),
            *_field_dims(tuple(field.shape)), dims, rate, int(given is not None), stream(dev),
        )
        raise_on(rc, "zfp_encode_kernel")
        count_launch(launches, "compress_blocks")
    return payload, emax


def _decode(payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
            shape: tuple[int, ...], scale: torch.Tensor) -> torch.Tensor:
    dev = payload.device
    n = math.prod(shape) // 4 ** dims
    wpb = core_zfp.words_per_block(4 ** dims, rate)
    require(payload, "payload", torch.int32, (n, wpb), dev)
    require(emax, "emax", torch.int32, (n,), dev)
    _require_aligned(payload, "payload")
    _require_aligned(emax, "emax")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n:
        rc = library("zfp_block", _SIGNATURES).zfp_field_decompress(
            payload.data_ptr(), emax.data_ptr(), out.data_ptr(), scale.data_ptr(),
            *_field_dims(shape), dims, rate, stream(dev),
        )
        raise_on(rc, "zfp_decode_kernel")
        count_launch(launches, "decompress_blocks")
    return out


def compress_field(
    padded: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    emax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded float32 field → ``((N, wpb) int32 words, (N,) int32 emax)``,
    rows in ``block_view``'s block order.

    ``perm`` (int32, the sequency permutation) and ``scale`` (float32, the
    encode scale table) are the plan's carried tables; missing ones are
    built for this call.  ``emax`` (int32, one per block), where given, is
    used instead of the exponent the kernel would take of each block.
    """
    if route(padded, "zfp_block"):
        return ref.compress_field(padded, rate, dims, perm=perm, scale=scale, emax=emax)
    _check_params(rate, dims)
    shape = tuple(padded.shape)
    _check_field_shape(shape, dims)
    require(padded, "field", torch.float32, shape, padded.device)
    _require_aligned(padded, "field")
    scale = _tables(perm, scale, dims, padded.device, "enc_scale")
    return _encode(padded, rate, dims, scale, emax)


def decompress_field(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    padded_shape: tuple[int, ...], *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse of :func:`compress_field`: the padded float32 field of
    ``padded_shape``.  ``scale`` is the decode scale table."""
    if route(payload, "zfp_block"):
        return ref.decompress_field(payload, emax, rate, dims, padded_shape,
                                    perm=perm, scale=scale)
    _check_params(rate, dims)
    shape = tuple(int(n) for n in padded_shape)
    _check_field_shape(shape, dims)
    scale = _tables(perm, scale, dims, payload.device, "dec_scale")
    return _decode(payload, emax, rate, dims, shape, scale)


def compress_blocks(
    blocks: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 4^dims)`` float32 → ``((N, wpb) int32 words, (N,) int32 emax)``."""
    if route(blocks, "zfp_block"):
        return ref.compress_blocks(blocks, rate, dims, perm=perm, scale=scale)
    _check_params(rate, dims)
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be (N, 4^dims), got shape {tuple(blocks.shape)}")
    n = blocks.shape[0]
    require(blocks, "blocks", torch.float32, (n, 4 ** dims), blocks.device)
    _require_aligned(blocks, "blocks")
    scale = _tables(perm, scale, dims, blocks.device, "enc_scale")
    return _encode(blocks.view((4 * n,) + (4,) * (dims - 1)), rate, dims, scale)


def decompress_blocks(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N, wpb)`` int32 words + ``(N,)`` int32 emax → ``(N, 4^dims)`` float32.

    ``scale`` is the decode scale table.
    """
    if route(payload, "zfp_block"):
        return ref.decompress_blocks(payload, emax, rate, dims, perm=perm, scale=scale)
    _check_params(rate, dims)
    if payload.ndim != 2:
        raise ValueError(f"payload must be (N, wpb), got shape {tuple(payload.shape)}")
    n = payload.shape[0]
    scale = _tables(perm, scale, dims, payload.device, "dec_scale")
    out = _decode(payload, emax, rate, dims, (4 * n,) + (4,) * (dims - 1), scale)
    return out.view(n, 4 ** dims)
