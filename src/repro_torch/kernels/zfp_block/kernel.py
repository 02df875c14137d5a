"""ZFP-X block kernels on Hopper — launch wrappers for ``csrc/zfp_block.cu``.

Counterpart of ``repro.kernels.zfp_block.kernel`` (the Pallas TPU kernels
``compress_blocks`` / ``decompress_blocks``), with the same ``(N, 4^d)``
signature.  The CUDA source says what bounds the kernels and how their design
answers it; this module checks what it is given, allocates the outputs,
launches on PyTorch's current stream and raises if the launch failed.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
kernel launches, and nothing else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

from .._launch import I64, INT, PTR, library, raise_on, require, route, stream
from ...core import zfp as core_zfp
from ...core import zfp_tables
from . import ref

launches = {"compress_blocks": 0, "decompress_blocks": 0}

_SIGNATURES = {
    "zfp_block_compress": [PTR, PTR, PTR, PTR, PTR, I64, INT, INT, PTR],
    "zfp_block_decompress": [PTR, PTR, PTR, PTR, PTR, I64, INT, INT, PTR],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_params(rate: int, dims: int) -> None:
    if not 1 <= dims <= 4:
        raise ValueError(f"dims must be in [1, 4], got {dims}")
    if not 1 <= rate <= 32:
        raise ValueError(f"rate must be in [1, 32], got {rate}")


def _check_tables(perm, scale, dims: int, device) -> None:
    require(perm, "perm", torch.int32, (4 ** dims,), device)
    require(scale, "scale", torch.float32, (zfp_tables.EMAX - zfp_tables.EMIN + 1,), device)


def compress_blocks(
    blocks: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 4^dims)`` float32 → ``((N, wpb) int32 words, (N,) int32 emax)``.

    ``perm`` (int32, the sequency permutation) and ``scale`` (float32, the
    encode scale table) are the plan's carried tables; missing ones are
    built for this call.
    """
    if route(blocks, "zfp_block"):
        return ref.compress_blocks(blocks, rate, dims, perm=perm, scale=scale)
    _check_params(rate, dims)
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be (N, 4^dims), got shape {tuple(blocks.shape)}")
    n = blocks.shape[0]
    dev = blocks.device
    require(blocks, "blocks", torch.float32, (n, 4 ** dims), dev)
    if perm is None or scale is None:
        tables = ref.default_tables(dims, dev)
        perm = tables["perm"] if perm is None else perm
        scale = tables["enc_scale"] if scale is None else scale
    _check_tables(perm, scale, dims, dev)
    wpb = core_zfp.words_per_block(4 ** dims, rate)
    payload = torch.empty((n, wpb), dtype=torch.int32, device=dev)
    emax = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        rc = library("zfp_block", _SIGNATURES).zfp_block_compress(
            blocks.data_ptr(), payload.data_ptr(), emax.data_ptr(),
            perm.data_ptr(), scale.data_ptr(), n, dims, rate, stream(dev),
        )
        raise_on(rc, "zfp_compress_kernel")
        launches["compress_blocks"] += 1
    return payload, emax


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
    dev = payload.device
    wpb = core_zfp.words_per_block(4 ** dims, rate)
    require(payload, "payload", torch.int32, (n, wpb), dev)
    require(emax, "emax", torch.int32, (n,), dev)
    if perm is None or scale is None:
        tables = ref.default_tables(dims, dev)
        perm = tables["perm"] if perm is None else perm
        scale = tables["dec_scale"] if scale is None else scale
    _check_tables(perm, scale, dims, dev)
    out = torch.empty((n, 4 ** dims), dtype=torch.float32, device=dev)
    if n:
        rc = library("zfp_block", _SIGNATURES).zfp_block_decompress(
            payload.data_ptr(), emax.data_ptr(), out.data_ptr(),
            perm.data_ptr(), scale.data_ptr(), n, dims, rate, stream(dev),
        )
        raise_on(rc, "zfp_decompress_kernel")
        launches["decompress_blocks"] += 1
    return out
