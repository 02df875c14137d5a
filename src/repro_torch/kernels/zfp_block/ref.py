"""Plain PyTorch versions of the zfp_block kernels (the CUDA kernel's oracle
and the ``torch`` backend's implementation; counterpart of
``repro.kernels.zfp_block.ref``).

Device-agnostic: they run wherever their inputs lie.  The batch is cut into
chunks of at most ``chunk`` blocks so that the bit-matrix intermediates of
the pack stay bounded (a few hundred MiB per chunk at rate 32, 4^3 blocks).
"""

from __future__ import annotations

import torch

from ...core import zfp as core_zfp
from ...core import zfp_tables
from ...core.machine import block_view, unblock_view

CHUNK_BLOCKS = 1 << 16


def default_tables(dims: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The tables a plan carries for ``dims``-D blocks on ``device``."""
    return {
        "perm": torch.from_numpy(core_zfp.sequency_permutation(dims)).to(device),
        "enc_scale": zfp_tables.scale_table(zfp_tables.ENC_SCALE_BITS, device),
        "dec_scale": zfp_tables.scale_table(zfp_tables.DEC_SCALE_BITS, device),
    }


def _check_shape(block_size: int, dims: int) -> None:
    if block_size != 4 ** dims:
        raise ValueError(f"blocks of {block_size} values do not match dims={dims}")


def compress_blocks(
    blocks: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    chunk: int = CHUNK_BLOCKS, emax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 4^dims)`` float32 → ``((N, wpb) int32 words, (N,) int32 emax)``;
    ``emax``, where given, replaces the exponent taken of each block."""
    n, block_size = blocks.shape
    _check_shape(block_size, dims)
    if perm is None or scale is None:
        tables = default_tables(dims, blocks.device)
        perm = tables["perm"] if perm is None else perm
        scale = tables["enc_scale"] if scale is None else scale
    block_shape = (4,) * dims
    payloads, emaxes = [], []
    for lo in range(0, n, chunk):
        part = blocks[lo : lo + chunk].reshape((-1,) + block_shape)
        given = None if emax is None else emax[lo : lo + chunk]
        payload, part_emax = core_zfp._compress_blocks(part, rate, perm, scale, given)
        payloads.append(payload)
        emaxes.append(part_emax)
    if not payloads:
        wpb = core_zfp.words_per_block(block_size, rate)
        return (blocks.new_empty((0, wpb), dtype=torch.int32),
                blocks.new_empty((0,), dtype=torch.int32))
    return torch.cat(payloads), torch.cat(emaxes)


def decompress_blocks(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    chunk: int = CHUNK_BLOCKS,
) -> torch.Tensor:
    """``(N, wpb)`` int32 words + ``(N,)`` int32 emax → ``(N, 4^dims)`` float32."""
    block_shape = (4,) * dims
    block_size = 4 ** dims
    if perm is None or scale is None:
        tables = default_tables(dims, payload.device)
        perm = tables["perm"] if perm is None else perm
        scale = tables["dec_scale"] if scale is None else scale
    inv_perm = torch.argsort(perm)  # where perm lies: no host sync
    outs = [
        core_zfp._decompress_blocks(
            payload[lo : lo + chunk], emax[lo : lo + chunk], rate, inv_perm,
            block_shape, scale,
        ).reshape(-1, block_size)
        for lo in range(0, payload.shape[0], chunk)
    ]
    if not outs:
        return payload.new_empty((0, block_size), dtype=torch.float32)
    return torch.cat(outs)


def compress_field(
    padded: torch.Tensor, rate: int, dims: int, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    chunk: int = CHUNK_BLOCKS, emax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded field → payload rows and emax in block order: ``block_view``,
    then :func:`compress_blocks`."""
    blocks, _counts = block_view(padded, (4,) * dims)
    return compress_blocks(blocks.reshape(blocks.shape[0], -1), rate, dims,
                           perm=perm, scale=scale, chunk=chunk, emax=emax)


def decompress_field(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    padded_shape: tuple[int, ...], *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    chunk: int = CHUNK_BLOCKS,
) -> torch.Tensor:
    """Inverse of :func:`compress_field`: :func:`decompress_blocks`, then
    ``unblock_view`` into the padded field of ``padded_shape``."""
    block_shape = (4,) * dims
    flat = decompress_blocks(payload, emax, rate, dims, perm=perm, scale=scale, chunk=chunk)
    counts = tuple(int(p) // 4 for p in padded_shape)
    return unblock_view(flat.reshape((-1,) + block_shape), counts, block_shape)
