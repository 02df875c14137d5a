"""Adapter-dispatched entry points for the zfp_block kernel (counterpart of
``repro.kernels.zfp_block.ops``): ``torch`` runs the plain versions,
``cuda`` the CUDA kernels; the block form and the field form."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("zfp_block_compress", adapters.TORCH)(ref.compress_blocks)
adapters.register("zfp_block_compress", adapters.CUDA)(kernel.compress_blocks)
adapters.register("zfp_block_decompress", adapters.TORCH)(ref.decompress_blocks)
adapters.register("zfp_block_decompress", adapters.CUDA)(kernel.decompress_blocks)
adapters.register("zfp_field_compress", adapters.TORCH)(ref.compress_field)
adapters.register("zfp_field_compress", adapters.CUDA)(kernel.compress_field)
adapters.register("zfp_field_decompress", adapters.TORCH)(ref.decompress_field)
adapters.register("zfp_field_decompress", adapters.CUDA)(kernel.decompress_field)


def compress_blocks(
    blocks: torch.Tensor, rate: int, dims: int, adapter: str | None = None, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    return adapters.dispatch("zfp_block_compress", adapter)(
        blocks, rate, dims, perm=perm, scale=scale
    )


def decompress_blocks(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    adapter: str | None = None, *, perm: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    return adapters.dispatch("zfp_block_decompress", adapter)(
        payload, emax, rate, dims, perm=perm, scale=scale
    )


def compress_field(
    padded: torch.Tensor, rate: int, dims: int, adapter: str | None = None, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
    emax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    return adapters.dispatch("zfp_field_compress", adapter)(
        padded, rate, dims, perm=perm, scale=scale, emax=emax
    )


def decompress_field(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    padded_shape: tuple[int, ...], adapter: str | None = None, *,
    perm: torch.Tensor | None = None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    return adapters.dispatch("zfp_field_decompress", adapter)(
        payload, emax, rate, dims, padded_shape, perm=perm, scale=scale
    )
