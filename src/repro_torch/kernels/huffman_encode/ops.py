"""Adapter-dispatched entry point for the huffman_encode kernel (counterpart
of ``repro.kernels.huffman_encode.ops``): ``torch`` runs the plain version,
``cuda`` the CUDA kernel.  ``pack_stream`` has no kernel; callers use
:func:`.ref.pack_stream` on every backend."""

from __future__ import annotations

import torch

from ...core import adapters
from . import kernel, ref

adapters.register("huffman_encode_lookup", adapters.TORCH)(ref.encode_lookup)
adapters.register("huffman_encode_lookup", adapters.CUDA)(kernel.encode_lookup)


def encode_lookup(
    keys: torch.Tensor, codes_table: torch.Tensor, lens_table: torch.Tensor,
    adapter: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    return adapters.dispatch("huffman_encode_lookup", adapter)(keys, codes_table, lens_table)
