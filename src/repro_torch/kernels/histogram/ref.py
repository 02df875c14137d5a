"""Plain PyTorch version of the histogram kernel (the CUDA kernel's oracle
and the ``torch`` backend's implementation; counterpart of
``repro.kernels.histogram``).

Keys outside ``[0, num_bins)`` are counted nowhere, as in the reference's
Pallas kernel (``jnp.bincount``, its XLA path, would clip negatives into
bin 0; no codec path gives either a key out of range).
"""

from __future__ import annotations

import torch


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``(N,)`` int32 keys → ``(num_bins,)`` int32 counts."""
    keys = keys.reshape(-1).to(torch.int64)
    # out-of-range keys go to one extra bin, dropped below
    idx = torch.where((keys >= 0) & (keys < num_bins), keys, torch.full_like(keys, num_bins))
    out = torch.zeros(num_bins + 1, dtype=torch.int64, device=keys.device)
    out.index_add_(0, idx, torch.ones_like(idx))
    return out[:num_bins].to(torch.int32)
