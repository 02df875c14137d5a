"""Plain fixed-rate ZFP, the yardstick of the ZFP cells.

A frozen, self-contained statement of the format that ``zfp.compress`` /
``zfp.decompress`` write and read: per 4^d block (row-major block order, the
field edge-padded to whole blocks), the block's largest binary exponent,
fixed-point scaling by the format's table, libzfp's integer lifting
transform, negabinary, the total-sequency order, and the top ``rate`` bit
planes packed plane-major, most significant bit first, into 32-bit words.
Subnormal inputs count as zero and subnormal outputs flush to zero;
float → int32 saturates with NaN → 0.

Plain ``torch`` operations only, on whatever device the field lies; it
imports nothing of the program.  ``dtype`` is the precision the scaling is
computed in: float32 is the format; a lower one is the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import zfp_tables

NBMASK_I32 = 0xAAAAAAAA - (1 << 32)
FLT_MIN = float(np.finfo(np.float32).tiny)
CHUNK_BLOCKS = 1 << 16


def _fwd_lift(v: torch.Tensor) -> torch.Tensor:
    x, y, z, w = v.unbind(-1)
    x = x + w
    x = x >> 1
    w = w - x
    z = z + y
    z = z >> 1
    y = y - z
    x = x + z
    x = x >> 1
    z = z - x
    w = w + y
    w = w >> 1
    y = y - w
    w = w + (y >> 1)
    y = y - (w >> 1)
    return torch.stack([x, y, z, w], dim=-1)


def _inv_lift(v: torch.Tensor) -> torch.Tensor:
    x, y, z, w = v.unbind(-1)
    y = y + (w >> 1)
    w = w - (y >> 1)
    y = y + w
    w = w << 1
    w = w - y
    z = z + x
    x = x << 1
    x = x - z
    y = y + z
    z = z << 1
    z = z - y
    w = w + x
    x = x << 1
    x = x - w
    return torch.stack([x, y, z, w], dim=-1)


def sequency_order(dims: int) -> np.ndarray:
    """Flat indices of a 4^d block by total sequency, ties by flat index."""
    coords = np.stack(np.meshgrid(*([np.arange(4)] * dims), indexing="ij"), -1).reshape(-1, dims)
    return np.lexsort((np.arange(coords.shape[0]), coords.sum(axis=1))).astype(np.int64)


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float64).nan_to_num(0.0, posinf=2.0 ** 31 - 1, neginf=-(2.0 ** 31))
    return x.clamp(-(2.0 ** 31), 2.0 ** 31 - 1).to(torch.int32)


def edge_pad(field: torch.Tensor, multiple: int = 4) -> torch.Tensor:
    """Pad every dim up to a multiple of ``multiple`` by repeating its last entry."""
    for dim, n in enumerate(field.shape):
        target = -(-n // multiple) * multiple
        if target != n:
            idx = torch.arange(target, device=field.device).clamp_(max=n - 1)
            field = field.index_select(dim, idx)
    return field


def blocks_of(field: torch.Tensor) -> torch.Tensor:
    """``(n_blocks, 4^d)`` values of an edge-padded field, row-major block order."""
    field = edge_pad(field)
    d = field.ndim
    counts = [n // 4 for n in field.shape]
    split = field.reshape([x for c in counts for x in (c, 4)])
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return split.permute(perm).reshape(-1, 4 ** d)


def field_of(blocks: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`blocks_of`, cropped to ``shape``."""
    d = len(shape)
    counts = [-(-n // 4) for n in shape]
    full = blocks.reshape(counts + [4] * d)
    perm = [x for pair in zip(range(d), range(d, 2 * d)) for x in pair]
    out = full.permute(perm).reshape([4 * c for c in counts])
    return out[tuple(slice(0, n) for n in shape)]


def _encode_chunk(flat, rate, order, enc, dtype):
    nb, size = flat.shape
    d = round(math.log(size, 4))
    flat = _flush(flat.to(torch.float32))
    absmax = flat.abs().amax(dim=1)
    _, e = torch.frexp(absmax)
    keep = (absmax > 0) & torch.isfinite(absmax)
    emax = torch.where(keep, e, torch.zeros_like(e)).to(torch.int32)
    scale = enc[zfp_tables.table_index(emax)]
    q = _to_int32(torch.round((flat.to(dtype) * scale.to(dtype)[:, None]).to(torch.float32)))
    q = q.reshape((nb,) + (4,) * d)
    for axis in range(1, d + 1):
        q = _fwd_lift(q.movedim(axis, -1)).movedim(-1, axis)
    u = ((q.reshape(nb, -1) + NBMASK_I32) ^ NBMASK_I32).index_select(1, order)
    shifts = 31 - torch.arange(rate, dtype=torch.int32, device=u.device)
    bits = ((u[:, None, :] >> shifts[:, None]) & 1).reshape(nb, rate * size)
    pad = (-bits.shape[1]) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    grouped = bits.reshape(nb, -1, 32).to(torch.int64)
    words = (grouped << torch.arange(31, -1, -1, device=u.device)).sum(-1)
    return words.to(torch.int32), emax


def _decode_chunk(payload, emax, rate, inv_order, dec, size, dtype):
    nb = payload.shape[0]
    d = round(math.log(size, 4))
    shifts = torch.arange(31, -1, -1, device=payload.device)
    bits = (payload.to(torch.int64)[..., None] >> shifts) & 1
    planes = bits.reshape(nb, -1)[:, : rate * size].reshape(nb, rate, size)
    shifts = 31 - torch.arange(rate, dtype=torch.int64, device=payload.device)
    u = (planes << shifts[:, None]).sum(dim=1).to(torch.int32).index_select(1, inv_order)
    q = ((u ^ NBMASK_I32) - NBMASK_I32).reshape((nb,) + (4,) * d)
    for axis in range(d, 0, -1):
        q = _inv_lift(q.movedim(axis, -1)).movedim(-1, axis)
    scale = dec[zfp_tables.table_index(emax)]
    vals = q.reshape(nb, -1).to(dtype) * scale.to(dtype)[:, None]
    return _flush(vals.to(torch.float32))


def compress(field: torch.Tensor, rate: int, dtype=torch.float32):
    """``(payload (n_blocks, words) int32, emax (n_blocks,) int32)`` of ``field``."""
    blocks = blocks_of(field)
    order = torch.from_numpy(sequency_order(field.ndim)).to(field.device)
    enc = zfp_tables.scale_table(-1, field.device)
    parts = [_encode_chunk(blocks[lo: lo + CHUNK_BLOCKS], rate, order, enc, dtype)
             for lo in range(0, blocks.shape[0], CHUNK_BLOCKS)]
    return torch.cat([p for p, _ in parts]), torch.cat([e for _, e in parts])


def decompress(payload: torch.Tensor, emax: torch.Tensor, rate: int, shape: tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
    """The float32 field of ``shape`` that ``(payload, emax)`` encode."""
    size = 4 ** len(shape)
    inv = torch.from_numpy(np.argsort(sequency_order(len(shape)))).to(payload.device)
    dec = zfp_tables.scale_table(1, payload.device)
    parts = [_decode_chunk(payload[lo: lo + CHUNK_BLOCKS], emax[lo: lo + CHUNK_BLOCKS], rate,
                           inv, dec, size, dtype)
             for lo in range(0, payload.shape[0], CHUNK_BLOCKS)]
    return field_of(torch.cat(parts), tuple(shape))
