"""ZFP-X fixed-rate compression — HPDR §IV-C (Algorithm 3), in PyTorch.

Counterpart of ``repro.core.zfp``.  Per 4^d block:
  1. exponent alignment: block values → common fixed-point scale ~2^(30-emax);
  2. forward integer lifting transform along each dimension (libzfp's lift);
  3. two's-complement → negabinary;
  4. coefficient reordering by total sequency;
  5. keep the top ``rate`` bitplanes, packed plane-major into 32-bit words.

The functions here are the plain PyTorch versions: the ``torch`` backend runs
them on CPU tensors, the tests hold them against the reference, and
``kernels/zfp_block/ref.py`` batches them into the oracle of the CUDA kernel.
They reproduce the reference bit for bit, quirks included:

  * the scale is read from :mod:`.zfp_tables` (XLA's inexact ``exp2``), not
    computed as an exact power of two;
  * subnormal inputs count as zero (XLA's denormals-are-zero) and subnormal
    decoded values are flushed to signed zero (XLA's flush-to-zero);
  * float → int32 conversion saturates, NaN → 0 (XLA's conversion).

A block whose absmax is below 2^-98 (emax <= -98) gets an infinite encode
scale in the reference, so its payload is garbage (every value saturates);
the port writes the same garbage.  32-bit words travel as ``int32``.

Header layout per block: 1 × int32 emax.  Payload: ceil(rate·4^d/32) words
per block.  ``rate`` is bits/value, 1..32.

Besides the block path the codec runs (:func:`compress_field`), the module
keeps the reference's standalone whole-array API: :func:`compress` /
:func:`decompress` and :class:`ZFPCompressed`, over :func:`compress_jit` /
:func:`decompress_jit`, which run where the data lies: the ``zfp_block``
kernel on a CUDA tensor, the plain block path on a CPU tensor (or where a
caller passes ``adapter="torch"``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.trace import span
from . import adapters
from . import bitstream as bs
from . import zfp_tables
from .abstractions import pad_to_blocks, padded_shape

NBMASK = 0xAAAAAAAA
_NBMASK_I32 = NBMASK - (1 << 32)  # the same bits as an int32
_FLT_MIN = float(np.finfo(np.float32).tiny)
_I32_MIN = float(-(1 << 31))
_I32_MAX = float((1 << 31) - 1)
SIGNED_INTS = (torch.int8, torch.int16, torch.int32)


# ---------------------------------------------------------------------------
# Stage 2: the zfp integer lifting transform (exact libzfp arithmetic, int32
# with two's-complement wrap; ``>>`` on int32 is arithmetic)
# ---------------------------------------------------------------------------


def fwd_lift_vec(v: torch.Tensor) -> torch.Tensor:
    """Forward lift of 4-vectors along the last axis (int32)."""
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


def inv_lift_vec(v: torch.Tensor) -> torch.Tensor:
    """Inverse lift of 4-vectors along the last axis (int32)."""
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


def fwd_transform(blocks: torch.Tensor) -> torch.Tensor:
    """Forward lift along every block axis of ``(nb, 4, ..., 4)`` blocks."""
    for axis in range(1, blocks.ndim):
        moved = fwd_lift_vec(blocks.movedim(axis, -1))
        blocks = moved.movedim(-1, axis)
    return blocks


def inv_transform(blocks: torch.Tensor) -> torch.Tensor:
    for axis in range(blocks.ndim - 1, 0, -1):
        moved = inv_lift_vec(blocks.movedim(axis, -1))
        blocks = moved.movedim(-1, axis)
    return blocks


# ---------------------------------------------------------------------------
# Stage 3: negabinary (on int32 carrying uint32 bits)
# ---------------------------------------------------------------------------


def int_to_negabinary(q: torch.Tensor) -> torch.Tensor:
    return (q + _NBMASK_I32) ^ _NBMASK_I32


def negabinary_to_int(u: torch.Tensor) -> torch.Tensor:
    return (u ^ _NBMASK_I32) - _NBMASK_I32


# ---------------------------------------------------------------------------
# Stage 4: sequency (total-order) permutation
# ---------------------------------------------------------------------------


def sequency_permutation(dims: int) -> np.ndarray:
    """Flat indices of a 4^d block ordered by total sequency (i+j+k...),
    ties broken by flat index — the reference's fixed table."""
    coords = np.stack(
        np.meshgrid(*([np.arange(4)] * dims), indexing="ij"), axis=-1
    ).reshape(-1, dims)
    total = coords.sum(axis=1)
    flat = np.arange(coords.shape[0])
    order = np.lexsort((flat, total))
    return order.astype(np.int32)


# ---------------------------------------------------------------------------
# Stage 1: exponent alignment
# ---------------------------------------------------------------------------


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values → signed zero (XLA's DAZ / FTZ)."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def block_emax(blocks: torch.Tensor) -> torch.Tensor:
    """Per-row max binary exponent e with |x| < 2^e (0 for an all-zero row).

    ``blocks``: ``(nb, bs)`` float32, subnormals already flushed.  A row
    holding inf or NaN gets 0, as ``jnp.frexp`` gives the reference.
    """
    absmax = blocks.abs().amax(dim=1)
    _, e = torch.frexp(absmax)
    keep = (absmax > 0) & torch.isfinite(absmax)
    return torch.where(keep, e, torch.zeros_like(e)).to(torch.int32)


def integer_block_emax(padded: torch.Tensor, dims: int) -> torch.Tensor:
    """Per-block emax of a padded signed-integer field, in row-major block
    order, as the reference takes it in the input dtype: the largest
    ``abs`` with two's-complement wrap, so the type's minimum (whose ``abs``
    wraps to itself, a negative number) never raises it, then ``frexp`` of
    that largest value as float32 (rounded: 2^25 - 1 has exponent 26).
    For every other dtype the exponent of the float32 values, which the
    kernel takes itself, is the reference's; for these it is not.
    """
    wide = padded.to(torch.int64 if padded.dtype == torch.int32 else torch.int32)
    mag = torch.where(wide == torch.iinfo(padded.dtype).min, 0, wide.abs())
    split = tuple(n for p in padded.shape for n in (p // 4, 4))
    absmax = mag.reshape(split).amax(dim=tuple(range(1, 2 * dims, 2))).reshape(-1)
    _, e = torch.frexp(absmax.to(torch.float32))
    return torch.where(absmax > 0, e, 0).to(torch.int32)


def saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 the way XLA converts: saturate at the int32 range, NaN → 0."""
    x = x.to(torch.float64).nan_to_num(0.0, posinf=_I32_MAX, neginf=_I32_MIN)
    return x.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def to_fixed_point(
    blocks: torch.Tensor, emax: torch.Tensor, enc_scale: torch.Tensor
) -> torch.Tensor:
    """``(nb, bs)`` float32 → int32 at scale ``enc_scale[emax]`` ≈ 2^(30-emax)."""
    scale = enc_scale[zfp_tables.table_index(emax)]
    return saturating_int32(torch.round(blocks * scale[:, None]))


def from_fixed_point(
    q: torch.Tensor, emax: torch.Tensor, dec_scale: torch.Tensor
) -> torch.Tensor:
    scale = dec_scale[zfp_tables.table_index(emax)]
    return flush_subnormal(q.to(torch.float32) * scale[:, None])


# ---------------------------------------------------------------------------
# Stage 5: bitplane truncation + serialization (fixed rate)
# ---------------------------------------------------------------------------


def plane_bits(block_size: int, rate: int) -> int:
    """Total kept bits per block (excluding the emax header word)."""
    return rate * block_size


def words_per_block(block_size: int, rate: int) -> int:
    return bs.words_needed(plane_bits(block_size, rate))


def pack_bitplanes(u: torch.Tensor, rate: int) -> torch.Tensor:
    """``u``: (..., block_size) negabinary int32 → (..., wpb) int32 words.

    Plane-major: all block bits of plane 0 (MSB), then plane 1, ... — bit
    ``i`` of plane ``p`` lands in word ``(p·bs + i) >> 5`` at bit
    ``31 - ((p·bs + i) & 31)``.
    """
    block_size = u.shape[-1]
    shifts = 31 - torch.arange(rate, dtype=torch.int32, device=u.device)
    bits = (u[..., None, :] >> shifts[:, None]) & 1  # (..., rate, bs)
    flat = bits.reshape(bits.shape[:-2] + (rate * block_size,))
    pad = (-flat.shape[-1]) % bs.WORD_BITS
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    grouped = flat.reshape(flat.shape[:-1] + (flat.shape[-1] // bs.WORD_BITS, bs.WORD_BITS))
    return bs.bits_to_words(grouped)


def unpack_bitplanes(words: torch.Tensor, rate: int, block_size: int) -> torch.Tensor:
    """Inverse of :func:`pack_bitplanes`; dropped planes read as zero."""
    bits = bs.words_to_bits(words)  # (..., wpb, 32)
    flat = bits.reshape(bits.shape[:-2] + (bits.shape[-2] * bs.WORD_BITS,))
    planes = flat[..., : rate * block_size].reshape(flat.shape[:-1] + (rate, block_size))
    shifts = 31 - torch.arange(rate, dtype=torch.int64, device=words.device)
    return (planes.to(torch.int64) << shifts[:, None]).sum(dim=-2).to(torch.int32)


# ---------------------------------------------------------------------------
# Whole blocks (the reference vmaps one block; here the batch is explicit)
# ---------------------------------------------------------------------------


def _compress_blocks(
    blocks: torch.Tensor, rate: int, perm: torch.Tensor, enc_scale: torch.Tensor,
    emax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nb, 4, ..., 4)`` float32 → ``((nb, wpb) int32, (nb,) int32)``;
    ``emax``, where given, replaces :func:`block_emax`."""
    nb = blocks.shape[0]
    flat = flush_subnormal(blocks.reshape(nb, -1).to(torch.float32))
    emax = block_emax(flat) if emax is None else emax.to(torch.int32)
    q = to_fixed_point(flat, emax, enc_scale).reshape(blocks.shape)
    u = int_to_negabinary(fwd_transform(q).reshape(nb, -1))
    u = u.index_select(1, perm.to(device=u.device, dtype=torch.int64))
    return pack_bitplanes(u, rate), emax


def _decompress_blocks(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, inv_perm: torch.Tensor,
    block_shape: tuple[int, ...], dec_scale: torch.Tensor,
) -> torch.Tensor:
    """``(nb, wpb)`` int32 words + ``(nb,)`` emax → ``(nb, *block_shape)`` float32."""
    nb = payload.shape[0]
    block_size = int(np.prod(block_shape))
    u = unpack_bitplanes(payload, rate, block_size)
    u = u.index_select(1, inv_perm.to(device=u.device, dtype=torch.int64))
    q = inv_transform(negabinary_to_int(u).reshape((nb,) + tuple(block_shape)))
    return from_fixed_point(q.reshape(nb, -1), emax, dec_scale).reshape(q.shape)


# ---------------------------------------------------------------------------
# Whole arrays: pad → field kernel (→ crop)
# ---------------------------------------------------------------------------


def compress_field(
    data: torch.Tensor, rate: int, dims: int, shape: tuple[int, ...],
    adapter: str, *, perm: torch.Tensor, scale: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-array fixed-rate compress (the reference's ``compress_jit``).

    ``adapter`` binds the ``zfp_block`` kernel (``torch`` | ``cuda``), which
    takes the padded field as it lies, in float32; ``perm`` and ``scale``
    (the encode scale table) are the plan's tables.  Data of any other
    dtype is padded as it is and cast to float32, as the reference casts
    each block; signed integer data also hands the kernel the reference's
    block exponents (:func:`integer_block_emax`).
    """
    from ..kernels.zfp_block import ops as zfp_block_ops  # lazy: layer order

    with span("zfp.pad"):
        padded = pad_to_blocks(data.reshape(shape), (4,) * dims)
        emax = integer_block_emax(padded, dims) if padded.dtype in SIGNED_INTS else None
        padded = padded.to(torch.float32).contiguous()
        if padded.data_ptr() % 16:  # the kernel's bulk copies need an aligned base
            padded = padded.clone()
    with span("zfp.launch"):
        return zfp_block_ops.compress_field(padded, rate, dims, adapter, perm=perm,
                                            scale=scale, emax=emax)


def decompress_field(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    shape: tuple[int, ...], adapter: str, *, perm: torch.Tensor, scale: torch.Tensor,
) -> torch.Tensor:
    """Inverse of :func:`compress_field` (the reference's ``decompress_jit``);
    ``scale`` is the decode scale table.  The crop is a view."""
    from ..kernels.zfp_block import ops as zfp_block_ops  # lazy: layer order

    with span("zfp.launch"):
        full = zfp_block_ops.decompress_field(
            payload, emax, rate, dims, padded_shape(shape, (4,) * dims), adapter,
            perm=perm, scale=scale,
        )
    return full[tuple(slice(0, d) for d in shape)]


# ---------------------------------------------------------------------------
# a stack of same-shape fields in one launch (the engine's batched buckets)
# ---------------------------------------------------------------------------


def _merged_shape(k: int, dims: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The padded fields of a stack of ``k``, laid end to end along axis 0."""
    full = padded_shape(shape, (4,) * dims)
    return (k * full[0],) + tuple(full[1:])


def compress_stacked(
    data: torch.Tensor, rate: int, dims: int, shape: tuple[int, ...],
    adapter: str, *, perm: torch.Tensor, scale: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`compress_field` of ``k`` same-shape fields stacked on a new
    axis 0, in one kernel launch: ``(k, blocks, words)`` payload rows and
    ``(k, blocks)`` exponents, row ``i`` equal to field ``i``'s alone.

    Each field is padded on its own (edge mode), then the padded fields are
    laid end to end along axis 0: every field is whole blocks, so field
    ``i``'s blocks are the ``i``-th run of the merged field's block order.
    """
    k = int(data.shape[0])
    padded = pad_to_blocks(data.reshape((k,) + tuple(shape)), (1,) + (4,) * dims)
    merged = _merged_shape(k, dims, shape)
    payload, emax = compress_field(padded.reshape(merged), rate, dims, merged, adapter,
                                   perm=perm, scale=scale)
    return payload.reshape(k, -1, payload.shape[-1]), emax.reshape(k, -1)


def decompress_stacked(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    shape: tuple[int, ...], adapter: str, *, perm: torch.Tensor, scale: torch.Tensor,
) -> torch.Tensor:
    """Inverse of :func:`compress_stacked`: ``(k, *shape)`` fields from one
    kernel launch (the crop is a view)."""
    k = int(payload.shape[0])
    merged = _merged_shape(k, dims, shape)
    full = decompress_field(payload.reshape(-1, payload.shape[-1]), emax.reshape(-1), rate,
                            dims, merged, adapter, perm=perm, scale=scale)
    full = full.reshape((k, merged[0] // k) + tuple(merged[1:]))
    return full[(slice(None),) + tuple(slice(0, d) for d in shape)]


# ---------------------------------------------------------------------------
# the standalone whole-array API (the reference's ``compress``/``decompress``)
# ---------------------------------------------------------------------------


@dataclass
class ZFPCompressed:
    """Fixed-rate ZFP-X stream: per-block emax headers + bitplane payload."""

    payload: torch.Tensor        # int32[n_blocks, words_per_block], the uint32 words' bits
    emax: torch.Tensor           # int32[n_blocks]
    shape: tuple[int, ...]       # original array shape
    rate: int                    # bits per value
    dtype: str = "float32"
    layout_version: int = 1

    def nbytes(self) -> int:
        return int(self.payload.nbytes + self.emax.nbytes)

    @property
    def dims(self) -> int:
        return len(self.shape)


@functools.lru_cache(maxsize=32)
def _plain_tables(dims: int, device: torch.device) -> dict[str, torch.Tensor]:
    from ..kernels.zfp_block import ref as zfp_block_ref  # lazy: layer order

    return zfp_block_ref.default_tables(dims, device)


def compress_jit(
    data: torch.Tensor, rate: int, dims: int, shape: tuple[int, ...],
    adapter: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-array fixed-rate compress: ``((blocks, wpb) int32, (blocks,) int32)``.

    ``adapter`` binds the block stage (:func:`compress_field`): ``cuda`` is
    the ``zfp_block`` kernel, ``torch`` the plain block path (the
    reference's inline one); ``None`` is the backend of ``data``'s device,
    the kernel on a CUDA tensor.  Eager: there is no trace to cache, only
    the tables.
    """
    tables = _plain_tables(dims, data.device)
    return compress_field(data, rate, dims, tuple(shape), adapters.for_tensor(adapter, data),
                          perm=tables["perm"], scale=tables["enc_scale"])


def decompress_jit(
    payload: torch.Tensor, emax: torch.Tensor, rate: int, dims: int,
    shape: tuple[int, ...], adapter: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`compress_jit`: the float32 array of ``shape``."""
    tables = _plain_tables(dims, payload.device)
    return decompress_field(payload, emax, rate, dims, tuple(shape),
                            adapters.for_tensor(adapter, payload),
                            perm=tables["perm"], scale=tables["dec_scale"])


def compress(data: torch.Tensor, rate: int = 16, device=None) -> ZFPCompressed:
    """Fixed-rate compress an N-d array (N ≤ 4) where it lies (other data:
    on ``device``, by default the card; ``api.place``): the ``zfp_block``
    kernel on a CUDA tensor, the plain block path on a CPU tensor.  The
    record keeps the input's dtype, a 64-bit one too (the reference's
    ``str(data.dtype)``), though its values are compressed as float32."""
    from .api import dtype_name, place  # lazy: api sits above this module

    with span("zfp.compress"):
        with span("zfp.place"):
            dtype = dtype_name(data)
            data = place(data, device)
        if data.ndim > 4:
            raise ValueError("zfp supports 1-4 dimensional data")
        if not 1 <= rate <= 32:
            raise ValueError("rate must be in [1, 32] bits/value")
        payload, emax = compress_jit(data, rate, data.ndim, tuple(data.shape))
        return ZFPCompressed(payload=payload, emax=emax, shape=tuple(data.shape), rate=rate,
                             dtype=dtype)


def decompress(z: ZFPCompressed) -> torch.Tensor:
    """The array of ``z``, on its payload's device (the kernel there where
    it is a card), in its recorded dtype (converted from float32 as XLA
    converts; a 64-bit record as its 32-bit type, ``api.canonical_dtype``)."""
    from .api import canonical_dtype  # lazy: api sits above this module
    from .stages.library import float32_to  # lazy: stages sit above this module

    with span("zfp.decompress"):
        out = decompress_jit(z.payload, z.emax, z.rate, z.dims, z.shape)
        with span("zfp.cast"):
            return float32_to(out, canonical_dtype(z.dtype))


def compression_ratio(z: ZFPCompressed) -> float:
    orig = math.prod(z.shape) * torch.empty((), dtype=getattr(torch, z.dtype)).element_size()
    return orig / z.nbytes()
