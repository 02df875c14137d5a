"""Concrete pipeline stages (counterpart of ``repro.core.stages.library``).

  device stages
    * :class:`MgardDecorrelate`   multigrid decomposition (+ the value range)
    * :class:`UniformQuantize`    per-level linear quantization (kernel),
                                  escape keys, device outlier compaction
    * :class:`IntKeys` / :class:`ByteKeys`  entry normalisation to int32 keys
    * :class:`AlphabetScan`       device min/max-key reduction (huffman alphabet)
    * :class:`HuffmanHistogram`   DEM-global frequency histogram (kernel)
    * :class:`HuffmanEntropy`     per-key (code, length) gather (kernel); its
                                  inverse is the chunk-parallel decode (kernel)
    * :class:`BitPack`            prefix-sum offsets + disjoint-bit word
                                  packing (+ self-sync chunk offsets)
    * :class:`ZfpBlockTransform`  fixed-rate block transform + bitplane pack

  host stages (the graph's synchronisation points)
    * :class:`AlphabetBind`       the fetched key range → alphabet size
    * :class:`BinSchedule`        the fetched value range → error bound +
                                  per-level bin sizes
    * :class:`CodebookBuild`      canonical codebook from the fetched
                                  histogram — the only host compute of the
                                  Huffman encode path

The entropy tail ``histogram → (host codebook) → entropy → pack`` is shared
by ``mgard``, ``huffman`` and ``huffman-bytes``; the codecs differ only in
the stages in front of it (see ``core/codecs/*``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import adapters
from .. import bitstream as bs
from .. import huffman
from .base import CallEnv, Stage

# torch.aminmax has no unsigned kernels: their range goes through a wider
# signed carrier and back
_RANGE_CARRIER = {torch.uint16: torch.int32, torch.uint32: torch.int64,
                  torch.uint64: torch.int64}


# int32 → another integer dtype with two's-complement wrap (the reference's
# ``astype``); torch's 16/32-bit unsigned types convert through a same-width view
_UNSIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def int32_to(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 keys as ``dtype``, wrapping like the reference's ``astype``."""
    signed = _UNSIGNED_VIEW.get(dtype)
    if signed is not None:
        return keys.to(signed).view(dtype)
    return keys.to(dtype)


def to_int32(data: torch.Tensor) -> torch.Tensor:
    """Integer data as int32 keys, wrapping like the reference's ``astype``."""
    if data.dtype == torch.uint32:
        return data.view(torch.int32)
    return data.to(torch.int32)


def float32_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 values as ``dtype``, converted the way XLA converts (the
    reference's ``astype`` of a decoded array): floats round to nearest
    even, a NaN becoming bfloat16's quiet NaN of its sign (0x7FC0 / 0xFFC0);
    integers truncate toward zero and saturate at the type's range, NaN
    becoming 0; bool is ``x != 0`` with subnormals counting as zero
    (denormals-are-zero) and NaN as true."""
    if dtype == torch.bfloat16:
        bits = x.to(dtype).view(torch.int16)
        nan = torch.where(torch.signbit(x), -64, 0x7FC0).to(torch.int16)
        return torch.where(torch.isnan(x), nan, bits).view(dtype)
    if dtype.is_floating_point:
        return x.to(dtype)
    if dtype == torch.bool:
        return torch.isnan(x) | (x.abs() >= torch.finfo(torch.float32).tiny)
    info = torch.iinfo(dtype)
    wide = x.to(torch.float64).nan_to_num(0.0).clamp(info.min, info.max).trunc()
    return wide.to(torch.int64).to(dtype)


def value_range(data: torch.Tensor) -> torch.Tensor:
    """``[min, max]`` of ``data`` in its own dtype (the reference's
    ``jnp.min`` / ``jnp.max``)."""
    carrier = _RANGE_CARRIER.get(data.dtype)
    vmin, vmax = torch.aminmax(data if carrier is None else data.to(carrier))
    return torch.stack([vmin, vmax]).to(data.dtype)


def bfloat16_round(x: np.float32) -> float:
    """A float32 value rounded to the nearest bfloat16 (ties to even), as
    the reference's ``ml_dtypes`` bfloat16 arithmetic rounds its results."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).item())


def span(vmin, vmax, bfloat16: bool) -> float:
    """``vmax - vmin`` of two fetched numpy scalars, subtracted in their
    dtype as the reference subtracts (float32 for float32 data; integers
    with numpy's wrap), a bfloat16 range (fetched as float32) rounded to
    bfloat16 as the reference's ``ml_dtypes`` scalars round it."""
    diff = vmax - vmin
    return bfloat16_round(diff) if bfloat16 else float(diff)


def value_span(data: torch.Tensor) -> float:
    """``max - min`` of ``data`` as :func:`span` subtracts (0.0 if empty)."""
    if data.numel() == 0:
        return 0.0
    v = value_range(data).cpu()
    bf = v.dtype == torch.bfloat16
    vmin, vmax = (v.float() if bf else v).numpy()
    return span(vmin, vmax, bf)


# ---------------------------------------------------------------------------
# entry normalisation
# ---------------------------------------------------------------------------


class IntKeys(Stage):
    """Flatten an integer array into the int32 key stream."""

    name = "int_keys"
    inv_writes = ("data",)

    def planned(self, plan) -> None:
        self._shape = tuple(plan.spec.shape)
        self._dtype = getattr(torch, plan.spec.dtype)

    def apply(self, env: CallEnv, state: dict) -> dict:
        return {"keys": to_int32(state["data"].reshape(-1))}

    def invert(self, env: CallEnv, state: dict) -> dict:
        return {"data": int32_to(state["keys"], self._dtype).reshape(self._shape)}


class ByteKeys(IntKeys):
    """Byte view of the input as the key stream (256-key alphabet)."""

    name = "byte_keys"

    def invert(self, env: CallEnv, state: dict) -> dict:
        # the inverse of the byte view is a bitcast, on the device, for any
        # element type (the reference sends some to a host fallback; the
        # bits are the same)
        raw = state["keys"].to(torch.uint8)
        return {"data": raw.view(self._dtype).reshape(self._shape)}


class AlphabetScan(Stage):
    """Device min/max-key reduction: sizes the data-dependent alphabet, and
    finds the negative keys the format cannot hold, in one fetch."""

    name = "alphabet_scan"

    def apply(self, env: CallEnv, state: dict) -> dict:
        keys = state["keys"]
        if keys.numel() == 0:
            raise ValueError("huffman needs at least one key")
        kmin, kmax = torch.aminmax(keys)
        return {"key_range": torch.stack([kmin, kmax])}


class AlphabetBind(Stage):
    """Host barrier: bind the histogram width to the observed alphabet.

    The fetch is two int32 per leaf.  A negative key (or, after the int32
    wrap, a uint32 key of 2^31 or more) raises: the reference's histogram
    folds it into bin 0 and its gather wraps it, so such keys never round
    trip; the port refuses them instead of writing that stream.
    """

    name = "alphabet_bind"
    device = False
    fetches = ("key_range",)

    def host_apply(self, env: CallEnv, fetched: dict) -> None:
        kmin, kmax = (int(v) for v in fetched["key_range"])
        if kmin < 0:
            raise ValueError(
                f"huffman takes keys in [0, 2^31); got key {kmin} (as int32): use "
                "huffman-bytes for negative or wider keys"
            )
        env.meta["num_keys"] = kmax + 1
        env.statics["num_bins"] = kmax + 1


# ---------------------------------------------------------------------------
# MGARD front end
# ---------------------------------------------------------------------------


class MgardDecorrelate(Stage):
    """Multigrid decomposition, plus the value range the relative error
    bound needs (one reduction, so the range costs one fetch of two scalars).

    Decomposition runs in plain PyTorch on the plan's device; its
    dimension-by-dimension mass solves launch the ``tridiag`` kernel on the
    card.  The plan's solver context (``thomas``) is staged once.
    """

    name = "mgard_decorrelate"
    inv_writes = ("data",)

    def __init__(self, shape: tuple[int, ...]):
        self.shape = tuple(shape)

    def planned(self, plan) -> None:
        from .. import mgard

        self._dtype = getattr(torch, plan.spec.dtype)
        self._graphed = {"decompose": mgard.GraphedTransform(mgard.decompose),
                         "recompose": mgard.GraphedTransform(mgard.recompose)}

    def _transform(self, env: CallEnv, name: str):
        from .. import mgard

        return self._graphed[name] if env.graphs else getattr(mgard, name)

    def apply(self, env: CallEnv, state: dict) -> dict:
        data = state["data"]
        decompose = self._transform(env, "decompose")
        return {
            "coeffs": decompose(data, self.shape, env.workspace("thomas")),
            "value_range": value_range(data),
        }

    def invert(self, env: CallEnv, state: dict) -> dict:
        recompose = self._transform(env, "recompose")
        out = recompose(state["coeffs"], self.shape, env.workspace("thomas"))
        return {"data": float32_to(out, self._dtype)}

    def stage_meta(self, plan) -> dict:
        return {"shape": list(self.shape)}


class BinSchedule(Stage):
    """Host barrier: value range → effective bound + per-level bin sizes.

    The relative bound is ``eb0 * (vmax - vmin)`` with the subtraction in
    the data's dtype, as the reference subtracts the numpy scalars it
    fetches (float32 for float32 data; an unsigned range never wraps, since
    vmax >= vmin); any other order changes the bins.  A bfloat16 range is
    fetched as float32 (numpy has no bfloat16), so its difference is
    rounded to bfloat16 here, as the reference's ``ml_dtypes`` scalars
    round theirs.
    """

    name = "bin_schedule"
    device = False
    fetches = ("value_range",)

    def __init__(self, eb0: float, relative: bool, L: int):
        self.eb0 = float(eb0)
        self.relative = bool(relative)
        self.L = int(L)

    def planned(self, plan) -> None:
        self._bfloat16 = plan.spec.dtype == "bfloat16"

    def host_apply(self, env: CallEnv, fetched: dict) -> None:
        from .. import mgard

        vmin, vmax = fetched["value_range"]
        eb = self.eb0 * span(vmin, vmax, self._bfloat16) if self.relative else self.eb0
        eb = eb if eb > 0 else self.eb0
        bins = mgard.level_bins(eb, self.L)
        env.meta["error_bound"] = float(eb)
        env.meta["bins"] = bins
        env.operands["bins"] = np.asarray(bins, np.float32)

    def host_prepare(self, env: CallEnv) -> None:
        # decode direction: the bin schedule was recorded in the container
        env.operands["bins"] = np.asarray(env.meta["bins"], np.float32)

    def stage_meta(self, plan) -> dict:
        return {"error_bound": self.eb0, "relative": self.relative,
                "levels": self.L + 1}


class UniformQuantize(Stage):
    """Per-level linear quantization (the ``quantize_map`` kernel), escape
    keys, and the outlier compaction on the device.

    Outliers (keys at or past the escape key ``dict_size - 1``) are stored
    losslessly: their flat indices and signed values go into slot buffers of
    ``out_cap`` entries, so the host fetches ``out_count`` and the occupied
    slots, never the grid.  Only the outlier positions are scattered.  A
    leaf whose outliers overflow the cap keeps ``q`` and ``keys`` for the
    container to fetch whole.

    The inverse restores the escaped outliers and dequantizes (the
    ``quantize_map`` kernel's inverse).
    """

    name = "uniform_quantize"
    inv_writes = ("coeffs",)

    def __init__(self, padded: tuple[int, ...], dict_size: int):
        self.padded = tuple(padded)
        self.dict_size = int(dict_size)
        n = math.prod(self.padded)
        self.out_cap = max(64, n // 16)

    def planned(self, plan) -> None:
        plan.meta["out_cap"] = self.out_cap

    def apply(self, env: CallEnv, state: dict) -> dict:
        from .. import mgard

        q, keys, inlier = mgard._quantize_stage_impl(
            state["coeffs"], env.workspace("lmap"), env.operand("bins"),
            self.padded, self.dict_size, env.backend,
        )
        where, values = mgard.split_outliers(q, inlier)
        kept = where[: self.out_cap]
        out_idx = torch.zeros(self.out_cap, dtype=torch.int32, device=q.device)
        out_val = torch.zeros(self.out_cap, dtype=torch.int32, device=q.device)
        out_idx[: kept.numel()] = kept.to(torch.int32)
        out_val[: kept.numel()] = values[: self.out_cap]
        return {
            "q": q,
            "keys": keys.reshape(-1),
            "out_count": torch.tensor(where.numel(), dtype=torch.int32),
            "out_idx": out_idx,
            "out_val": out_val,
        }

    def invert(self, env: CallEnv, state: dict) -> dict:
        from ...kernels.quantize_map import ops as quantize_ops
        from ..quantize import signed_to_unsigned

        # the keys are the zig-zagged values already; restore the escaped
        # outliers in that form, then dequantize
        u = state["keys"].reshape(-1).clone()
        u[state["out_idx"]] = signed_to_unsigned(state["out_val"])
        coeffs = quantize_ops.dequantize(
            u, env.workspace("lmap"), env.operand("bins"), adapter=env.backend,
        )
        return {"coeffs": coeffs.reshape(self.padded)}

    def stage_meta(self, plan) -> dict:
        return {"padded": list(self.padded), "dict_size": self.dict_size,
                "outlier_cap": self.out_cap}


# ---------------------------------------------------------------------------
# Huffman entropy tail (shared by mgard / huffman / huffman-bytes)
# ---------------------------------------------------------------------------


class HuffmanHistogram(Stage):
    """DEM-global frequency histogram over the key stream."""

    name = "huffman_histogram"

    def __init__(self, num_bins: int | None = None):
        self.num_bins = num_bins  # None: bound per call by AlphabetBind

    def planned(self, plan) -> None:
        if self.num_bins is not None:
            plan.meta.setdefault("statics", {})["num_bins"] = int(self.num_bins)

    def apply(self, env: CallEnv, state: dict) -> dict:
        return {"freq": huffman.histogram_op(state["keys"], env.static("num_bins"),
                                             adapter=env.backend)}

    def stage_meta(self, plan) -> dict:
        return {"num_bins": self.num_bins}


class CodebookBuild(Stage):
    """Host barrier: canonical two-phase codebook from the device histogram.

    Ships the (code, length) tables back as device operands, records the
    serialised ``length_table``, and derives the exact packed size on the
    host from ``freq · lengths`` — raising past the format's 2^31 - 1 bits,
    where the reference's int32 offsets would wrap.
    """

    name = "codebook_build"
    device = False
    fetches = ("freq",)

    def __init__(self, chunk_size: int = huffman.DEFAULT_CHUNK):
        self.chunk_size = int(chunk_size)

    def host_apply(self, env: CallEnv, fetched: dict) -> None:
        freq = np.asarray(fetched["freq"])
        num_keys = int(env.meta.get("num_keys", freq.shape[0]))
        freq = freq[:num_keys]
        book = huffman.build_codebook(freq)
        total_bits = huffman.total_bits_of(freq, book.lengths)
        env.meta.setdefault("num_keys", num_keys)
        env.meta["total_bits"] = total_bits
        env.meta["length_table"] = np.asarray(book.lengths, np.int32)
        env.meta["chunk_size"] = self.chunk_size
        env.statics["num_words"] = max(1, bs.words_needed(total_bits))
        env.operands["codes_t"] = book.codes.view(np.int32)
        env.operands["lens_t"] = np.asarray(book.lengths, np.int32)

    def host_prepare(self, env: CallEnv) -> None:
        """Decode direction: canonical decode tables from the serialised
        length table, cached on the plan (:func:`huffman.plan_decode_tables`)
        and already on its device."""
        tables = huffman.plan_decode_tables(env.plan, env.meta["length_table"])
        for name, t in zip(("first_code", "count", "sym_offset", "sym_sorted"),
                           huffman.padded_tables(tables)):
            env.operands[name] = t
        env.statics["chunk_size"] = int(env.meta["chunk_size"])
        env.statics["n_symbols"] = int(env.meta["n_symbols"])

    def stage_meta(self, plan) -> dict:
        return {"chunk_size": self.chunk_size, "canonical": True}


class HuffmanEntropy(Stage):
    """Per-key (code, length) gather from the codebook (the
    ``huffman_encode`` kernel); its inverse decodes every self-synchronising
    chunk of the packed words in parallel (the ``huffman_decode`` kernel)."""

    name = "huffman_entropy"
    inv_writes = ("keys",)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from ...kernels.huffman_encode import ops as encode_ops

        codes, lens = encode_ops.encode_lookup(
            state["keys"], env.operand("codes_t"), env.operand("lens_t"), adapter=env.backend,
        )
        return {"codes": codes, "lens": lens}

    def invert(self, env: CallEnv, state: dict) -> dict:
        from ...kernels.huffman_decode import ops as decode_ops

        first_code = env.operand("first_code")
        syms = decode_ops.decode_chunks(
            state["words"], state["chunk_offsets"], first_code, env.operand("count"),
            env.operand("sym_offset"), env.operand("sym_sorted"),
            env.static("chunk_size"), int(first_code.shape[0]) - 1, adapter=env.backend,
        )
        return {"keys": syms.reshape(-1)[: env.static("n_symbols")]}


class BitPack(Stage):
    """Prefix-sum offsets + disjoint-bit word packing (DEM global stage): the
    ``huffman_encode`` pack kernel on ``cuda``, plain PyTorch on ``torch``
    (the reference leaves it to XLA).

    The word buffer is exactly ``num_words`` long (the host knows the exact
    bit count), so the container's fetch moves only the compressed size.
    It has no inverse of its own: decoding is fused into
    :meth:`HuffmanEntropy.invert`.
    """

    name = "bit_pack"

    def __init__(self, chunk_size: int = huffman.DEFAULT_CHUNK):
        self.chunk_size = int(chunk_size)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from ...kernels.huffman_encode import ops  # noqa: F401  (registers the op)

        words, chunk_offsets = adapters.dispatch("huffman_pack_stream", env.backend)(
            state["codes"], state["lens"], env.static("num_words"), self.chunk_size)
        return {"words": words, "chunk_offsets": chunk_offsets}

    def stage_meta(self, plan) -> dict:
        return {"chunk_size": self.chunk_size, "word_bits": bs.WORD_BITS}


# ---------------------------------------------------------------------------
# ZFP
# ---------------------------------------------------------------------------


class ZfpBlockTransform(Stage):
    """Fixed-rate block transform + bitplane packing (paper §IV-C).

    One stage because ZFP's whole chain is shape/rate-static: pad in
    PyTorch, then one ``zfp_block`` kernel launch per direction on the padded
    field where it lies, with the plan's sequency permutation and scale
    tables.  Data of any dtype goes in as float32 (:func:`zfp.compress_field`
    says how the reference's exponents are kept); decoded values go back to
    the data's dtype as XLA converts them.
    """

    name = "zfp_block_transform"
    inv_writes = ("data",)
    stacks = True  # a stack of same-shape leaves is more blocks: one launch

    def __init__(self, rate: int, dims: int, shape: tuple[int, ...]):
        self.rate = int(rate)
        self.dims = int(dims)
        self.shape = tuple(shape)

    def planned(self, plan) -> None:
        self._dtype = getattr(torch, plan.spec.dtype)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        payload, emax = zfp.compress_field(
            state["data"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("enc_scale"),
        )
        return {"payload": payload, "emax": emax}

    def invert(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        out = zfp.decompress_field(
            state["payload"], state["emax"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("dec_scale"),
        )
        return {"data": float32_to(out, self._dtype)}

    def apply_stacked(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        payload, emax = zfp.compress_stacked(
            state["data"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("enc_scale"),
        )
        return {"payload": payload, "emax": emax}

    def invert_stacked(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        out = zfp.decompress_stacked(
            state["payload"], state["emax"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("dec_scale"),
        )
        return {"data": float32_to(out, self._dtype)}

    def stage_meta(self, plan) -> dict:
        return {"rate": self.rate, "dims": self.dims}
