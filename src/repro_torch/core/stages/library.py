"""Concrete pipeline stages (counterpart of ``repro.core.stages.library``).

  device stages
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
    * :class:`CodebookBuild`      canonical codebook from the fetched
                                  histogram — the only host compute of the
                                  Huffman encode path

The entropy tail ``histogram → (host codebook) → entropy → pack`` is shared
by ``huffman`` and ``huffman-bytes`` (and later ``mgard``); the codecs differ
only in the stages in front of it (see ``core/codecs/*``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bitstream as bs
from .. import huffman
from .base import CallEnv, Stage

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
# Huffman entropy tail (shared by huffman / huffman-bytes)
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
    """Prefix-sum offsets + disjoint-bit word packing (DEM global stage),
    in plain PyTorch on every backend (the reference leaves it to XLA).

    The word buffer is exactly ``num_words`` long (the host knows the exact
    bit count), so the container's fetch moves only the compressed size.
    It has no inverse of its own: decoding is fused into
    :meth:`HuffmanEntropy.invert`.
    """

    name = "bit_pack"

    def __init__(self, chunk_size: int = huffman.DEFAULT_CHUNK):
        self.chunk_size = int(chunk_size)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from ...kernels.huffman_encode import ref as encode_ref

        codes, lens = state["codes"], state["lens"]
        num_words = env.static("num_words")
        if lens.shape[0] == 0:
            return {
                "words": torch.zeros(num_words, dtype=torch.int32, device=lens.device),
                "chunk_offsets": torch.zeros(0, dtype=torch.int32, device=lens.device),
            }
        words, chunk_offsets = encode_ref.pack_stream(codes, lens, num_words, self.chunk_size)
        return {"words": words, "chunk_offsets": chunk_offsets}

    def stage_meta(self, plan) -> dict:
        return {"chunk_size": self.chunk_size, "word_bits": bs.WORD_BITS}


# ---------------------------------------------------------------------------
# ZFP
# ---------------------------------------------------------------------------


class ZfpBlockTransform(Stage):
    """Fixed-rate block transform + bitplane packing (paper §IV-C).

    One stage because ZFP's whole chain is shape/rate-static: pad and block
    view in PyTorch, then one ``zfp_block`` kernel launch per direction,
    reading the plan's sequency permutation and scale tables.
    """

    name = "zfp_block_transform"
    inv_writes = ("data",)

    def __init__(self, rate: int, dims: int, shape: tuple[int, ...]):
        self.rate = int(rate)
        self.dims = int(dims)
        self.shape = tuple(shape)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        payload, emax = zfp.compress_field(
            state["data"].to(torch.float32), self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("enc_scale"),
        )
        return {"payload": payload, "emax": emax}

    def invert(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        out = zfp.decompress_field(
            state["payload"], state["emax"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("dec_scale"),
        )
        return {"data": out}

    def stage_meta(self, plan) -> dict:
        return {"rate": self.rate, "dims": self.dims}
