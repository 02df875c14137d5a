"""Huffman-X codecs: integer-key entropy coding and the byte-wise variant
(counterpart of ``repro.core.codecs.huffman_codec``).

Two registrations of the same stage composition (paper §IV-B, Fig. 6):

  * ``huffman``        lossless entropy coding of integer key arrays; the
                       alphabet is data-dependent, so the graph opens with a
                       device min/max-key scan and a host bind;
  * ``huffman-bytes``  lossless byte-wise coding of arbitrary arrays (a fixed
                       256-key alphabet), on a byte view taken on the device.

Both share the entropy tail :func:`entropy_tail_stages`: histogram (kernel)
→ canonical codebook (the host barrier) → code/length gather (kernel) →
prefix sum + bit packing.  Decoding runs the chunk-parallel decode kernel
on the plan's device, with decode tables cached on the plan.  Containers
are byte-identical to the reference's and cross-decode both ways.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .. import adapters
from .. import bitstream as bs
from .. import huffman
from .. import stages as sg
from ..container import Compressed, ContainerError
from . import register_codec
from .base import Codec, ReductionPlan, ReductionSpec

INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def entropy_tail_stages(
    num_bins: int | None = None, chunk_size: int = huffman.DEFAULT_CHUNK
) -> tuple:
    """The shared entropy tail, with a plan-static alphabet when known.

    ``chunk_size`` is the number of symbols per independently decodable
    chunk of the packed stream.
    """
    return (
        sg.HuffmanHistogram(num_bins),
        sg.CodebookBuild(chunk_size),
        sg.HuffmanEntropy(),
        sg.BitPack(chunk_size),
    )


def entropy_container(
    plan: ReductionPlan, env, view, method: str, shape: tuple, dtype, n_symbols: int,
) -> Compressed:
    """Serialise the entropy tail's state: the reference's sections and meta,
    key order included, with the ``bit_pack`` stage's decode chunk index."""
    total_bits = int(env.meta["total_bits"])
    c = Compressed(
        method=method,
        meta={
            "shape": tuple(shape), "dtype": str(dtype),
            "chunk_size": int(env.meta["chunk_size"]),
            "total_bits": total_bits,
            "n_symbols": int(n_symbols),
            "num_keys": int(env.meta["num_keys"]),
        },
        arrays={
            "words": view.fetch("words", max(1, bs.words_needed(total_bits))).view(np.uint32),
            "chunk_offsets": view.fetch("chunk_offsets"),
            "length_table": np.asarray(env.meta["length_table"], np.int32),
        },
    )
    n_chunks = int(c.arrays["chunk_offsets"].shape[0])
    stages = [dict(s) for s in plan.meta.get("stage_graph", [])]
    for s in stages:
        if s.get("stage") == "bit_pack":
            s["decode_index"] = {
                "n_chunks": n_chunks,
                "chunk_size": int(env.meta["chunk_size"]),
                "n_symbols": int(n_symbols),
            }
    c.meta["stages"] = stages
    return c


def stream_decode_index(c: Compressed) -> dict | None:
    """The stream's decode chunk index, or None for streams without one."""
    for s in c.meta.get("stages", ()) or ():
        if isinstance(s, dict) and s.get("stage") == "bit_pack":
            idx = s.get("decode_index")
            return dict(idx) if isinstance(idx, dict) else None
    return None


def entropy_decode_state(plan: ReductionPlan, c: Compressed) -> tuple[dict, dict]:
    """Inverse-pipeline state (the compressed sections) and meta for an
    entropy-tail stream.

    The chunk geometry comes from the decode index; a stream without one
    (written before the reference recorded it) takes it from the
    container's meta and decodes through the same kernel.  A present but
    inconsistent index is corruption: :class:`ContainerError`.
    """
    geometry = {
        "n_chunks": int(c.arrays["chunk_offsets"].shape[0]),
        "chunk_size": int(c.meta["chunk_size"]),
        "n_symbols": int(c.meta["n_symbols"]),
    }
    idx = stream_decode_index(c)
    for key, want in geometry.items():
        if idx is not None and (key not in idx or int(idx[key]) != want):
            raise ContainerError(
                f"corrupt HPDR stream: decode_index {key}={idx.get(key)!r} "
                f"disagrees with container metadata ({want})"
            )
    state0 = {
        "words": np.ascontiguousarray(c.arrays["words"], np.uint32).view(np.int32),
        "chunk_offsets": np.ascontiguousarray(c.arrays["chunk_offsets"], np.int32),
    }
    meta = {
        "length_table": np.asarray(c.arrays["length_table"], np.int32),
        "chunk_size": geometry["chunk_size"],
        "n_symbols": geometry["n_symbols"],
        "num_keys": int(c.meta["num_keys"]),
        "total_bits": int(c.meta["total_bits"]),
    }
    return state0, meta


def entropy_bucket_key(c: Compressed) -> tuple:
    """Decode-geometry group key: streams of different ``chunk_size`` must
    not share one batched decode."""
    return ("chunk_size", int(c.meta["chunk_size"]))


def sections_to_encoded(c: Compressed, device="cpu") -> huffman.Encoded:
    """A container's sections as an :class:`huffman.Encoded` on ``device``."""
    words = np.ascontiguousarray(c.arrays["words"], np.uint32).view(np.int32)
    offsets = np.ascontiguousarray(c.arrays["chunk_offsets"], np.int32)
    return huffman.Encoded(
        words=torch.from_numpy(words.copy()).to(device),
        total_bits=int(c.meta["total_bits"]),
        n_symbols=int(c.meta["n_symbols"]),
        chunk_size=int(c.meta["chunk_size"]),
        chunk_offsets=torch.from_numpy(offsets.copy()).to(device),
        length_table=np.asarray(c.arrays["length_table"], np.int32),
        num_keys=int(c.meta["num_keys"]),
    )


# the reference's name in this module for the plan-cached decode tables
plan_decode_tables = huffman.plan_decode_tables


def byte_view(data: torch.Tensor) -> torch.Tensor:
    """``data``'s bytes as uint8 on its device: numpy's ``view(np.uint8)`` of
    ``ascontiguousarray(data)`` (a 0-d tensor counts as 1-d; the last axis
    grows by the item size).  No copy for contiguous input."""
    data = data.contiguous()
    if data.ndim == 0:
        data = data.reshape(1)
    if data.numel() == 0:
        shape = data.shape[:-1] + (data.shape[-1] * data.element_size(),)
        return torch.empty(shape, dtype=torch.uint8, device=data.device)
    return data.view(torch.uint8)


class _EntropyCodec(Codec):
    """What the two entropy codecs share: plan, decode state and spec."""

    spec_defaults: dict[str, Any] = {}

    def plan(self, spec: ReductionSpec) -> ReductionPlan:
        spec = spec.resolved()
        plan = ReductionPlan(spec=spec, device=adapters.device_for(spec.backend))
        return self._attach_pipeline(plan)

    def decode_state(self, plan: ReductionPlan, c: Compressed):
        return entropy_decode_state(plan, c)

    def decode_bucket_key(self, c: Compressed) -> tuple:
        return entropy_bucket_key(c)

    def decode_spec(self, c: Compressed) -> ReductionSpec:
        return ReductionSpec.create(self.name, c.meta["shape"], c.meta["dtype"])


@register_codec("huffman")
class HuffmanCodec(_EntropyCodec):
    """Entropy coding of integer keys (alphabet sized per call).

    ``chunk_size`` is an encode-side spec parameter, canonicalised *out* of
    the spec at its default so default encode specs and the decode spec
    share one plan.  Decode reads the geometry from the container.
    """

    def make_spec(self, shape, dtype, **kwargs) -> ReductionSpec:
        chunk = int(kwargs.pop("chunk_size", huffman.DEFAULT_CHUNK))
        spec = super().make_spec(shape, dtype, **kwargs)
        if chunk != huffman.DEFAULT_CHUNK:
            spec = dataclasses.replace(spec, params=(("chunk_size", chunk),))
        return spec

    def build_stages(self, spec: ReductionSpec) -> sg.StageGraph:
        chunk = int(spec.param("chunk_size", huffman.DEFAULT_CHUNK))
        return sg.StageGraph(
            (sg.IntKeys(), sg.AlphabetScan(), sg.AlphabetBind())
            + entropy_tail_stages(chunk_size=chunk)
        )

    def encode_input(self, plan: ReductionPlan, data: torch.Tensor) -> dict:
        if data.dtype not in INT_DTYPES:
            raise ValueError("huffman method expects integer keys; use huffman-bytes")
        return {"data": data}

    def finish_container(self, plan, env, view) -> Compressed:
        spec = plan.spec
        return entropy_container(plan, env, view, self.name, spec.shape, spec.dtype,
                                 n_symbols=math.prod(spec.shape))


@register_codec("huffman-bytes")
class HuffmanBytesCodec(_EntropyCodec):
    """Byte-wise lossless coding of arbitrary arrays (fixed 256-key alphabet)."""

    def build_stages(self, spec: ReductionSpec) -> sg.StageGraph:
        return sg.StageGraph((sg.ByteKeys(),) + entropy_tail_stages(num_bins=256))

    def encode_input(self, plan: ReductionPlan, data: torch.Tensor) -> dict:
        # a byte view where the data lies: a tensor on the card stays there
        return {"data": byte_view(data)}

    def finish_container(self, plan, env, view) -> Compressed:
        spec = plan.spec
        itemsize = torch.empty((), dtype=getattr(torch, spec.dtype)).element_size()
        return entropy_container(plan, env, view, self.name, spec.shape, spec.dtype,
                                 n_symbols=math.prod(spec.shape) * itemsize)
