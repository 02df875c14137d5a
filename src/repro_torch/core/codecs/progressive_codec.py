"""Progressive MGARD codec: refactored precision tiers behind the registry
(counterpart of ``repro.core.codecs.progressive_codec``).

``mgard-progressive`` containers hold one separately addressable section per
precision component (see :mod:`repro_torch.core.progressive`), so a reader
can verify and decode a prefix of the payload without touching the rest.
Registry ``decode`` reconstructs at full precision; progressive consumers
open the same bytes with :class:`~repro_torch.core.progressive.ProgressiveReader`.

The codec declares no stage graph of its own: every kernel it runs comes
through the geometry-keyed ``mgard`` plan and the shared ``huffman`` plan
(both CMM entries), one per shape whatever the error bound.  Without a stage
graph it takes no batched run, so the engine sends its leaves down the
per-leaf futures path, as the reference does.
"""

from __future__ import annotations

import torch

from .. import adapters, mgard
from ..container import Compressed
from ..stages.library import float32_to, value_span
from . import register_codec
from .base import Codec, ReductionPlan, ReductionSpec


@register_codec("mgard-progressive")
class ProgressiveMGARDCodec(Codec):
    """Multi-precision refactoring (HP-MDR model) as a registered codec."""

    spec_defaults = {
        "error_bound": 1e-2,
        "relative": True,
        "dict_size": 4096,
        "tiers": 3,
        "tier_ratio": 8.0,
    }

    def plan(self, spec: ReductionSpec) -> ReductionPlan:
        spec = spec.resolved()
        padded = tuple(mgard.padded_dim(n) for n in spec.shape)
        # metadata only: encode/decode borrow the mgard and huffman plans
        return ReductionPlan(
            spec=spec,
            device=adapters.device_for(spec.backend),
            meta={"padded": padded, "L": mgard.total_levels(padded) if padded else 0,
                  "dict_size": int(spec.param("dict_size", 4096))},
        )

    def encode(
        self, plan: ReductionPlan, data: torch.Tensor, *,
        env=None, profile: dict | None = None,
    ) -> Compressed:
        from .. import progressive  # lazy: the codecs package loads before it

        spec = plan.spec
        eb = float(spec.param("error_bound", 1e-2))
        if bool(spec.param("relative", True)):
            # the range subtracted in the data's dtype, as the reference's
            # numpy scalars subtract (``stages.library.span``)
            scaled = eb * value_span(data)
            eb = scaled if scaled > 0 else eb  # constant data: absolute bound
        stream = progressive.refactor(
            data, eb,
            tiers=int(spec.param("tiers", 3)),
            tier_ratio=float(spec.param("tier_ratio", 8.0)),
            dict_size=int(spec.param("dict_size", 4096)),
            backend=spec.backend,
        )
        c = stream.to_container()
        c.meta["dtype"] = spec.dtype
        c.meta["error_bound"] = float(spec.param("error_bound", 1e-2))
        c.meta["relative"] = bool(spec.param("relative", True))
        return c

    def decode(
        self, plan: ReductionPlan, c: Compressed, *,
        env=None, profile: dict | None = None,
    ) -> torch.Tensor:
        from .. import progressive  # lazy

        stream = progressive.ProgressiveStream.from_container(c)
        out = progressive.retrieve(stream, backend=plan.spec.backend)
        return float32_to(out, getattr(torch, c.meta["dtype"]))

    def decode_spec(self, c: Compressed) -> ReductionSpec:
        # Reconstruction depends only on geometry + dictionary size; the
        # per-stream tier ladder rides in the container manifest.
        return ReductionSpec.create(
            self.name, c.meta["shape"], c.meta["dtype"],
            dict_size=int(c.meta["dict_size"]),
        )
