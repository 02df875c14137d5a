"""ZFP-X codec: fixed-rate lossy compression behind the registry (counterpart
of ``repro.core.codecs.zfp_codec``).

The stage graph is a single device stage.  Validation (1-4 dims, rate in
[1, 32], a real or bool dtype) happens at plan time: an invalid spec never
enters the CMM.  The plan carries the sequency permutation and both scale
tables on its device; containers are byte-identical to the reference's, for
every dtype the reference compresses (float64, int64 and uint64 arrive as
float32, int32 and uint32, as in the reference).
"""

from __future__ import annotations

import numpy as np

from .. import adapters
from .. import stages as sg
from ..container import Compressed
from ...kernels.zfp_block import ref as zfp_block_ref
from . import register_codec
from .base import Codec, ReductionPlan, ReductionSpec


# what a ZFP spec may hold: the canonical dtypes (``api.as_tensor``)
ZFP_DTYPES = ("float32", "float16", "bfloat16", "int32", "int16", "int8", "uint32",
              "uint16", "uint8", "bool")


@register_codec("zfp")
class ZFPCodec(Codec):
    """Fixed-rate block compression (paper §IV-C, Algorithm 3)."""

    spec_defaults = {"rate": 16}

    def build_stages(self, spec: ReductionSpec) -> sg.StageGraph:
        rate = int(spec.param("rate", 16))
        return sg.StageGraph((sg.ZfpBlockTransform(rate, len(spec.shape), spec.shape),))

    def plan(self, spec: ReductionSpec) -> ReductionPlan:
        spec = spec.resolved()
        rate = int(spec.param("rate", 16))
        dims = len(spec.shape)
        if dims > 4 or dims == 0:
            raise ValueError("zfp supports 1-4 dimensional data")
        if not 1 <= rate <= 32:
            raise ValueError("rate must be in [1, 32] bits/value")
        if spec.dtype not in ZFP_DTYPES:
            raise ValueError(f"zfp takes one of {ZFP_DTYPES}, got {spec.dtype}")
        device = adapters.device_for(spec.backend)
        plan = ReductionPlan(
            spec=spec,
            device=device,
            workspace=zfp_block_ref.default_tables(dims, device),
            meta={"rate": rate, "dims": dims},
        )
        return self._attach_pipeline(plan)

    def finish_container(self, plan, env, view) -> Compressed:
        c = Compressed(
            method=self.name,
            meta={
                "shape": plan.spec.shape,
                "dtype": plan.spec.dtype,
                "rate": plan.meta["rate"],
            },
            arrays={
                "payload": view.fetch("payload").view(np.uint32),
                "emax": view.fetch("emax"),
            },
        )
        c.meta["stages"] = plan.meta.get("stage_graph", [])
        return c

    def decode_state(self, plan: ReductionPlan, c: Compressed):
        payload = np.ascontiguousarray(c.arrays["payload"], dtype=np.uint32)
        emax = np.ascontiguousarray(c.arrays["emax"], dtype=np.int32)
        return {"payload": payload.view(np.int32), "emax": emax}, {}

    def decode_spec(self, c: Compressed) -> ReductionSpec:
        # Backend defaults to auto: any backend decodes any stream.
        return ReductionSpec.create(
            self.name, c.meta["shape"], c.meta["dtype"], rate=int(c.meta["rate"])
        )
