"""MGARD-X codec: error-bounded lossy compression behind the registry
(counterpart of ``repro.core.codecs.mgard_codec``).

The full stage graph of paper Algorithm 1:

    mgard_decorrelate → [bin_schedule] → uniform_quantize →
    huffman_histogram → [codebook_build] → huffman_entropy → bit_pack

Bracketed stages are the two host barriers: the bin schedule reads one
(vmin, vmax) pair and the codebook build reads the dict-size histogram.
Everything else, the outlier compaction included, stays on the plan's
device.  The plan keeps the level map and the Thomas solver context on its
device, and carries the reference's classic per-stage executables
(``decompose``, ``quantize``, ``dequantize``, ``recompose``), which the
progressive tier runs through the same CMM entry.  Containers hold the reference's sections and cross-decode both
ways; the ``cuda`` and ``torch`` backends write the same bytes.

The reference pads the decode-side outlier rows to buckets of 64 with a
2^31 − 1 sentinel (to bound JAX retraces) and sends grids past int32
indices, and streams without a decode index, to a host path.  Eager
PyTorch retraces nothing and scatters with int64 indices, and the port's
entropy decode reads an index-less stream's geometry from its metadata, so
every stream decodes through the one pipeline.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np

from .. import adapters, mgard
from .. import stages as sg
from ..container import Compressed, ContainerError
from . import register_codec
from .base import Codec, ReductionPlan, ReductionSpec
from .huffman_codec import (
    entropy_bucket_key, entropy_container, entropy_decode_state, entropy_tail_stages,
)


@register_codec("mgard")
class MGARDCodec(Codec):
    """Multigrid error-bounded compression (paper §IV-A, Algorithm 1)."""

    spec_defaults = {"error_bound": 1e-2, "relative": True, "dict_size": 4096}

    def build_stages(self, spec: ReductionSpec) -> sg.StageGraph:
        shape = spec.shape
        dict_size = int(spec.param("dict_size", 4096))
        padded = tuple(mgard.padded_dim(n) for n in shape)
        return sg.StageGraph(
            (
                sg.MgardDecorrelate(shape),
                sg.BinSchedule(
                    float(spec.param("error_bound", 1e-2)),
                    bool(spec.param("relative", True)),
                    mgard.total_levels(padded),
                ),
                sg.UniformQuantize(padded, dict_size),
            )
            + entropy_tail_stages(num_bins=dict_size)
        )

    def plan(self, spec: ReductionSpec) -> ReductionPlan:
        spec = spec.resolved()
        if not spec.shape or math.prod(spec.shape) == 0:
            raise ValueError(f"mgard needs a non-empty array of rank >= 1, got {spec.shape}")
        device = adapters.device_for(spec.backend)
        shape = spec.shape
        padded = tuple(mgard.padded_dim(n) for n in shape)
        dict_size = int(spec.param("dict_size", 4096))
        thomas = mgard.plan_thomas_tables(shape, device)
        plan = ReductionPlan(
            spec=spec,
            device=device,
            executables={
                "decompose": partial(mgard.decompose, shape=shape, thomas=thomas),
                "recompose": partial(mgard.recompose, shape=shape, thomas=thomas),
                "quantize": mgard.planned_quantize_stage(padded, dict_size, spec.backend),
                "dequantize": mgard.planned_dequantize_stage(spec.backend),
            },
            workspace={
                "lmap": mgard.level_map(padded, device),
                "thomas": thomas,
            },
            meta={"padded": padded, "L": mgard.total_levels(padded),
                  "dict_size": dict_size, "backend": spec.backend},
        )
        return self._attach_pipeline(plan)

    def finish_container(self, plan, env, view) -> Compressed:
        spec = plan.spec
        dict_size = plan.meta["dict_size"]
        c = entropy_container(
            plan, env, view, self.name, spec.shape, spec.dtype,
            n_symbols=math.prod(plan.meta["padded"]),
        )
        # Outliers: stored losslessly (sparse), like MGARD's escape path.  The
        # device compaction bounds the fetch to the occupied slots; a leaf
        # overflowing the cap fetches the keys and values whole (escape keys
        # mark the outlier positions exactly).
        n_out = int(view.fetch("out_count"))
        if n_out <= plan.meta["out_cap"]:
            out_idx = view.fetch("out_idx", n_out).astype(np.int64)
            out_val = view.fetch("out_val", n_out).astype(np.int32)
        else:
            keys = view.fetch("keys").reshape(-1)
            qf = view.fetch("q").reshape(-1)
            out_idx = np.nonzero(keys == dict_size - 1)[0].astype(np.int64)
            out_val = qf[out_idx].astype(np.int32)
        c.meta.update(
            padded=plan.meta["padded"],
            error_bound=float(env.meta["error_bound"]),
            dict_size=dict_size,
        )
        c.arrays.update(
            outlier_idx=out_idx,
            outlier_val=out_val,
            bins=np.asarray(env.meta["bins"], np.float64),
        )
        return c

    def decode_state(self, plan: ReductionPlan, c: Compressed):
        state0, meta = entropy_decode_state(plan, c)
        out_idx = np.ascontiguousarray(c.arrays["outlier_idx"], np.int64).reshape(-1)
        out_val = np.ascontiguousarray(c.arrays["outlier_val"], np.int32).reshape(-1)
        n = math.prod(plan.meta["padded"])
        # checked on the host: an index past the grid would fault the device
        if out_idx.size != out_val.size or (
                out_idx.size and (out_idx.min() < 0 or out_idx.max() >= n)):
            raise ContainerError(
                f"corrupt HPDR stream: {out_idx.size} outlier indices (range "
                f"[{out_idx.min(initial=0)}, {out_idx.max(initial=0)}]) and {out_val.size} "
                f"values for a grid of {n} nodes")
        state0["out_idx"] = out_idx
        state0["out_val"] = out_val
        meta["bins"] = np.asarray(c.arrays["bins"], np.float64)
        return state0, meta

    def decode_bucket_key(self, c: Compressed) -> tuple:
        return entropy_bucket_key(c)

    def decode_spec(self, c: Compressed) -> ReductionSpec:
        # Decode plans depend only on geometry + dict size: streams written
        # with any error bound share one reconstruction plan.
        return ReductionSpec.create(
            self.name, c.meta["shape"], c.meta["dtype"],
            dict_size=int(c.meta["dict_size"]),
        )
