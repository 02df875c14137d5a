"""Collective-traffic and FLOP accounting of a step (the port's counterpart
of ``repro.runtime.hlo_analysis``).

The reference parses the compiled, partitioned HLO for its collectives; the
port has no HLO, so the counts come from the collectives a step actually
issues.  :class:`CollectiveRecorder` (a ``TorchDispatchMode``) records every
functional collective (``_c10d_functional``: all-reduce, all-gather,
reduce-scatter, all-to-all; the reference's collective-permute has no
functional op here) with its result's *local* shape and dtype — the
per-device result shape the reference reads from the HLO — and the size of
its process group.  An op on DTensors is passed on to DTensor (the mode
declines it), so the collectives DTensor issues inside the op to
redistribute its inputs or outputs reach the recorder as well as those a
caller issues through ``redistribute`` or ``full_tensor``.  The
accounting is the reference's: result bytes, link
bytes by ``_LINK_FACTOR`` (a reduce-scatter's factor its group size), the
same ``to_dict()`` keys.  An eager step issues every layer's collectives
in turn (there is no while body run N times and counted once), so the
reference's "raw" and "scaled" counts are one count here.

:func:`cost_analysis_dict` counts a step's FLOPs with
``torch.utils.flop_counter.FlopCounterMode``.  On DTensors it sees each op
at its global shapes, so the count is the whole mesh's; the per-device
figure the reference records is that count over the mesh's ranks.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# torch dtypes by the HLO names the table above uses
_HLO_NAME = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.uint16: "u16", torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32",
    torch.uint32: "u32", torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_LINK_FACTOR = {
    "all-reduce": 2.0,        # ring: reduce-scatter + all-gather, ≈2·R
    "all-gather": 1.0,        # result R, link ≈ R·(n−1)/n
    "reduce-scatter": None,   # result R = D/n, link ≈ D ⇒ factor = group size
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# functional collective ops by the reference's names
_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class CollectiveStats:
    count: int = 0
    result_bytes: int = 0
    link_bytes: float = 0.0


@dataclass
class Collectives:
    """Per collective type: count, result bytes, link bytes (the
    reference's ``HloCollectives``)."""

    by_type: dict = field(default_factory=lambda: defaultdict(CollectiveStats))

    @property
    def total_result_bytes(self) -> int:
        return sum(s.result_bytes for s in self.by_type.values())

    @property
    def total_link_bytes(self) -> float:
        return sum(s.link_bytes for s in self.by_type.values())

    def add(self, op: str, nbytes: int, group_size: int) -> None:
        factor = _LINK_FACTOR[op]
        if factor is None:  # reduce-scatter: link bytes ≈ result × group size
            factor = float(group_size)
        st = self.by_type[op]
        st.count += 1
        st.result_bytes += int(nbytes)
        st.link_bytes += nbytes * factor

    def to_dict(self) -> dict:
        return {
            "total_result_bytes": self.total_result_bytes,
            "total_link_bytes": self.total_link_bytes,
            "by_type": {
                k: {"count": v.count, "result_bytes": v.result_bytes,
                    "link_bytes": v.link_bytes}
                for k, v in self.by_type.items()
            },
        }


def tensor_bytes(t: torch.Tensor) -> int:
    """A result's bytes at the reference's dtype sizes."""
    return t.numel() * _DTYPE_BYTES[_HLO_NAME[t.dtype]]


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return _resolve_process_group(name).size() if name is not None else 1


class CollectiveRecorder(TorchDispatchMode):
    """While active, every functional collective a step issues is added to
    ``self.stats`` (:class:`Collectives`), at its result's local shape."""

    def __init__(self):
        super().__init__()
        self.stats = Collectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # DTensor first: its redistributions come back here as
            # functional collectives on the local blocks
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            op = _OPS.get(func._opname)
            if op is not None:
                results = out if isinstance(out, (list, tuple)) else [out]
                size = _group_size(args)
                for r in results:
                    self.stats.add(op, tensor_bytes(r), size)
        return out


def cost_analysis_dict(fn, *args, **kwargs) -> tuple[dict, object]:
    """``({"flops": the step's FLOPs}, fn's result)``: ``fn(*args,
    **kwargs)`` run once under ``FlopCounterMode`` (on DTensors: the whole
    mesh's FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}, out
