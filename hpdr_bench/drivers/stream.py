"""The out-of-core stream: ``repro_torch.core.api.CompressorStream`` of a
field held in pageable host memory, chunk by chunk through page-locked slot
buffers and the compute and io lanes to host containers, and its pipelined
read-back (``CompressorStream.decompress(result, out=...)``) into an array
on the card that the caller allocates.

The harness hands over the field on the card; the first call of a field (in
the untimed warm-up) keeps a pageable host copy of it, which every later
call compresses.  Configuration keys (``"program"``): ``method`` and
``params``, the keywords of ``CompressorStream``.
"""

from __future__ import annotations

import numpy as np
import torch


class Driver:
    def __init__(self, config: dict, device: torch.device):
        from repro_torch.core import api
        from repro_torch.core.context import GLOBAL_CMM

        self.api, self.cmm, self.device = api, GLOBAL_CMM, device
        program = config["program"]
        self.backend = "cuda" if device.type == "cuda" else "torch"
        self.stream = api.CompressorStream(program["method"], backend=self.backend,
                                           **program.get("params", {}))
        self.host: dict[int, torch.Tensor] = {}  # the card field's data_ptr -> its host copy

    def _host(self, field: torch.Tensor) -> torch.Tensor:
        key = field.data_ptr()
        if key not in self.host:
            self.host[key] = field.cpu() if field.is_cuda else field.clone()
        return self.host[key]

    def compress(self, field: torch.Tensor):
        return self.stream.compress(self._host(field))

    def decompress(self, out) -> torch.Tensor:
        field = torch.empty(out.shape, dtype=torch.float32, device=self.device)
        return self.api.CompressorStream.decompress(out, self.backend, out=field)

    @staticmethod
    def stored_bytes(out) -> int:
        return sum(int(np.asarray(a).nbytes) for c in out.chunks for a in c.arrays.values())

    @staticmethod
    def sections(out) -> dict:
        return {f"{i}/{k}": np.asarray(v) for i, c in enumerate(out.chunks)
                for k, v in c.arrays.items()}

    @staticmethod
    def meta(out) -> dict:
        return {"axis": int(out.axis), "shape": [int(n) for n in out.shape],
                "boundaries": [int(b) for b in out.boundaries],
                "chunks": [dict(c.meta) for c in out.chunks]}

    def plan_misses(self) -> int:
        return int(self.cmm.stats()["misses"])

    def stage_seconds(self, field: torch.Tensor) -> dict[str, float]:
        """One call each way after the window, through the pipeline's own lane
        timings: ``stream_overlap``, the compress run's summed lane seconds
        (staging, compute, serialisation) over its wall time, and
        ``restore_overlap``, the read-back's (staging, decode) over its
        wall time to the last chunk's completion."""
        from repro_torch.core import pipeline

        res = self.stream.compress(self._host(field))
        out = torch.empty(res.shape, dtype=torch.float32, device=self.device)
        timings: list = []
        self.api.CompressorStream.decompress(res, self.backend, out=out, timings=timings)
        return {"stream_overlap": res.overlap_efficiency(),
                "restore_overlap": pipeline.overlap_efficiency(timings)}

    def release(self) -> None:
        """Drop the program's cached plans and the host copies."""
        self.cmm.clear()
        self.host.clear()
