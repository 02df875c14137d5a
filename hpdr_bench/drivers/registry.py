"""The codec registry's one-shot path: ``repro_torch.core.api.compress`` of a
field on the card into a ``Compressed`` container whose sections land in host
memory, and ``api.decompress`` of that container back to a field on the card.

Configuration keys (``"program"``): ``method`` and ``params``, the keywords
of ``api.compress``.
"""

from __future__ import annotations

import numpy as np
import torch


class Driver:
    def __init__(self, config: dict, device: torch.device):
        from repro_torch.core import api
        from repro_torch.core.context import GLOBAL_CMM

        self.api, self.cmm = api, GLOBAL_CMM
        program = config["program"]
        self.method = program["method"]
        self.params = dict(program.get("params", {}))
        self.backend = "cuda" if device.type == "cuda" else "torch"

    def compress(self, field: torch.Tensor):
        return self.api.compress(field, self.method, backend=self.backend, **self.params)

    def decompress(self, out) -> torch.Tensor:
        return self.api.decompress(out, backend=self.backend)

    @staticmethod
    def stored_bytes(out) -> int:
        return sum(int(np.asarray(a).nbytes) for a in out.arrays.values())

    @staticmethod
    def sections(out) -> dict:
        return {k: np.asarray(v) for k, v in out.arrays.items()}

    @staticmethod
    def meta(out) -> dict:
        return dict(out.meta)

    def plan_misses(self) -> int:
        return int(self.cmm.stats()["misses"])

    def stage_seconds(self, field: torch.Tensor) -> dict[str, float]:
        """One call each way through the program's stage profiler: seconds a
        stage (it synchronises the card after each), ``encode.`` / ``decode.``
        prefixed."""
        spec = self.api.make_spec(field, self.method, backend=self.backend, **self.params)
        c, enc, _ = self.api.encode_profiled(spec, field)
        _, dec, _ = self.api.decode_profiled(c, backend=self.backend)
        out = {f"encode.{k}": v for k, v in enc.items()}
        out.update({f"decode.{k}": v for k, v in dec.items()})
        return out

    def release(self) -> None:
        """Drop the program's cached plans (its state between calls)."""
        self.cmm.clear()
