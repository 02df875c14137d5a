"""The standalone fixed-rate ZFP API: ``repro_torch.core.zfp.compress`` of a
field on the card into a ``ZFPCompressed`` whose payload and block exponents
stay on the card, and ``zfp.decompress`` of it back to a field on the card.

Configuration keys (``"program"``): ``params.rate``, bits a value.
"""

from __future__ import annotations

import torch


class Driver:
    def __init__(self, config: dict, device: torch.device):
        from repro_torch.core import zfp

        self.zfp = zfp
        self.rate = int(config["program"]["params"]["rate"])

    def compress(self, field: torch.Tensor):
        return self.zfp.compress(field, rate=self.rate)

    def decompress(self, out) -> torch.Tensor:
        return self.zfp.decompress(out)

    @staticmethod
    def stored_bytes(out) -> int:
        return int(out.payload.nbytes + out.emax.nbytes)

    @staticmethod
    def sections(out) -> dict:
        return {"payload": out.payload, "emax": out.emax}

    @staticmethod
    def meta(out) -> dict:
        return {"shape": list(out.shape), "rate": int(out.rate), "dtype": out.dtype}

    def plan_misses(self) -> None:
        return None  # the standalone API keeps no plan cache

    def stage_seconds(self, field: torch.Tensor) -> None:
        return None  # nor a stage profiler

    def release(self) -> None:
        pass
