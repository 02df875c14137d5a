"""The check of a fixed-rate ``zfp`` configuration against the plain reference.

For every sampled output of the window, the reference encodes the same field
(``reference/zfp.py``) and decodes its own payload, and compares:

* ``payload_words_diff``: 32-bit payload words that differ from the
  reference's (a payload of another shape counting whole);
* ``emax_diff``: block exponents that differ;
* ``recon_values_diff``: reconstructed values whose float32 bits differ
  from the reference's decode.

The format is exact, so each limit is 0 (``LIMITS``).
"""

from __future__ import annotations

import torch

from ..reference import zfp as ref

LIMITS = {
    "payload_words_diff": ("sum", 0),
    "emax_diff": ("sum", 0),
    "recon_values_diff": ("sum", 0),
}
NEEDS_RECON = ("recon_values_diff",)  # not compared where nothing decompresses


def _rate(config: dict) -> int:
    return int(config["program"]["params"]["rate"])


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    return int((a.to(b.device) != b).sum())


def compare(field: torch.Tensor, sections: dict, meta: dict, recon: torch.Tensor | None,
            config: dict) -> dict[str, float]:
    """The numbers for one sampled output; without ``recon``, the stream's alone."""
    rate = _rate(config)
    payload, emax = ref.compress(field, rate)
    numbers = {"payload_words_diff": _diff(sections["payload"], payload),
               "emax_diff": _diff(sections["emax"], emax)}
    if recon is None:
        return numbers
    expect = ref.decompress(payload, emax, rate, tuple(field.shape))
    if recon.shape != expect.shape or recon.dtype != torch.float32:
        recon_diff = expect.numel()
    else:
        recon_diff = int((recon.view(torch.int32) != expect.view(torch.int32)).sum())
    return {**numbers, "recon_values_diff": recon_diff}


class _Stream:
    def __init__(self, payload, emax, shape):
        self.payload, self.emax, self.shape = payload, emax, shape


class Control:
    """The reference in the program's place, its scaling computed in
    ``dtype`` (below the format's float32): the control the check has to fail."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.rate = _rate(config)
        self.dtype = dtype

    def compress(self, field):
        payload, emax = ref.compress(field, self.rate, self.dtype)
        return _Stream(payload, emax, tuple(field.shape))

    def decompress(self, out):
        return ref.decompress(out.payload, out.emax, self.rate, out.shape, self.dtype)

    @staticmethod
    def stored_bytes(out) -> int:
        return int(out.payload.nbytes + out.emax.nbytes)

    @staticmethod
    def sections(out) -> dict:
        return {"payload": out.payload, "emax": out.emax}

    @staticmethod
    def meta(out) -> dict:
        return {"shape": list(out.shape)}

    def plan_misses(self):
        return None

    def stage_seconds(self, field):
        return None

    def release(self) -> None:
        pass
