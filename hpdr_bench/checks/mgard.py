"""The check of an ``mgard`` configuration against the plain reference.

For every sampled output of the window, the reference works the container
out again from the same field (``reference/mgard.py``: decomposition, bound
and bins, quantization, outliers, codebook and packed stream) and the
reconstruction from its own quantized values, and compares:

* ``section_bytes_diff``: bytes of the container's sections (words, chunk
  offsets, length table, outlier indices and values, bins) that differ from
  the reference's, a section of another size or type counting whole;
* ``meta_diff``: metadata entries (shape, dtype, chunk size, bit count,
  symbols, alphabet, padded grid, bound, dict size) that differ;
* ``recon_values_diff``: reconstructed values whose float32 bits differ from
  the reference's reconstruction;
* ``err_over_bound``: the largest ``|reconstruction - field|`` over the
  bound the reference works out, the guarantee the configuration states.

Each limit is in ``LIMITS``; ``PERF.md`` gives the readings they were set from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import mgard as ref

META_KEYS = ("shape", "dtype", "chunk_size", "total_bits", "n_symbols", "num_keys",
             "padded", "error_bound", "dict_size")

# name: (aggregate over samples, limit on the aggregate)
LIMITS = {
    "section_bytes_diff": ("sum", 0),
    "meta_diff": ("sum", 0),
    "recon_values_diff": ("sum", 0),
    "err_over_bound": ("max", 1.0),
}
NEEDS_RECON = ("recon_values_diff", "err_over_bound")  # not compared where nothing decompresses


def _params(config: dict) -> tuple[float, int]:
    p = config["program"]["params"]
    if not p.get("relative", True):
        raise ValueError("the mgard check states relative bounds only")
    return float(p["error_bound"]), int(p["dict_size"])


def bytes_diff(a, b) -> int:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.nbytes, b.nbytes)
    return int(np.count_nonzero(a.view(np.uint8) != b.view(np.uint8)))


def _norm(v):
    return [int(x) for x in v] if isinstance(v, (list, tuple)) else v


def compare(field: torch.Tensor, sections: dict, meta: dict, recon: torch.Tensor | None,
            config: dict) -> dict[str, float]:
    """The numbers for one sampled output; without ``recon``, the container's alone."""
    eps, dict_size = _params(config)
    want = ref.compress(field, eps, dict_size)
    names = set(want["arrays"]) | set(sections)
    section_diff = sum(
        bytes_diff(sections[k], want["arrays"][k]) if k in sections and k in want["arrays"]
        else int(np.asarray(sections.get(k, want["arrays"].get(k))).nbytes)
        for k in names)
    meta_diff = sum(_norm(meta.get(k)) != _norm(want["meta"][k]) for k in META_KEYS)
    numbers = {"section_bytes_diff": section_diff, "meta_diff": int(meta_diff)}
    if recon is None:
        return numbers
    expect = ref.reconstruct(want.pop("q"), want["arrays"]["bins"], tuple(field.shape))
    if recon.shape != expect.shape or recon.dtype != torch.float32:
        recon_diff, err = expect.numel(), float("inf")
    else:
        recon_diff = int((recon.view(torch.int32) != expect.view(torch.int32)).sum())
        err = float((recon - field).abs().max()) / want["meta"]["error_bound"]
    return {**numbers, "recon_values_diff": recon_diff, "err_over_bound": err}


class _Container:
    def __init__(self, made: dict, shape):
        self.arrays, self.meta, self.q, self.shape = made["arrays"], made["meta"], made["q"], shape


class Control:
    """The reference in the program's place, computed in ``dtype`` (the
    precision below the configuration's float32): the benchmark's control,
    which the check has to fail."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.eps, self.dict_size = _params(config)
        self.dtype = dtype

    def compress(self, field):
        return _Container(ref.compress(field, self.eps, self.dict_size, self.dtype),
                          tuple(field.shape))

    def decompress(self, out):
        return ref.reconstruct(out.q, out.arrays["bins"], out.shape, self.dtype)

    @staticmethod
    def stored_bytes(out) -> int:
        return sum(int(np.asarray(a).nbytes) for a in out.arrays.values())

    @staticmethod
    def sections(out) -> dict:
        return dict(out.arrays)

    @staticmethod
    def meta(out) -> dict:
        return dict(out.meta)

    def plan_misses(self):
        return None

    def stage_seconds(self, field):
        return None

    def release(self) -> None:
        pass
