"""The check of a stream configuration against the plain chunked reference.

For every sampled output of the window, the reference cuts the same field
into the same chunks (``reference/stream.py``: its own copy of the row
schedule), works each chunk's container out again (``reference/mgard.py``)
and reconstructs each chunk from its own quantized values, and compares:

* ``chunk_count_diff``: chunks the program's stream has more or fewer than
  the reference's;
* ``section_bytes_diff``: bytes of every chunk's sections (words, chunk
  offsets, length table, outlier indices and values, bins) that differ from
  the reference's chunk at the same place, summed over the chunks; a
  section of another size or type, or of a chunk the other side lacks,
  counts whole;
* ``meta_diff``: the cut's axis, shape and chunk starts, and each chunk's
  metadata entries (``checks/mgard.py``'s keys), that differ;
* ``recon_values_diff``: reconstructed values whose float32 bits differ from
  the reference's concatenated reconstruction;
* ``err_over_bound``: the largest over the chunks of ``|reconstruction -
  field|`` in the chunk over the bound the reference works out for it.

Each limit is in ``LIMITS``; ``PERF.md`` gives the readings they were set from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import stream as ref
from .mgard import META_KEYS, _norm, bytes_diff

# name: (aggregate over samples, limit on the aggregate)
LIMITS = {
    "chunk_count_diff": ("sum", 0),
    "section_bytes_diff": ("sum", 0),
    "meta_diff": ("sum", 0),
    "recon_values_diff": ("sum", 0),
    "err_over_bound": ("max", 1.0),
}
NEEDS_RECON = ("recon_values_diff", "err_over_bound")  # not compared where nothing decompresses


def _params(config: dict) -> tuple[int, float, int]:
    p = config["program"]["params"]
    if not p.get("relative", True) or p.get("mode", "fixed") != "fixed":
        raise ValueError("the stream check states fixed chunks at relative bounds only")
    return int(p["c_fixed_elems"]), float(p["error_bound"]), int(p["dict_size"])


def _sections_of(chunk: int, sections: dict) -> dict:
    prefix = f"{chunk}/"
    return {k[len(prefix):]: v for k, v in sections.items() if k.startswith(prefix)}


def compare(field: torch.Tensor, sections: dict, meta: dict, recon: torch.Tensor | None,
            config: dict) -> dict[str, float]:
    """The numbers for one sampled output; without ``recon``, the stream's alone."""
    chunk, eps, dict_size = _params(config)
    want = ref.compress(field, chunk, eps, dict_size)
    got_meta = list(meta.get("chunks", []))
    n_chunks = max(len(want["chunks"]), len(got_meta))
    section_diff = meta_diff = 0
    for i in range(n_chunks):
        mine = _sections_of(i, sections)
        theirs = want["chunks"][i]["arrays"] if i < len(want["chunks"]) else {}
        for k in set(mine) | set(theirs):
            if k in mine and k in theirs:
                section_diff += bytes_diff(mine[k], theirs[k])
            else:
                section_diff += int(np.asarray(mine.get(k, theirs.get(k))).nbytes)
        m = got_meta[i] if i < len(got_meta) else {}
        w = want["chunks"][i]["meta"] if i < len(want["chunks"]) else {}
        meta_diff += sum(_norm(m.get(k)) != _norm(w.get(k)) for k in META_KEYS)
    meta_diff += sum(_norm(meta.get(k)) != _norm(want[k]) for k in ("axis", "shape", "boundaries"))
    numbers = {"chunk_count_diff": abs(len(got_meta) - len(want["chunks"])),
               "section_bytes_diff": section_diff, "meta_diff": int(meta_diff)}
    if recon is None:
        return numbers
    expect = ref.reconstruct(want)
    if recon.shape != expect.shape or recon.dtype != torch.float32:
        return {**numbers, "recon_values_diff": expect.numel(), "err_over_bound": float("inf")}
    recon_diff = int((recon.view(torch.int32) != expect.view(torch.int32)).sum())
    axis, err = want["axis"], 0.0
    for start, c in zip(want["boundaries"], want["chunks"]):
        rows = c["meta"]["shape"][axis]
        gap = (recon.narrow(axis, start, rows) - field.narrow(axis, start, rows)).abs().max()
        err = max(err, float(gap) / c["meta"]["error_bound"])
    return {**numbers, "recon_values_diff": recon_diff, "err_over_bound": err}


class _Stream:
    def __init__(self, made: dict):
        self.made = made
        self.shape = tuple(made["shape"])


class Control:
    """The reference in the program's place, computed in ``dtype`` (the
    precision below the configuration's float32): the benchmark's control,
    which the check has to fail."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.chunk, self.eps, self.dict_size = _params(config)
        self.dtype = dtype

    def compress(self, field):
        return _Stream(ref.compress(field, self.chunk, self.eps, self.dict_size, self.dtype))

    def decompress(self, out):
        return ref.reconstruct(out.made, self.dtype)

    @staticmethod
    def stored_bytes(out) -> int:
        return sum(int(np.asarray(a).nbytes) for c in out.made["chunks"]
                   for a in c["arrays"].values())

    @staticmethod
    def sections(out) -> dict:
        return {f"{i}/{k}": v for i, c in enumerate(out.made["chunks"])
                for k, v in c["arrays"].items()}

    @staticmethod
    def meta(out) -> dict:
        return {"axis": out.made["axis"], "shape": out.made["shape"],
                "boundaries": out.made["boundaries"],
                "chunks": [c["meta"] for c in out.made["chunks"]]}

    def plan_misses(self):
        return None

    def stage_seconds(self, field):
        return None

    def release(self) -> None:
        pass

