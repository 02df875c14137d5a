"""Plain chunked MGARD: what a stream of ``mgard`` chunks holds for a field.

The field is cut along its largest dim (the first of equal ones) into rows
of fixed chunks of elements: the chunk sizes are ``chunk`` elements until
the rest, each rounded to whole rows (Python's ``round``, at least one row,
never past the field), with the rows left over as a last chunk.  Each chunk
goes through ``mgard.py`` at the relative bound of its own value range, and
the reconstruction is the chunks' reconstructions concatenated along the
cut.  Plain ``torch`` and numpy in ``dtype``; nothing of the program.
"""

from __future__ import annotations

import math

import torch

from . import mgard


def row_schedule(shape, chunk: int) -> tuple[int, list[int]]:
    """``(axis, rows of each chunk)`` for a field of ``shape`` cut into chunks
    of ``chunk`` elements."""
    axis = max(range(len(shape)), key=lambda a: (shape[a], -a))
    n = int(shape[axis])
    row_elems = math.prod(shape) // n
    sizes, rest = [], math.prod(shape)
    while rest > 0:
        sizes.append(min(int(chunk), rest))
        rest -= sizes[-1]
    rows, acc = [], 0
    for s in sizes:
        r = min(max(1, int(round(s / row_elems))), n - acc)
        if r <= 0:
            break
        rows.append(r)
        acc += r
    if acc < n:
        rows.append(n - acc)
    return axis, rows


def compress(field: torch.Tensor, chunk: int, eps: float, dict_size: int,
             dtype=torch.float32) -> dict:
    """Every chunk's container (``mgard.compress``), with the cut."""
    axis, rows = row_schedule(tuple(field.shape), chunk)
    starts = [sum(rows[:i]) for i in range(len(rows))]
    chunks = [mgard.compress(field.narrow(axis, s, r).contiguous(), eps, dict_size, dtype)
              for s, r in zip(starts, rows)]
    return {"axis": axis, "boundaries": starts, "shape": list(field.shape), "chunks": chunks}


def reconstruct(made: dict, dtype=torch.float32) -> torch.Tensor:
    """The field the chunks give back, concatenated along the cut."""
    parts = [mgard.reconstruct(c["q"], c["arrays"]["bins"], tuple(c["meta"]["shape"]), dtype)
             for c in made["chunks"]]
    return torch.cat(parts, dim=made["axis"])
