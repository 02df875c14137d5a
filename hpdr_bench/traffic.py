"""The general traffic generator: what a traffic file's parameters mean.

A traffic file (``traffic/<name>.json``) is data: ``phases``, the phases of a
round in order, each over every field of the configuration (``"compress"``:
each field to its stored form; ``"decompress"``: each stored form of this
round back to a field on the card).  One caller drives a closed loop: the
next call is made when the previous one has returned and its output is
complete.  Each round takes the fields in an order drawn from the seed, so
every seed does the same work (the same fields, the same calls a round) in
another order.  An open-loop mix, or more than one caller, needs a change
here and in the harness's loop (``harness.py``).

Set-up runs ``WARMUP_ROUNDS`` whole rounds, untimed.  Of each field, one of
the window's compress calls is kept for the check, drawn from the seed
(reservoir sampling, so every round of the window is equally likely), with
its reconstruction where the round decompresses it.
"""

from __future__ import annotations

import numpy as np

from .data import sub_seed

KNOWN_PHASES = ("compress", "decompress")
WARMUP_ROUNDS = 1


class Rounds:
    def __init__(self, traffic: dict, n_fields: int, seed: int):
        self.phases = tuple(traffic["phases"])
        unknown = [p for p in self.phases if p not in KNOWN_PHASES]
        if unknown or self.phases[:1] != ("compress",):
            raise ValueError(f"phases must start with compress, of {KNOWN_PHASES}: {self.phases}")
        self.n_fields = n_fields
        self._order = np.random.default_rng(sub_seed(seed, -1))
        self._sample = np.random.default_rng(sub_seed(seed, -2))
        self._seen = [0] * n_fields

    def order(self) -> list[int]:
        """The fields of the next round, in call order."""
        return [int(i) for i in self._order.permutation(self.n_fields)]

    def keep(self, field: int) -> bool:
        """Reservoir sampling of one: whether this window round's output of
        ``field`` replaces the one kept so far."""
        self._seen[field] += 1
        return int(self._sample.integers(0, self._seen[field])) == 0
