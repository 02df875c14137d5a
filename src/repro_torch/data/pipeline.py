"""Deterministic, resumable synthetic LM data stream (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), so a restart from a
checkpoint resumes the stream exactly: the tokens are numpy's, drawn from
``SeedSequence([seed, step])`` by the port's own copy of the reference's
token maker, bit for bit the reference's.

The token distribution is a Zipf-like categorical with AR(1)-style
repetition, so losses move during a run (uniform tokens give a flat CE).
Without a mesh the batch lands on one device, the card by default; with a
mesh (as the reference's) each batch is placed ``Shard(0)`` over the mesh's
data-parallel axes ("pod", "data"), every rank keeping only its block
(made from the same tokens, with no communication).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """(B, S+1) tokens for ``step`` — pure function of (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s = cfg.global_batch, cfg.seq_len
    # Zipf-ish marginal + AR(1)-style repetition gives learnable structure
    ranks = np.arange(1, cfg.vocab + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    base = rng.choice(cfg.vocab, size=(b, s + 1), p=probs)
    repeat = rng.random((b, s + 1)) < 0.3
    shifted = np.roll(base, 1, axis=1)
    tokens = np.where(repeat, shifted, base)
    return tokens.astype(np.int32)


class SyntheticLMStream:
    """Stateless stream facade with a checkpointable position.

    ``next_batch()`` gives int32 ``tokens``/``labels`` of shape (B, S) on
    ``device`` (default: the card), or placed over ``mesh`` (on the mesh's
    device type: the current card, or the CPU)."""

    def __init__(self, cfg: DataConfig, device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is None:
            device = "cpu" if mesh.device_type == "cpu" else None
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"stream seed mismatch on restore: {state['seed']} != "
                             f"{self.cfg.seed}")
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        tokens = torch.from_numpy(_batch_tokens(self.cfg, self.step))
        self.step += 1
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.mesh is None:
            tokens = tokens.to(self.device)
            return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        from ..runtime.sharding import P, dp_axes, placed

        where = placed(P(dp_axes(self.mesh) or None), self.mesh)
        return {k: where.distribute(v, self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
