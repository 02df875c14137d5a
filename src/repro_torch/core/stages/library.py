"""Concrete pipeline stages (counterpart of ``repro.core.stages.library``;
only :class:`ZfpBlockTransform` is ported so far)."""

from __future__ import annotations

import torch

from .base import CallEnv, Stage


class ZfpBlockTransform(Stage):
    """Fixed-rate block transform + bitplane packing (paper §IV-C).

    One stage because ZFP's whole chain is shape/rate-static: pad and block
    view in PyTorch, then one ``zfp_block`` kernel launch per direction,
    reading the plan's sequency permutation and scale tables.
    """

    name = "zfp_block_transform"

    def __init__(self, rate: int, dims: int, shape: tuple[int, ...]):
        self.rate = int(rate)
        self.dims = int(dims)
        self.shape = tuple(shape)

    def apply(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        payload, emax = zfp.compress_field(
            state["data"].to(torch.float32), self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("enc_scale"),
        )
        return {"payload": payload, "emax": emax}

    def invert(self, env: CallEnv, state: dict) -> dict:
        from .. import zfp

        out = zfp.decompress_field(
            state["payload"], state["emax"], self.rate, self.dims, self.shape,
            env.backend, perm=env.workspace("perm"), scale=env.workspace("dec_scale"),
        )
        return {"data": out}

    def stage_meta(self, plan) -> dict:
        return {"rate": self.rate, "dims": self.dims}
