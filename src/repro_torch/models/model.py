"""Model facade: init / cache / decode for the dense family (counterpart of
``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model`.  The port runs the dense
decoder (qwen2.5-3b and its smoke cut); the other families raise
``NotImplementedError`` until they are ported (``ROADMAP.md``).

Entry points run on the card unless the caller names another device
(``device="cpu"``, as the tests do).

Conventions, as the reference's: parameters in ``cfg.param_dtype``, compute
in ``cfg.dtype`` (qwen2.5-3b: bfloat16 over float32 parameters); decode
takes ``token`` (B,) int and a cache of stacked per-layer ``k``/``v`` of
shape ``(n_layers, B, S_max, KH, hd)`` and returns ``(logits, cache)``.
The port's ``decode_step`` writes the cache in place and returns the same
dict (the reference returns an updated copy).

:func:`load_params` carries the reference's parameters across: a pytree of
numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the port's
tensors on a given device, so both packages run on the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import pipeline as pl
from . import attention as attn
from . import transformer as tfm
from .layers import embed, init_embedding, init_linear, init_rms_norm, linear, rms_norm

_PORTED = ("dense",)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, str(name))


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the port runs "
            f"{_PORTED} (see ROADMAP.md)")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---------------- init ----------------

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters from ``generator``'s state, on ``device``
        (default: the card; they are drawn on the generator's device, so
        give it the same one): the reference's scheme (embedding
        N(0, 0.02²), matrices N(0, 1/d_in), norms and biases zero), not its
        random stream."""
        cfg = self.cfg
        _require_ported(cfg)
        device = _device(device)
        dt = _torch_dtype(cfg.param_dtype)
        params: dict[str, Any] = {
            "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt),
            "ln_f": init_rms_norm(generator, cfg.d_model, dtype=dt),
        }
        if not cfg.tie_embeddings:
            params["head"] = init_linear(generator, cfg.d_model, cfg.vocab, False, dtype=dt)
        params["layers"] = tfm.init_dense_layers(generator, cfg.n_layers, cfg, dt)
        return params if generator.device == device else load_params(params, device)

    # ---------------- embedding / head ----------------

    def _head(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.scale_depth > 0:  # minicpm μP output scaling
            h = h / (cfg.d_model / cfg.dim_model_base)
        if cfg.tie_embeddings:
            return h @ params["embed"]["table"].to(h.dtype).T
        return linear(h, params["head"])

    # ---------------- serving: cache init / decode ----------------

    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """Zeroed KV cache ``{"k", "v"}``, each ``(n_layers, B, S_max, KH, hd)``
        on ``device`` (default: the card): the reference's layout, which
        parked containers record."""
        cfg = self.cfg
        _require_ported(cfg)
        attn.check_cache_layout(cfg)
        device = _device(device)
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache: dict, cache_len: int):
        """One decode step: ``token`` (B,) int → ``(logits (B, vocab), cache)``,
        the cache written in place at position ``cache_len``."""
        cfg = self.cfg
        _require_ported(cfg)
        x = embed(token[:, None], params["embed"], _torch_dtype(cfg.dtype))
        if cfg.scale_emb != 1.0:
            x = x * cfg.scale_emb
        x, cache = tfm.scan_stack_decode(
            x, params["layers"], cache,
            lambda h, lp, lc: tfm.dense_block_decode(h, lp, cfg, lc, cache_len))
        h = rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
        logits = self._head(params, h)[:, 0]
        return logits, cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _device(device) -> torch.device:
    """``device``, or the current card when it is None."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def load_params(tree: Any, device=None) -> Any:
    """The reference's parameters (nested dicts/lists of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them, or tensors) as the
    port's tensors on ``device`` (default: the card), same structure,
    same values and dtypes."""
    device = _device(device)
    if isinstance(tree, dict):
        return {k: load_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(load_params(v, device) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return pl.host_tensor(np.ascontiguousarray(tree)).to(device)
