"""Decoder-only transformer assembly (counterpart of
``repro.models.transformer``, the dense family's decode path).

dense — [GQA attn + SwiGLU] × L (qwen*).  Per-layer parameters are stacked
along a leading layer axis, as the reference's ``vmap``-ed init stacks them;
the reference scans over that axis, the port loops over it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import init_rms_norm, init_swiglu, rms_norm, swiglu


def _res_scale(cfg: ModelConfig) -> float:
    """MiniCPM depth-scaled residuals (μP): scale_depth/√L; 1.0 otherwise."""
    if cfg.scale_depth > 0:
        return cfg.scale_depth / math.sqrt(cfg.n_layers)
    return 1.0


def init_dense_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                      dtype=torch.float32) -> dict:
    """``n`` dense layers' parameters, stacked along a leading axis."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attention {cfg.attn_type!r} is not ported yet (see "
                                  "ROADMAP.md); the port runs GQA")
    lead = (n,)
    return {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "attn": attn.init_gqa(gen, cfg, lead=lead, dtype=dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, lead=lead, dtype=dtype),
    }


def dense_block_decode(x, p, cfg: ModelConfig, cache, cache_len):
    s = _res_scale(cfg)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a, cache = attn.gqa_decode(h, p["attn"], cfg, cache, cache_len)
    x = x + s * a
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + s * swiglu(h, p["mlp"])
    return x, cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so cache writes land in place)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def scan_stack_decode(x, stacked_params, stacked_cache, block_fn: Callable):
    """Loop the stacked layers, threading the hidden state; each layer's
    cache is a view of the stacked cache, written in place."""
    n = stacked_cache["k"].shape[0]
    for i in range(n):
        x, _ = block_fn(x, _layer(stacked_params, i), _layer(stacked_cache, i))
    return x, stacked_cache
