"""Decoder-only transformer assembly (counterpart of
``repro.models.transformer``: the dense, vlm, moe, ssm and hybrid
families' training forward and decode path).

dense — [GQA attn + SwiGLU] × L (qwen*, minicpm, deepseek-67b, qwen2-vl: the
        vlm family is the dense block with M-RoPE positions)
moe   — [attn + MoE-FFN] × L, optional leading dense layers (deepseek-v3:
        MLA, 3 dense layers first; llama4-scout: GQA, every layer MoE)
ssm   — [Mamba-2 mixer] × L (mamba2-370m)
hybrid — [(rec, rec, local-attn) superblock] × L/3 + a tail of rec
        sublayers (recurrentgemma-9b); each sublayer a temporal block
        (RG-LRU or local GQA) and a SwiGLU MLP

Per-layer parameters are stacked along a leading layer axis, as the
reference's ``vmap``-ed init stacks them; the reference scans over that
axis, the port loops over it.  ``_constrain`` places the residual stream's
batch dim on the data-parallel axes of the ambient mesh under the
``fsdp_dp`` and ``dp_zero1`` policies, where the reference pins it
(``runtime.sharding.constrain_activation_dp``: a no-op on a plain tensor
or under no mesh).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import init_rms_norm, init_swiglu, rms_norm, swiglu


def _res_scale(cfg: ModelConfig) -> float:
    """MiniCPM depth-scaled residuals (μP): scale_depth/√L; 1.0 otherwise."""
    if cfg.scale_depth > 0:
        return cfg.scale_depth / math.sqrt(cfg.n_layers)
    return 1.0


def _constrain(x, cfg: ModelConfig):
    """fsdp_dp / dp_zero1: the residual stream's batch on the DP axes."""
    if cfg.sharding_policy in ("fsdp_dp", "dp_zero1"):
        from ..runtime.sharding import constrain_activation_dp

        return constrain_activation_dp(x)
    return x


def _init_attn(gen: torch.Generator, cfg: ModelConfig, lead: tuple, dtype) -> dict:
    init = attn.init_mla if cfg.attn_type == "mla" else attn.init_gqa
    return init(gen, cfg, lead=lead, dtype=dtype)


def _attention(h, p, cfg: ModelConfig, mrope_positions=None):
    if cfg.attn_type == "mla":
        return attn.mla_attention(h, p, cfg)
    return attn.gqa_attention(h, p, cfg, mrope_positions=mrope_positions)


def _attention_decode(h, p, cfg: ModelConfig, cache, cache_len):
    if cfg.attn_type == "mla":
        return attn.mla_decode(h, p, cfg, cache, cache_len)
    return attn.gqa_decode(h, p, cfg, cache, cache_len)


def init_dense_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                      dtype=torch.float32) -> dict:
    """``n`` dense layers' parameters, stacked along a leading axis."""
    lead = (n,)
    return {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "attn": _init_attn(gen, cfg, lead, dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, lead=lead, dtype=dtype),
    }


def dense_block(x, p, cfg: ModelConfig, mrope_positions=None):
    x = _constrain(x, cfg)
    s = _res_scale(cfg)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a = _attention(h, p["attn"], cfg, mrope_positions)
    x = x + s * a
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + s * swiglu(h, p["mlp"])
    return x


def dense_block_decode(x, p, cfg: ModelConfig, cache, cache_len):
    s = _res_scale(cfg)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a, cache = _attention_decode(h, p["attn"], cfg, cache, cache_len)
    x = x + s * a
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + s * swiglu(h, p["mlp"])
    return x, cache


def init_moe_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    """``n`` MoE layers' parameters (attention + routed experts), stacked
    along a leading axis."""
    lead = (n,)
    return {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "attn": _init_attn(gen, cfg, lead, dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "moe": moe_mod.init_moe(gen, cfg, lead=lead, dtype=dtype),
    }


def moe_block(x_aux, p, cfg: ModelConfig):
    """``(x, aux) -> (x', aux + the layer's aux loss)``; no residual scale,
    as the reference."""
    x, aux = x_aux
    x = _constrain(x, cfg)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    x = x + _attention(h, p["attn"], cfg)
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    y, aux_l = moe_mod.moe_layer(h, p["moe"], cfg)
    return x + y, aux + aux_l


def moe_block_decode(x, p, cfg: ModelConfig, cache, cache_len):
    """One MoE layer's decode step, capacity factor 2.0 over the batch's
    tokens (the reference's; at batch 4 the capacity is 1 an expert)."""
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a, cache = _attention_decode(h, p["attn"], cfg, cache, cache_len)
    x = x + a
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    y, _ = moe_mod.moe_layer(h, p["moe"], cfg, capacity_factor=2.0)
    return x + y, cache


def init_ssm_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    """``n`` Mamba-2 layers' parameters, stacked along a leading axis."""
    lead = (n,)
    return {
        "ln": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mixer": ssm_mod.init_mamba2(gen, cfg, lead=lead, dtype=dtype),
    }


def ssm_block(x, p, cfg: ModelConfig):
    x = _constrain(x, cfg)
    h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(h, p["mixer"], cfg)


def ssm_block_decode(x, p, cfg: ModelConfig, cache):
    h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    y, cache = ssm_mod.mamba2_decode(h, p["mixer"], cfg, cache)
    return x + y, cache


def init_hybrid_sublayers(gen: torch.Generator, n: int | None, cfg: ModelConfig, kind: str,
                          dtype=torch.float32) -> dict:
    """``n`` hybrid sublayers of ``kind`` (``"rec"`` or ``"attn"``),
    stacked along a leading axis; ``n`` None makes one, unstacked (a tail
    sublayer)."""
    lead = () if n is None else (n,)
    p = {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, lead=lead, dtype=dtype),
    }
    if kind == "attn":
        p["temporal"] = attn.init_gqa(gen, cfg, lead=lead, dtype=dtype)
    else:
        p["temporal"] = rglru_mod.init_rglru_block(gen, cfg, lead=lead, dtype=dtype)
    return p


def hybrid_sublayer(x, p, cfg: ModelConfig, kind: str):
    x = _constrain(x, cfg)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind == "attn":
        t = attn.gqa_attention(h, p["temporal"], cfg, window=cfg.hybrid.window)
    else:
        t = rglru_mod.rglru_block(h, p["temporal"], cfg)
    x = x + t
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"])


def hybrid_sublayer_decode(x, p, cfg: ModelConfig, kind: str, cache, cache_len):
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind == "attn":
        t, cache = attn.gqa_decode(h, p["temporal"], cfg, cache, cache_len,
                                   window=cfg.hybrid.window)
    else:
        t, cache = rglru_mod.rglru_block_decode(h, p["temporal"], cfg, cache)
    x = x + t
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]), cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so cache writes land in place)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> list:
    """The per-layer trees of a stacked tree, each leaf unbound along the
    layer axis once: the backward stacks the layers' gradients in one pass
    (indexing layer by layer would add a full-size zero tensor for every
    layer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def scan_stack(x, stacked, block_fn: Callable, remat: bool):
    """``block_fn`` over the stacked layers in order, threading ``x`` (a
    tensor, or the moe stack's ``(x, aux)``).  ``remat`` recomputes
    each block's activations in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``); the
    values are the same either way."""
    for layer in _unstack(stacked):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block_fn, x, layer, use_reentrant=False)
        else:
            x = block_fn(x, layer)
    return x


def _first_leaf(tree) -> torch.Tensor:
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def scan_stack_decode(x, stacked_params, stacked_cache, block_fn: Callable):
    """Loop the stacked layers, threading the hidden state; each layer's
    cache is a view of the stacked cache, written in place.  The depth is
    the stacked parameters' (a cache's leaves differ by family)."""
    n = _first_leaf(stacked_params).shape[0]
    for i in range(n):
        x, _ = block_fn(x, _layer(stacked_params, i), _layer(stacked_cache, i))
    return x, stacked_cache
