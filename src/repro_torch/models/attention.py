"""GQA attention for decoding (counterpart of ``repro.models.attention``, the
part the dense decoder runs: ``init_gqa``, ``gqa_qkv``, ``_sdpa`` and
``gqa_decode``).

Shapes: hidden (B, S, D); q/k/v (B, S, H, hd); the KV cache of one layer
``{"k": (B, S_max, KH, hd), "v": ...}``.  Scores and the softmax run in
float32, as the reference computes them, with an additive -1e9 mask.

``gqa_decode`` writes the step's k/v into the cache *in place* (the
reference returns an updated copy): the decode loop owns the cache and
every step would otherwise copy all of it.  The reference's
``kv_replicate`` and ``decode_masked_update`` are layout levers for sharded
meshes; the masked update computes the same values as the slice write, and
a replicated cache is refused (it changes the cache's layout, which parked
containers record).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, init_linear, linear

NEG_INF = -1e9


def _sdpa(q, k, v, mask, scale):
    """q/k: (B,S,·,qk_dim), v: (B,Sk,KH,v_dim); H = G·KH (GQA repeat)."""
    b, sq, h, _ = q.shape
    kh = k.shape[2]
    g = h // kh
    vd = v.shape[-1]
    dtype = q.dtype
    q = q.reshape(b, sq, kh, g, q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores * scale
    if mask is not None:
        scores = scores + mask  # (Sq, Sk) broadcast
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, vd).to(dtype)


def init_gqa(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
             dtype=torch.float32) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": init_linear(gen, cfg.d_model, cfg.n_heads * hd, cfg.qkv_bias, lead=lead, dtype=dtype),
        "wk": init_linear(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias, lead=lead,
                          dtype=dtype),
        "wv": init_linear(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias, lead=lead,
                          dtype=dtype),
        "wo": init_linear(gen, cfg.n_heads * hd, cfg.d_model, False, lead=lead, dtype=dtype),
    }


def gqa_qkv(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = linear(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def check_cache_layout(cfg: ModelConfig) -> None:
    if cfg.kv_replicate != 1:
        raise NotImplementedError(
            f"kv_replicate={cfg.kv_replicate} replicates KV heads for a sharded mesh; the "
            "port keeps the reference's unreplicated cache layout (see ROADMAP.md)")


def gqa_decode(
    x: torch.Tensor,            # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache: dict,                # {"k": (B, S_max, KH, hd), "v": ...}, written in place
    cache_len: int,             # tokens already in cache
) -> tuple[torch.Tensor, dict]:
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    check_cache_layout(cfg)
    q, k, v = gqa_qkv(x, p, cfg)
    pos = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    # ring write: window caches are sized `window`, full caches max_len
    # (write_pos == cache_len there); RoPE is absolute, so ring order does
    # not matter, validity is all that is masked
    s_max = cache["k"].shape[1]
    write_pos = int(cache_len) % s_max
    cache["k"][:, write_pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_pos] = v[:, 0].to(cache["v"].dtype)
    slot = torch.arange(s_max, dtype=torch.int32, device=x.device)
    valid = slot <= int(cache_len)  # ring-full => every slot holds a live token
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, :]  # (1, S)
    out = _sdpa(q, cache["k"], cache["v"], mask, 1.0 / math.sqrt(hd))
    y = linear(out.reshape(b, 1, -1), p["wo"])
    return y, cache
