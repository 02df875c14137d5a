"""GQA, local, cross and MLA attention (counterpart of
``repro.models.attention``: ``causal_mask``, ``local_causal_mask``,
``init_gqa``, ``gqa_qkv``, ``_sdpa``, ``gqa_attention`` for the training
forward and ``gqa_decode``; ``cross_attention`` of the encdec family;
DeepSeek-V3's Multi-head Latent Attention ``init_mla``, ``_mla_qkv``,
``mla_attention`` and ``mla_decode``).

Shapes: hidden (B, S, D); q/k/v (B, S, H, hd); the KV cache of one layer
``{"k": (B, S_max, KH, hd), "v": ...}``; MLA's compressed cache of one
layer ``{"c_kv": (B, S_max, kv_lora_rank), "k_rope": (B, S_max, 1,
qk_rope_head_dim)}``.  Scores and the softmax run in
float32, as the reference computes them, with an additive -1e9 mask (no
``scaled_dot_product_attention``: its masking and accumulation differ, and
the reference fuses nothing here).  ``gqa_attention`` takes the VLM
family's M-RoPE positions ``(B, S, 3)``; decode keeps plain RoPE at
``cache_len``, as the reference's does.  The hybrid family's local
attention masks keys more than ``window`` positions back in the forward
(:func:`local_causal_mask`); its decode cache is a ring of
``min(window, max_len)`` slots, written at ``cache_len % S_max``, every
slot live once the ring has wrapped.

``gqa_decode`` writes the step's k/v into the cache *in place* (the
reference returns an updated copy): the decode loop owns the cache and
every step would otherwise copy all of it.  ``kv_replicate`` repeats each
KV head that many times before the write, as the reference does, so the
cache holds ``n_kv_heads * kv_replicate`` heads (its head dim then fills a
mesh's model axis); the attention is the same.  ``decode_masked_update``
gives the reference's masked ``where`` over every slot, which selects the
step's slot alone, or none past the end: so it is the slot write, and
nothing past the end.  On a placed cache (a DTensor, its sequence dim
sharded) the slot write lands on the rank that holds the slot, in that
rank's local block (DTensor has no strategy for an indexed write into a
sharded dim).

MLA keeps the reference's expanded form: every decode step expands the
cached latents of all ``S_max`` slots through ``wkv_b`` to per-head k and v
(the weight-absorbed form is a performance change the reference leaves as
an option).  ``mla_decode`` writes the step's latents into the cache in
place at ``cache_len``, as ``gqa_decode`` does; past the end the slot
write lands on the last slot, where the reference's
``dynamic_update_slice`` clamps it, and the masked write
(``decode_masked_update``) writes nothing, as the reference's
``iota == cache_len`` selects no slot.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import MLAConfig, ModelConfig
from ..runtime import sharding as shr
from .layers import apply_mrope, apply_rope, init_linear, init_rms_norm, linear, rms_norm

NEG_INF = -1e9


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) float32: 0 where key position <= query position, else -1e9."""
    q_pos = torch.arange(s_q, dtype=torch.int32, device=device)[:, None] + q_offset
    k_pos = torch.arange(s_k, dtype=torch.int32, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(k_pos <= q_pos, zero, NEG_INF)


def local_causal_mask(s_q: int, s_k: int, window: int, q_offset: int = 0,
                      device=None) -> torch.Tensor:
    """(s_q, s_k) float32: 0 where the key is at most ``window - 1``
    positions before the query (and not after it), else -1e9."""
    q_pos = torch.arange(s_q, dtype=torch.int32, device=device)[:, None] + q_offset
    k_pos = torch.arange(s_k, dtype=torch.int32, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where((k_pos <= q_pos) & (k_pos > q_pos - window), zero, NEG_INF)


def _sdpa(q, k, v, mask, scale):
    """q/k: (B,S,·,qk_dim), v: (B,Sk,KH,v_dim); H = G·KH (GQA repeat)."""
    b, sq, h, _ = q.shape
    kh = k.shape[2]
    g = h // kh
    vd = v.shape[-1]
    dtype = q.dtype
    q = shr.reshape(q, b, sq, kh, g, q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores * scale
    if mask is not None:
        scores = scores + mask  # (Sq, Sk) broadcast
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return shr.reshape(out, b, sq, h, vd).to(dtype)


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
    q = shr.reshape(linear(x, p["wq"]), b, s, cfg.n_heads, hd)
    k = shr.reshape(linear(x, p["wk"]), b, s, cfg.n_kv_heads, hd)
    v = shr.reshape(linear(x, p["wv"]), b, s, cfg.n_kv_heads, hd)
    return q, k, v


def gqa_attention(
    x: torch.Tensor,            # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    positions: torch.Tensor | None = None,
    window: int = 0,
    mrope_positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal GQA over the whole sequence (the training forward), local
    over the last ``window`` positions where ``window`` > 0; with
    ``cfg.mrope`` and ``mrope_positions`` (B, S, 3), M-RoPE in place of
    RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = gqa_qkv(x, p, cfg)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = (local_causal_mask(s, s, window, device=x.device) if window > 0
            else causal_mask(s, s, device=x.device))
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    return linear(shr.reshape(out, b, s, -1), p["wo"])


def write_slot_(cache: torch.Tensor, pos: int, value: torch.Tensor, masked: bool) -> None:
    """Write ``value`` (B, 1, ...) into slot ``pos`` of ``cache`` (B, S_max,
    ...) in place.  ``masked``: the reference's ``where(iota == pos, value,
    cache)``, which writes the same slot, and no slot when ``pos`` is past
    the end.  A placed cache takes the slot write in the local block of the
    rank that holds the slot."""
    if masked and pos >= cache.shape[1]:
        return
    value = value.to(cache.dtype)
    if not shr.is_placed(cache):
        cache[:, pos] = value[:, 0]
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    # the value laid out as the cache is, the slot dim whole on every rank
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in cache.placements]
    local_value = value.redistribute(mesh, want).to_local()
    shape, offset = shr.local_block(cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + shape[1]:
        cache.to_local()[:, pos - offset[1]] = local_value[:, 0]


def gqa_decode(
    x: torch.Tensor,            # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache: dict,                # {"k": (B, S_max, KH, hd), "v": ...}, written in place
    cache_len: int,             # tokens already in cache
    # unused, as the reference's (the cache's size sets the ring); kept so
    # that the two packages' callers pass the same arguments
    window: int = 0,
) -> tuple[torch.Tensor, dict]:
    del window
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = gqa_qkv(x, p, cfg)
    pos = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.kv_replicate > 1:
        # each KV head repeated in place along the head axis (jnp.repeat)
        k = torch.repeat_interleave(k, cfg.kv_replicate, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_replicate, dim=2)
    # ring write: window caches are sized `window`, full caches max_len
    # (write_pos == cache_len there); RoPE is absolute, so ring order does
    # not matter, validity is all that is masked
    s_max = cache["k"].shape[1]
    write_pos = int(cache_len) % s_max
    write_slot_(cache["k"], write_pos, k, cfg.decode_masked_update)
    write_slot_(cache["v"], write_pos, v, cfg.decode_masked_update)
    slot = torch.arange(s_max, dtype=torch.int32, device=x.device)
    valid = slot <= int(cache_len)  # ring-full => every slot holds a live token
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, :]  # (1, S)
    out = _sdpa(q, cache["k"], cache["v"], mask, 1.0 / math.sqrt(hd))
    y = linear(shr.reshape(out, b, 1, -1), p["wo"])
    return y, cache


def cross_attention(
    x: torch.Tensor,            # (B, Sq, D) decoder states
    memory: torch.Tensor,       # (B, Sk, D) encoder output
    p: dict,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Every query over every memory position: no RoPE, no mask."""
    b, sq, _ = x.shape
    sk = memory.shape[1]
    hd = cfg.resolved_head_dim
    q = shr.reshape(linear(x, p["wq"]), b, sq, cfg.n_heads, hd)
    k = shr.reshape(linear(memory, p["wk"]), b, sk, cfg.n_kv_heads, hd)
    v = shr.reshape(linear(memory, p["wv"]), b, sk, cfg.n_kv_heads, hd)
    out = _sdpa(q, k, v, None, 1.0 / math.sqrt(hd))
    return linear(shr.reshape(out, b, sq, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
             dtype=torch.float32) -> dict:
    m: MLAConfig = cfg.mla
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": init_linear(gen, cfg.d_model, m.q_lora_rank, False, lead=lead, dtype=dtype),
        "q_norm": init_rms_norm(gen, m.q_lora_rank, lead=lead, dtype=dtype),
        "wq_b": init_linear(gen, m.q_lora_rank, cfg.n_heads * qk_dim, False, lead=lead,
                            dtype=dtype),
        "wkv_a": init_linear(gen, cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim, False,
                             lead=lead, dtype=dtype),
        "kv_norm": init_rms_norm(gen, m.kv_lora_rank, lead=lead, dtype=dtype),
        "wkv_b": init_linear(gen, m.kv_lora_rank, cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim),
                             False, lead=lead, dtype=dtype),
        "wo": init_linear(gen, cfg.n_heads * m.v_head_dim, cfg.d_model, False, lead=lead,
                          dtype=dtype),
    }


def _mla_q(x, p, cfg: ModelConfig, positions):
    """Per-head queries (B, S, H, nope + rope), RoPE on the rope part."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    q = linear(rms_norm(linear(x, p["wq_a"]), p["q_norm"]["scale"], cfg.norm_eps), p["wq_b"])
    q = shr.reshape(q, b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)


def _mla_latents(x, p, cfg: ModelConfig, positions):
    """What the cache holds: the normed latents ``c_kv`` (B, S, kv_rank) and
    the shared rotary key ``k_rope`` (B, S, 1, rope_dim)."""
    m: MLAConfig = cfg.mla
    kv_a = linear(x, p["wkv_a"])  # (B, S, kv_rank + rope_dim)
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"]["scale"], cfg.norm_eps)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def _mla_expand(c_kv, k_rope, p, cfg: ModelConfig):
    """Latents to per-head k (B, S, H, nope + rope) and v (B, S, H, v_dim),
    in the latents' dtype."""
    m: MLAConfig = cfg.mla
    b, s, _ = c_kv.shape
    h = cfg.n_heads
    kv = shr.reshape(linear(c_kv, p["wkv_b"]), b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope.expand(b, s, h, m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _mla_qkv(x, p, cfg: ModelConfig, positions):
    """Expand MLA latents to per-head q, k, v (the paper's shapes); also
    returns the latents ``(c_kv, k_rope)``."""
    c_kv, k_rope = _mla_latents(x, p, cfg, positions)
    k, v = _mla_expand(c_kv, k_rope, p, cfg)
    return _mla_q(x, p, cfg, positions), k, v, (c_kv, k_rope)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def mla_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal MLA over the whole sequence (the training forward)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    q, k, v, _ = _mla_qkv(x, p, cfg, positions)
    out = _sdpa(q, k, v, causal_mask(s, s, device=x.device), _mla_scale(cfg))
    return linear(shr.reshape(out, b, s, -1), p["wo"])


def mla_decode(
    x: torch.Tensor,            # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache: dict,                # {"c_kv": (B, S_max, kv_rank), "k_rope": (B, S_max, 1, rope_dim)}
    cache_len: int,
) -> tuple[torch.Tensor, dict]:
    """MLA decode over the *compressed* latent cache (kv_rank + rope_dim
    floats a token, 576 at DeepSeek-V3, against 2·H·hd = 32768 expanded),
    written in place at ``cache_len``."""
    b = x.shape[0]
    pos = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=x.device)
    q = _mla_q(x, p, cfg, pos)
    c_kv_new, k_rope_new = _mla_latents(x, p, cfg, pos)
    s_max = cache["c_kv"].shape[1]
    masked = cfg.decode_masked_update
    # dynamic_update_slice clamps its start; the masked write selects no
    # slot past the end
    write_pos = int(cache_len) if masked else min(int(cache_len), s_max - 1)
    write_slot_(cache["c_kv"], write_pos, c_kv_new, masked)
    write_slot_(cache["k_rope"], write_pos, k_rope_new, masked)
    k, v = _mla_expand(cache["c_kv"], cache["k_rope"], p, cfg)
    k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)[None, :]
    mask = torch.where(k_pos <= int(cache_len), 0.0, NEG_INF).float()
    out = _sdpa(q, k, v, mask, _mla_scale(cfg))
    y = linear(shr.reshape(out, b, 1, -1), p["wo"])
    return y, cache
