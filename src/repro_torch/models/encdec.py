"""Encoder-decoder backbone (seamless-m4t-medium text/audio stub;
counterpart of ``repro.models.encdec``).

Encoder: bidirectional self-attention (RoPE on q and k, no mask) and a GELU
FFN over precomputed frame embeddings (the audio frontend is a stub, as in
the reference: the batch supplies ``enc_embeds`` (B, S_enc, D)).  Decoder:
causal self-attention, cross-attention over the encoder's output and a
GELU FFN over text tokens.  Each stack's parameters lie along a leading
layer axis, looped over by ``transformer.scan_stack``.

Serving: :func:`init_cache` makes the decoder's self-attention ``k``/``v``
and leaves ``cross_k``/``cross_v`` None; :func:`precompute_cross` gives
them from the encoder's output (once a sequence), and the caller sets them
in the cache, as the reference's callers do.  :func:`decode_step` writes
the step's self-attention ``k``/``v`` in place (``gqa_decode``) and reads
the cross K/V as they are.  The reference's ``ServingEngine`` and
``train_loop`` do not drive this family (their batches carry no
``enc_embeds``); it runs through ``Model.loss`` / ``value_and_grad`` /
``init_cache`` / ``decode_step`` and :func:`encode` / :func:`precompute_cross`.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..runtime import sharding as shr
from . import attention as attn
from . import transformer as tfm
from .layers import (apply_rope, embed, gelu_mlp, init_embedding, init_gelu_mlp, init_linear,
                     init_rms_norm, linear, rms_norm)


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def _n_dec(cfg: ModelConfig) -> int:
    return cfg.n_dec_layers or cfg.n_layers


def init_enc_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    """``n`` encoder layers' parameters, stacked along a leading axis."""
    lead = (n,)
    return {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "attn": attn.init_gqa(gen, cfg, lead=lead, dtype=dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, lead=lead, dtype=dtype),
    }


def init_dec_layers(gen: torch.Generator, n: int, cfg: ModelConfig,
                    dtype=torch.float32) -> dict:
    """``n`` decoder layers' parameters, stacked along a leading axis."""
    lead = (n,)
    return {
        "ln1": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "attn": attn.init_gqa(gen, cfg, lead=lead, dtype=dtype),
        "lnx": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "cross": attn.init_gqa(gen, cfg, lead=lead, dtype=dtype),
        "ln2": init_rms_norm(gen, cfg.d_model, lead=lead, dtype=dtype),
        "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, lead=lead, dtype=dtype),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The reference's tree: no ``ln_f``; ``ln_enc``, ``ln_dec`` and an
    untied ``head``."""
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype=dtype),
        "enc_layers": init_enc_layers(gen, _n_enc(cfg), cfg, dtype),
        "dec_layers": init_dec_layers(gen, _n_dec(cfg), cfg, dtype),
        "ln_enc": init_rms_norm(gen, cfg.d_model, dtype=dtype),
        "ln_dec": init_rms_norm(gen, cfg.d_model, dtype=dtype),
        "head": init_linear(gen, cfg.d_model, cfg.vocab, False, dtype=dtype),
    }


def _enc_block(x, p, cfg: ModelConfig):
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = attn.gqa_qkv(h, p["attn"], cfg)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    a = attn._sdpa(q, k, v, None, 1.0 / math.sqrt(hd))  # bidirectional
    x = x + linear(shr.reshape(a, b, s, -1), p["attn"]["wo"])
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + gelu_mlp(h, p["mlp"])


def _dec_block(x, memory, p, cfg: ModelConfig):
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    x = x + attn.gqa_attention(h, p["attn"], cfg)
    h = rms_norm(x, p["lnx"]["scale"], cfg.norm_eps)
    x = x + attn.cross_attention(h, memory, p["cross"], cfg)
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + gelu_mlp(h, p["mlp"])


def encode(params, enc_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's output (B, S_enc, D), in ``enc_embeds``' dtype."""
    x = tfm.scan_stack(enc_embeds, params["enc_layers"],
                       lambda h, lp: _enc_block(h, lp, cfg), cfg.remat)
    return rms_norm(x, params["ln_enc"]["scale"], cfg.norm_eps)


def decode_train(params, tokens: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S_dec, vocab), embedded in
    ``memory``'s dtype."""
    x = embed(tokens, params["embed"], memory.dtype)
    x = tfm.scan_stack(x, params["dec_layers"],
                       lambda h, lp: _dec_block(h, memory, lp, cfg), cfg.remat)
    h = rms_norm(x, params["ln_dec"]["scale"], cfg.norm_eps)
    return linear(h, params["head"])


def encdec_loss(params, batch, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """``(ce, {"ce", "loss"})`` over ``{"enc_embeds", "tokens", "labels"}``."""
    from .model import cross_entropy

    memory = encode(params, batch["enc_embeds"].to(getattr(torch, cfg.dtype)), cfg)
    logits = decode_train(params, batch["tokens"], memory, cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "loss": ce}


# ---------------------------------------------------------------------------
# serving path
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Self-attention ``k``/``v`` (n_dec, B, max_len, KH, hd) zeroed;
    ``cross_k``/``cross_v`` None until :func:`precompute_cross` fills them."""
    shape = (_n_dec(cfg), batch_size, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cross_k": None, "cross_v": None}


def precompute_cross(params, memory: torch.Tensor,
                     cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked cross-attention K/V (n_dec, B, S_enc, KH, hd) from the
    encoder's output, in its dtype (the reference ``vmap``s over the
    layers; the port loops)."""
    b, sk, _ = memory.shape
    hd = cfg.resolved_head_dim
    ks, vs = [], []
    for lp in tfm._unstack(params["dec_layers"]["cross"]):
        ks.append(shr.reshape(linear(memory, lp["wk"]), b, sk, cfg.n_kv_heads, hd))
        vs.append(shr.reshape(linear(memory, lp["wv"]), b, sk, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(params, token: torch.Tensor, cache: dict, cache_len: int,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decoder token: ``(logits (B, vocab), cache)``, the self-attention
    cache written in place at ``cache_len``."""
    if cache["cross_k"] is None or cache["cross_v"] is None:
        raise ValueError("the cache has no cross-attention K/V: set cache['cross_k'], "
                         "cache['cross_v'] = precompute_cross(params, encode(...), cfg)")
    x = embed(token[:, None], params["embed"], getattr(torch, cfg.dtype))
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    for i in range(_n_dec(cfg)):
        lp = tfm._layer(params["dec_layers"], i)
        hh = rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        a, _ = attn.gqa_decode(hh, lp["attn"], cfg, {"k": cache["k"][i], "v": cache["v"][i]},
                               cache_len)
        x = x + a
        hh = rms_norm(x, lp["lnx"]["scale"], cfg.norm_eps)
        q = shr.reshape(linear(hh, lp["cross"]["wq"]), b, 1, cfg.n_heads, hd)
        a = attn._sdpa(q, cache["cross_k"][i], cache["cross_v"][i], None, scale)
        x = x + linear(shr.reshape(a, b, 1, -1), lp["cross"]["wo"])
        hh = rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
        x = x + gelu_mlp(hh, lp["mlp"])
    h = rms_norm(x, params["ln_dec"]["scale"], cfg.norm_eps)
    return linear(h, params["head"])[:, 0], cache
