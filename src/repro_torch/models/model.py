"""Model facade: init / train forward / cache / decode for all six
families (counterpart of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model`.  The port runs the dense
decoder (qwen2.5-3b, qwen1.5-4b, minicpm-2b with its μP scaling,
deepseek-67b), the vlm family (qwen2-vl-72b: dense layers, M-RoPE from
``batch["positions_3d"]`` over ``batch["embeds"]``, the vision frontend a
stub as in the reference), the ssm family (mamba2-370m), the moe family
(deepseek-v3-671b: MLA, leading dense layers, 256 routed experts and the
multi-token-prediction head; llama4-scout-17b-a16e: GQA, 16 routed
experts), the hybrid family (recurrentgemma-9b: ``(rec, rec, attn)``
superblocks of RG-LRU and local-attention sublayers, then a tail of rec
sublayers), the encdec family (seamless-m4t-medium, routed to
``models/encdec.py``), and their smoke cuts.  A family the reference does
not know raises ``ValueError``, as the reference's ``init`` does.

Entry points run on the card unless the caller names another device
(``device="cpu"``, as the tests do).

Conventions, as the reference's: parameters in ``cfg.param_dtype``, compute
in ``cfg.dtype`` (qwen2.5-3b: bfloat16 over float32 parameters); decode
takes ``token`` (B,) int and a cache of stacked per-layer ``k``/``v`` of
shape ``(n_layers, B, S_max, KH, hd)`` (ssm: ``state`` (n_layers, B, H, P,
N) float32 and ``conv`` (n_layers, B, d_conv - 1, conv_dim); moe:
``{"dense": ..., "moe": ...}``, one such tree for each stack, ``None`` for
no dense layers, MLA's holding ``c_kv`` (n, B, S_max, kv_rank) and
``k_rope`` (n, B, S_max, 1, rope_dim); hybrid: ``{"rec_a", "rec_b",
"tail": {"h": (n, B, W) float32, "conv": (n, B, cw - 1, W)}, "attn": {"k",
"v": (n_super, B, min(window, S_max), KH, hd)}}``, the attention cache a
ring; encdec: ``{"k", "v", "cross_k", "cross_v"}``, the cross K/V from
``encdec.precompute_cross``) and returns ``(logits, cache)``.
The port's ``decode_step`` writes the cache in place and returns the same
dict (the reference returns an updated copy).
Training takes ``{"tokens": (B, S) int, "labels": (B, S) int}`` (vlm:
``{"embeds": (B, S, D), "positions_3d": (B, S, 3) int, "labels"}``; encdec:
``{"enc_embeds": (B, S_enc, D), "tokens", "labels"}``): ``loss`` returns
``(loss, {"ce", "aux", "loss"})`` (with MTP also ``"mtp_ce"``; encdec
``{"ce", "loss"}``) and is differentiable in the parameters;
:meth:`Model.value_and_grad` is the reference's
``jax.value_and_grad(model.loss, has_aux=True)``.

:func:`load_params` carries the reference's parameters across: a pytree of
numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the port's
tensors on a given device, so both packages run on the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import api
from ..core import pipeline as pl
from ..runtime import sharding as shr
from . import attention as attn
from . import encdec as encdec_mod
from . import ssm as ssm_mod
from . import transformer as tfm
from .layers import (
    META,
    embed,
    init_embedding,
    init_linear,
    init_rms_norm,
    linear,
    rms_norm,
)

_PORTED = ("dense", "vlm", "ssm", "moe", "hybrid", "encdec")
# a hybrid superblock's sublayers, in order: (parameter and cache key, kind)
_SUPERBLOCK = (("rec_a", "rec"), ("rec_b", "rec"), ("attn", "attn"))


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, str(name))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over tokens of float32 ``logsumexp`` minus the label's logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = shr.take_last(logits, labels)
    return (logz - ll).mean()


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        raise ValueError(f"unknown family {cfg.family}")


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
        _check_family(cfg)
        device = _device(device)
        dt = _torch_dtype(cfg.param_dtype)
        if cfg.family == "encdec":
            params = encdec_mod.init_encdec(generator, cfg, dt)
            return params if generator.device == device else load_params(params, device)
        params: dict[str, Any] = {
            "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt),
            "ln_f": init_rms_norm(generator, cfg.d_model, dtype=dt),
        }
        if not cfg.tie_embeddings:
            params["head"] = init_linear(generator, cfg.d_model, cfg.vocab, False, dtype=dt)
        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            if nd:
                params["dense_layers"] = tfm.init_dense_layers(generator, nd,
                                                               self._dense_ffn_cfg(), dt)
            params["moe_layers"] = tfm.init_moe_layers(generator, cfg.n_layers - nd, cfg, dt)
            if cfg.mtp:
                params["mtp"] = {
                    "proj": init_linear(generator, 2 * cfg.d_model, cfg.d_model, False, dtype=dt),
                    "ln_h": init_rms_norm(generator, cfg.d_model, dtype=dt),
                    "ln_e": init_rms_norm(generator, cfg.d_model, dtype=dt),
                    "block": _unstacked(tfm.init_dense_layers(generator, 1,
                                                              self._dense_ffn_cfg(), dt)),
                }
        elif cfg.family == "hybrid":
            nsuper, tail = divmod(cfg.n_layers, len(cfg.hybrid.pattern))
            params["super"] = {name: tfm.init_hybrid_sublayers(generator, nsuper, cfg, kind, dt)
                               for name, kind in _SUPERBLOCK}
            params["tail"] = [tfm.init_hybrid_sublayers(generator, None, cfg, "rec", dt)
                              for _ in range(tail)]
        else:
            init_layers = tfm.init_ssm_layers if cfg.family == "ssm" else tfm.init_dense_layers
            params["layers"] = init_layers(generator, cfg.n_layers, cfg, dt)
        return params if generator.device == device else load_params(params, device)

    def _dense_ffn_cfg(self) -> ModelConfig:
        """The moe family's dense layers (and MTP block): FFN width
        ``moe.d_ff_dense`` where given."""
        return replace(self.cfg, d_ff=self.cfg.moe.d_ff_dense or self.cfg.d_ff)

    def param_shapes(self) -> dict:
        """The parameters' tree on the ``meta`` device: shapes and dtypes,
        no memory (the reference's ``jax.eval_shape(model.init, key)``)."""
        return self.init(META, "meta")

    # ---------------- embedding / head ----------------

    def _embed_in(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(_torch_dtype(cfg.dtype))
        else:
            x = embed(batch["tokens"], params["embed"], _torch_dtype(cfg.dtype))
        return x * cfg.scale_emb if cfg.scale_emb != 1.0 else x

    def _head(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.scale_depth > 0:  # minicpm μP output scaling
            h = h / (cfg.d_model / cfg.dim_model_base)
        if cfg.tie_embeddings:
            return h @ params["embed"]["table"].to(h.dtype).T
        return linear(h, params["head"])

    # ---------------- backbone ----------------

    def _backbone(self, params, x: torch.Tensor, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden, aux_loss); the aux loss is the moe layers' sum
        (0 for the other families)."""
        cfg = self.cfg
        _check_family(cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            def superblock(h, lp):
                for name, kind in _SUPERBLOCK:
                    h = tfm.hybrid_sublayer(h, lp[name], cfg, kind)
                return h

            # remat wraps the whole superblock, as jax.checkpoint(superblock)
            x = tfm.scan_stack(x, params["super"], superblock, cfg.remat)
            for tp in params["tail"]:
                x = tfm.hybrid_sublayer(x, tp, cfg, "rec")
            return x, aux
        if cfg.family == "moe":
            if "dense_layers" in params:
                dense_cfg = self._dense_ffn_cfg()
                x = tfm.scan_stack(x, params["dense_layers"],
                                   lambda h, lp: tfm.dense_block(h, lp, dense_cfg), cfg.remat)
            return tfm.scan_stack((x, aux), params["moe_layers"],
                                  lambda c, lp: tfm.moe_block(c, lp, cfg), cfg.remat)
        if cfg.family == "ssm":
            block = lambda h, lp: tfm.ssm_block(h, lp, cfg)  # noqa: E731
        else:
            mrope_pos = batch.get("positions_3d") if cfg.mrope else None
            block = lambda h, lp: tfm.dense_block(h, lp, cfg, mrope_positions=mrope_pos)  # noqa: E731
        return tfm.scan_stack(x, params["layers"], block, cfg.remat), aux

    # ---------------- train ----------------

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """``(loss, {"ce", "aux", "loss"})``: the float32 mean cross-entropy
        of the next tokens plus the auxiliary loss (the moe layers'; 0
        otherwise); with MTP (deepseek-v3) plus 0.3 times ``"mtp_ce"``, the
        cross-entropy of the token after the next from the MTP block over
        the final hidden state and the next token's embedding.  encdec:
        ``encdec.encdec_loss``, ``(ce, {"ce", "loss"})``."""
        cfg = self.cfg
        _check_family(cfg)
        if cfg.family == "encdec":
            return encdec_mod.encdec_loss(params, batch, cfg)
        x = self._embed_in(params, batch)
        h, aux = self._backbone(params, x, batch)
        h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = self._head(params, h)
        ce = cross_entropy(logits, batch["labels"])
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp and "mtp" in params:
            mtp = params["mtp"]
            labels = batch["labels"]
            emb_next = embed(labels, params["embed"], h.dtype)
            merged = torch.cat([rms_norm(h, mtp["ln_h"]["scale"], cfg.norm_eps),
                                rms_norm(emb_next, mtp["ln_e"]["scale"], cfg.norm_eps)], dim=-1)
            h2 = tfm.dense_block(linear(merged, mtp["proj"]), mtp["block"], self._dense_ffn_cfg())
            logits2 = self._head(params, h2)
            # MTP predicts token t+2: labels shifted left by one
            mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
            mtp_ce = cross_entropy(logits2[:, :-1], mtp_labels[:, :-1])
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    def value_and_grad(self, params, batch) -> tuple[tuple[torch.Tensor, dict], dict]:
        """``((loss, metrics), grads)``, ``grads`` a tree like ``params`` (the
        reference's ``jax.value_and_grad(model.loss, has_aux=True)``; a leaf
        the loss does not read gets zeros).  The caller's tensors are left as
        they are: the loss is taken over
        aliases of them that require grad."""
        live = {k: t.detach().requires_grad_(True) for k, t in api.flatten_with_keys(params)}
        with torch.enable_grad():
            loss, metrics = self.loss(api.unflatten_like(params, live.__getitem__), batch)
            # a leaf the loss does not read (the embedding under ``embeds``)
            # gets zeros, as the reference's gradient does
            grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()),
                                                       allow_unused=True, materialize_grads=True)))
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                api.unflatten_like(params, grads.__getitem__))

    # ---------------- serving: cache init / decode ----------------

    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """Zeroed KV cache ``{"k", "v"}``, each ``(n_layers, B, S_max, KH, hd)``
        (KH = ``n_kv_heads * kv_replicate``) on ``device`` (default: the
        card): the reference's layout, which
        parked containers record.  ssm: ``{"state": (n_layers, B, H, P, N)
        float32, "conv": (n_layers, B, d_conv - 1, conv_dim) dtype}``, O(1)
        in ``max_len``.  moe: ``{"dense": stack or None, "moe": stack}``,
        each stack GQA's ``{"k", "v"}`` or MLA's compressed ``{"c_kv":
        (n, B, S_max, kv_rank), "k_rope": (n, B, S_max, 1, rope_dim)}``.
        hybrid: ``{"rec_a", "rec_b", "tail"}`` of ``{"h": (n, B, W) float32,
        "conv": (n, B, cw - 1, W)}`` and ``"attn"``'s ring ``{"k", "v":
        (n_super, B, min(window, max_len), KH, hd)}``.  encdec:
        ``encdec.init_cache`` (``cross_k``/``cross_v`` None)."""
        cfg = self.cfg
        _check_family(cfg)
        device = _device(device)
        if cfg.family == "encdec":
            return encdec_mod.init_cache(cfg, batch_size, max_len, dtype, device)
        if cfg.family == "hybrid":
            nsuper, tail = divmod(cfg.n_layers, len(cfg.hybrid.pattern))
            w = cfg.hybrid.lru_width or cfg.d_model
            cw = cfg.hybrid.conv_width

            def rec(n: int) -> dict:
                return {"h": torch.zeros((n, batch_size, w), dtype=torch.float32, device=device),
                        "conv": torch.zeros((n, batch_size, cw - 1, w), dtype=dtype,
                                            device=device)}

            return {"rec_a": rec(nsuper), "rec_b": rec(nsuper),
                    "attn": self._kv(nsuper, batch_size, min(cfg.hybrid.window, max_len), dtype,
                                     device, cfg.n_kv_heads),
                    "tail": rec(tail)}
        if cfg.family == "moe":
            def stack(n: int) -> dict:
                if cfg.attn_type == "mla":
                    m = cfg.mla
                    return {"c_kv": torch.zeros((n, batch_size, max_len, m.kv_lora_rank),
                                                dtype=dtype, device=device),
                            "k_rope": torch.zeros((n, batch_size, max_len, 1, m.qk_rope_head_dim),
                                                  dtype=dtype, device=device)}
                return self._kv(n, batch_size, max_len, dtype, device)

            nd = cfg.moe.first_dense_layers
            return {"dense": stack(nd) if nd else None, "moe": stack(cfg.n_layers - nd)}
        if cfg.family == "ssm":
            d_inner, h, p_, g, n = ssm_mod._dims(cfg)
            conv_shape = (cfg.n_layers, batch_size, cfg.ssm.d_conv - 1, d_inner + 2 * g * n)
            return {"state": torch.zeros((cfg.n_layers, batch_size, h, p_, n),
                                         dtype=torch.float32, device=device),
                    "conv": torch.zeros(conv_shape, dtype=dtype, device=device)}
        return self._kv(cfg.n_layers, batch_size, max_len, dtype, device)

    def _kv(self, n: int, batch_size: int, max_len: int, dtype, device,
            heads: int | None = None) -> dict:
        """A GQA stack's ``{"k", "v"}``: ``n_kv_heads * kv_replicate`` heads
        (the hybrid's ring: ``n_kv_heads``, as the reference's)."""
        if heads is None:
            heads = self.cfg.n_kv_heads * self.cfg.kv_replicate
        shape = (n, batch_size, max_len, heads, self.cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache: dict, cache_len: int):
        """One decode step: ``token`` (B,) int → ``(logits (B, vocab), cache)``,
        the cache written in place at position ``cache_len``."""
        cfg = self.cfg
        _check_family(cfg)
        if cfg.family == "encdec":
            return encdec_mod.decode_step(params, token, cache, cache_len, cfg)
        x = self._embed_in(params, {"tokens": token[:, None]})
        if cfg.family == "hybrid":
            def superblock(h, lp, lc):
                for name, kind in _SUPERBLOCK:
                    h, _ = tfm.hybrid_sublayer_decode(h, lp[name], cfg, kind, lc[name], cache_len)
                return h, lc

            x, _ = tfm.scan_stack_decode(
                x, params["super"], {name: cache[name] for name, _ in _SUPERBLOCK}, superblock)
            for i, tp in enumerate(params["tail"]):
                x, _ = tfm.hybrid_sublayer_decode(x, tp, cfg, "rec", tfm._layer(cache["tail"], i),
                                                  cache_len)
        elif cfg.family == "moe":
            if "dense_layers" in params:
                dense_cfg = self._dense_ffn_cfg()
                x, _ = tfm.scan_stack_decode(
                    x, params["dense_layers"], cache["dense"],
                    lambda h, lp, lc: tfm.dense_block_decode(h, lp, dense_cfg, lc, cache_len))
            x, _ = tfm.scan_stack_decode(
                x, params["moe_layers"], cache["moe"],
                lambda h, lp, lc: tfm.moe_block_decode(h, lp, cfg, lc, cache_len))
        else:
            if cfg.family == "ssm":
                block = lambda h, lp, lc: tfm.ssm_block_decode(h, lp, cfg, lc)  # noqa: E731
            else:  # vlm decodes on tokens with plain RoPE at cache_len, as the reference
                block = lambda h, lp, lc: tfm.dense_block_decode(  # noqa: E731
                    h, lp, cfg, lc, cache_len)
            x, _ = tfm.scan_stack_decode(x, params["layers"], cache, block)
        h = rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
        logits = self._head(params, h)[:, 0]
        return logits, cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _unstacked(tree: dict) -> dict:
    """The one layer of a stack of one (the MTP block is a single dense
    layer, with no leading axis, as the reference's)."""
    return {k: _unstacked(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


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
