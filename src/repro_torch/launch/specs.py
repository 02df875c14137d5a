"""Input specs and step builders for every cell (counterpart of
``repro.launch.specs``).

``batch_specs`` / ``param_specs`` / ``opt_state_specs`` / ``cache_specs`` /
``token_specs`` return trees of meta DTensors placed over a mesh: shapes,
dtypes and placements, no memory (the reference's sharded
``ShapeDtypeStruct``\\ s).  Modality frontends are stubs, as in the
reference: audio and vlm cells take precomputed frame or patch embeddings
(and qwen2-vl's 3-D M-RoPE positions).

``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` build
the step functions that the dry run runs on those specs and the trainer
runs on placed tensors.  The steps run eagerly on DTensors: every op
propagates its inputs' placements and issues the collectives it needs.
The reference's sharding constraints become redistributions at the same
places (``runtime.sharding.constrain_activation_dp``, the ZeRO-1 gradient
placement below, the grouped MoE dispatch's).  Plain tensors made inside
the model (masks, positions, rotary tables) count as replicated
(``runtime.sharding.placed_ops``).

Where DTensor has no sharding strategy for an op of the port, the code
makes the op exact another way, and the collectives recorder
(``runtime.comm_analysis``) counts what that moves:

* ``models/layers.py`` ``embed``: the custom ``_Embed`` (its backward's
  ``index_put_``) runs on local tensors: the table is made whole, each
  rank gathers its tokens' rows, and the table's gradient comes back as
  each rank's partial sum;
* ``models/model.py`` ``cross_entropy``: the label gather
  (``take_along_dim``) on a vocab-sharded logit tensor; the vocab dim is
  made whole first;
* ``models/attention.py`` ``write_slot_``: the decode's indexed cache
  write into the sequence-sharded cache lands in the local block of the
  rank that holds the slot;
* ``optim/adamw.py`` ``apply_updates_``: the in-place update (its ``out=``
  forms and the flush of subnormals) runs on each rank's local blocks,
  with the gradient first redistributed onto its moment's placement; the
  global norm and ``runtime/fault.py`` ``all_finite`` combine the local
  blocks' results over the ranks;
* ``models/moe.py`` ``moe_layer_a2a``: the reference's shard_map body, on
  local tokens, with explicit all-to-alls over the ("data","model") ranks.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import api
from ..models.model import Model
from ..optim import adamw
from ..runtime import sharding as shr

_SEP = "/"


def _meta(shape, dtype, place: shr.Placed):
    """A meta DTensor of global ``shape`` placed at ``place``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"), place.mesh,
                             list(place.placements))


def _placed_tree(shapes: Any, places: Any) -> Any:
    flat = dict(api.flatten_with_keys(shapes, _SEP))
    where = dict(api.flatten_with_keys(places, _SEP))
    return api.unflatten_like(
        shapes, lambda k: _meta(tuple(flat[k].shape), flat[k].dtype, where[k]), _SEP)


def _dp_or_none(mesh, b: int):
    dp = shr.dp_axes(mesh)
    return dp if (dp and b % shr._axis_size(mesh, dp) == 0) else None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The abstract train or prefill batch of this (arch × shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    place = shr.placed(shr.P(_dp_or_none(mesh, b)), mesh)
    dt = getattr(torch, cfg.dtype)
    tok = lambda *sh: _meta(sh, torch.int32, place)  # noqa: E731
    emb = lambda *sh: _meta(sh, dt, place)  # noqa: E731
    batch: dict[str, Any] = {}
    if cfg.family == "encdec":
        batch["enc_embeds"] = emb(b, s, cfg.d_model)
        batch["tokens"] = tok(b, s)
        batch["labels"] = tok(b, s)
    elif cfg.family == "vlm":
        batch["embeds"] = emb(b, s, cfg.d_model)
        batch["positions_3d"] = tok(b, s, 3)
        batch["labels"] = tok(b, s)
    else:
        batch["tokens"] = tok(b, s)
        batch["labels"] = tok(b, s)
    if shape.kind == "prefill":
        batch.pop("labels", None)
    return batch


def param_specs(model: Model, mesh) -> Any:
    shapes = model.param_shapes()
    return _placed_tree(shapes, shr.param_shardings(shapes, model.cfg, mesh))


def opt_state_specs(param_sds: Any, mesh, opt_cfg: adamw.AdamWConfig,
                    cfg: ModelConfig | None = None) -> dict:
    """AdamW's state: each moment placed as its parameter, or under ZeRO-1
    (``dp_zero1``) sharded over "model" by the ``fsdp_dp`` rule although
    the parameters are replicated; ``step`` replicated."""
    zero1 = cfg is not None and cfg.sharding_policy == "dp_zero1"
    dt = getattr(torch, opt_cfg.moment_dtype)
    flat = dict(api.flatten_with_keys(param_sds, _SEP))

    def moment(key: str):
        p = flat[key]
        if zero1:
            place = shr.placed(shr.opt_state_spec(key.split(_SEP), p, cfg, mesh), mesh)
        else:  # mirror the parameter's placement
            place = shr.Placed(p.device_mesh, tuple(p.placements), shr.P())
        return _meta(tuple(p.shape), dt, place)

    return {"m": api.unflatten_like(param_sds, moment, _SEP),
            "v": api.unflatten_like(param_sds, moment, _SEP),
            "step": _meta((), torch.int32, shr.replicated(mesh))}


def cache_specs(model: Model, shape: ShapeConfig, mesh) -> Any:
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    cache = model.init_cache(b, s, torch.bfloat16, device="meta")
    if cfg.family == "encdec":
        # cross K/V filled at prefill: (L, B, S_enc, KH, hd)
        n_dec = cfg.n_dec_layers or cfg.n_layers
        cross = (n_dec, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = dict(cache)
        cache["cross_k"] = torch.empty(cross, dtype=torch.bfloat16, device="meta")
        cache["cross_v"] = torch.empty(cross, dtype=torch.bfloat16, device="meta")
    return _placed_tree(cache, shr.cache_shardings(cache, cfg, mesh))


def token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b = shape.global_batch
    return _meta((b,), torch.int32, shr.placed(shr.P(_dp_or_none(mesh, b)), mesh))


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, then AdamW (in place: the
    returned trees are the arguments, updated).  Under ``dp_zero1`` each
    gradient is placed on its moment's shards first (the reference's
    constraint, which makes the sum a reduce-scatter)."""
    cfg = model.cfg

    def train_step(params, opt_state, batch):
        with shr.placed_ops():
            (_loss, metrics), grads = model.value_and_grad(params, batch)
            if cfg.sharding_policy == "dp_zero1":
                grads = _constrain_tree_model_shard(grads, cfg)
            metrics.update(adamw.apply_updates_(params, grads, opt_state, lr, opt_cfg))
        return params, opt_state, {k: shr.whole(v) for k, v in metrics.items()}

    return train_step


def _constrain_tree_model_shard(tree: Any, cfg: ModelConfig) -> Any:
    """Each placed leaf redistributed onto the ``fsdp_dp`` rule's placement
    (under an ambient mesh; else the tree as it is)."""
    mesh = shr.AMBIENT_MESH.get()
    if mesh is None:
        return tree
    flat = dict(api.flatten_with_keys(tree, _SEP))

    def con(key: str):
        leaf = flat[key]
        if not shr.is_placed(leaf):
            return leaf
        spec = shr._param_spec_fsdp_dp(key.split(_SEP) or ["_"], leaf, cfg, mesh)
        want = shr.to_placements(spec, leaf.device_mesh)
        if tuple(leaf.placements) == want:
            return leaf
        return leaf.redistribute(leaf.device_mesh, list(want))

    return api.unflatten_like(tree, con, _SEP)


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> logits (B, vocab)`` at the last
    position: encdec encodes and runs the decoder's training forward;
    the rest run the backbone, the final norm and the head."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        with shr.placed_ops():
            if cfg.family == "encdec":
                from ..models import encdec as ed

                memory = ed.encode(params, batch["enc_embeds"].to(getattr(torch, cfg.dtype)), cfg)
                return ed.decode_train(params, batch["tokens"], memory, cfg)[:, -1]
            from ..models.layers import rms_norm

            x = model._embed_in(params, batch)
            h, _ = model._backbone(params, x, batch)
            h = rms_norm(h, params["ln_f"]["scale"], cfg.norm_eps)
            return model._head(params, h[:, -1:, :])[:, 0]

    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(params, token, cache, cache_len) -> (logits, cache)``,
    the cache written in place."""

    def decode_step(params, token, cache, cache_len):
        with shr.placed_ops():
            return model.decode_step(params, token, cache, cache_len)

    return decode_step
