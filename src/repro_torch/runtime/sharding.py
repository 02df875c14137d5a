"""Sharding rules: parameter / batch / cache / optimizer-state specs and
their DTensor placements (counterpart of ``repro.runtime.sharding``).

Policy, the reference's:
  * TP on "model": attention heads, FFN width, experts (EP), vocab;
  * DP on ("pod","data"): batch;
  * FSDP (cfg.fsdp): the non-TP weight dim additionally sharded over "data";
  * decode caches shard batch over DP and the *sequence* dim over "model";
  * ``fsdp_dp``: no TP, weights sharded over "model" only, batch over the
    whole mesh; ``dp_zero1``: parameters replicated, moments sharded.

Every axis assignment is divisibility-guarded: a dim that does not divide
falls back to replication (recorded by :func:`sharding_report`).

A spec (:class:`P`) keeps the reference's ``PartitionSpec`` shape: per
tensor dim ``None``, an axis name, or a tuple of axis names, so the two
packages' rules compare spec for spec.  :func:`to_placements` turns a spec
into DTensor placements over a :class:`~torch.distributed.device_mesh.DeviceMesh`
whose ``mesh_dim_names`` are the axis names: a tensor dim named by a tuple
of axes is ``Shard(d)`` on each of those mesh dims, split major to minor
in the tuple's order, as JAX splits it.  DTensor splits a dim sharded over
several mesh dims in mesh-dim order, so the tuple must name its axes in
the mesh's order (every rule here does: prefixes of ("pod","data","model"));
another order raises.

Path names come from the port's dict and list keys, which flatten as the
reference's pytree paths do (``tail/0/...``).
"""

from __future__ import annotations

import contextvars
import math
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core import api

MODEL = "model"
_SEP = "/"

#: the mesh that :func:`constrain_activation_dp` and the MoE dispatches read
#: (set by ``launch.mesh.use_mesh``; the reference's ambient abstract mesh)
AMBIENT_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class P(tuple):
    """A partition spec: one entry per leading tensor dim (``None``, an axis
    name, or a tuple of axis names); missing trailing entries replicate."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True, eq=False)
class Placed:
    """Where a tensor lives: ``mesh``, the DTensor ``placements`` (one per
    mesh dim) and the spec they came from.  A leaf of the trees
    :func:`param_shardings` and its siblings return (the reference's
    ``NamedSharding``)."""

    mesh: Any
    placements: tuple
    spec: P

    def distribute(self, x: torch.Tensor, device=None):
        """``x`` (the full tensor, the same on every rank) placed here: each
        rank keeps its block, with no communication; with ``device``, the
        block alone is copied there.  The block may share ``x``'s memory."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if device is None:
            return distribute_tensor(x, self.mesh, list(self.placements), src_data_rank=None)
        shape, offset = local_block(x.shape, self.mesh, self.placements)
        block = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        return DTensor.from_local(block.contiguous().to(device), self.mesh,
                                  list(self.placements), shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())


def local_block(shape, mesh, placements) -> tuple[tuple, tuple]:
    """This rank's block of a tensor of global ``shape``: ``(its shape, its
    offset)``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(tuple(shape), mesh, list(placements))


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no devices and no process group:
    enough for the rules and :func:`sharding_report` (the reference's
    ``jax.sharding.AbstractMesh``)."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.mesh.shape))


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def dp_axes(mesh) -> tuple:
    """Data-parallel meta-axis: ("pod","data") on multi-pod, ("data",) else."""
    names = axis_names(mesh)
    return tuple(n for n in ("pod", "data") if n in names)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _fit(mesh, dim: int, axis):
    """axis if dim divides its size, else None (replicate)."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 else None


def _path_names(key: str) -> list[str]:
    return key.split(_SEP) if key else []


_STACK_KEYS = (
    "layers", "moe_layers", "dense_layers", "enc_layers", "dec_layers",
    "rec_a", "rec_b", "attn_stack", "super",
)

# trailing-dim rules by parameter name
_IN_WEIGHTS = {
    "wq", "wk", "wv", "wu", "wg", "w1", "in_proj", "in_x", "in_gate",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "wr", "wi",
}
_OUT_WEIGHTS = {"wo", "wd", "out_proj", "out", "w2"}


def flat_axes(mesh) -> tuple:
    """Every mesh axis flattened (pure-DP / ZeRO sharding target)."""
    return axis_names(mesh)


def best_dp_axes(mesh, dim: int) -> tuple | None:
    """Largest prefix of (pod, data, model) whose product divides ``dim``."""
    names = axis_names(mesh)
    axes = [n for n in ("pod", "data", "model") if n in names]
    best = None
    for k in range(1, len(axes) + 1):
        cand = tuple(axes[:k])
        if dim % _axis_size(mesh, cand) == 0:
            best = cand
    return best


def param_spec(names: list[str], leaf, cfg: ModelConfig, mesh) -> P:
    """The spec of the parameter at path ``names`` (its keys, root first)."""
    shape = tuple(leaf.shape)
    ndim = len(shape)

    if cfg.sharding_policy == "fsdp_dp":
        return _param_spec_fsdp_dp(names, leaf, cfg, mesh)
    if cfg.sharding_policy == "dp_zero1":
        # ZeRO-1: params replicated; only optimizer moments are sharded
        return P(*([None] * ndim))

    fsdp_axis = "data" if (cfg.fsdp and "data" in axis_names(mesh)) else None
    in_moe_experts = "moe" in names and names[-1] in {"wg", "wu", "wd"}

    n_lead = 1 if any(k in names for k in _STACK_KEYS) and ndim >= 1 else 0
    trailing = shape[n_lead:]
    name = names[-1]

    def pad(spec_tail: tuple) -> P:
        return P(*([None] * n_lead + list(spec_tail)))

    if name == "table":  # embedding (vocab, d)
        return pad((_fit(mesh, trailing[0], MODEL), _fit(mesh, trailing[1], fsdp_axis)))
    if name == "scale":  # norm scales: replicated
        return pad((None,) * len(trailing))
    if name in {"lam", "conv_b", "dt_bias", "A_log", "D", "b"} and len(trailing) == 1:
        return pad((_fit(mesh, trailing[0], MODEL),))
    if name == "conv_w":  # (k, dim)
        return pad((None, _fit(mesh, trailing[1], MODEL)))
    if name == "router":  # (d, E)
        return pad((None, _fit(mesh, trailing[1], MODEL)))
    if in_moe_experts and len(trailing) == 3:
        e, d1, d2 = trailing
        if cfg.moe_group_size > 0:
            # full-mesh expert parallelism, no inner-dim sharding
            return pad((best_dp_axes(mesh, e), None, None))
        espec = _fit(mesh, e, MODEL)
        if name in {"wg", "wu"}:  # (E, d_model, d_ff)
            return pad((espec, _fit(mesh, d1, fsdp_axis), None))
        return pad((espec, None, _fit(mesh, d2, fsdp_axis)))  # wd (E, f, d)
    if len(trailing) == 2:
        d_in, d_out = trailing
        if name in _IN_WEIGHTS or (name == "w" and _parent(names) in _IN_WEIGHTS):
            return pad((_fit(mesh, d_in, fsdp_axis), _fit(mesh, d_out, MODEL)))
        if name in _OUT_WEIGHTS or (name == "w" and _parent(names) in _OUT_WEIGHTS):
            return pad((_fit(mesh, d_in, MODEL), _fit(mesh, d_out, fsdp_axis)))
        if name == "w" and _parent(names) in {"head", "proj"}:
            return pad((_fit(mesh, d_in, fsdp_axis), _fit(mesh, d_out, MODEL)))
        # default 2-D: out dim on model
        return pad((_fit(mesh, d_in, fsdp_axis), _fit(mesh, d_out, MODEL)))
    if len(trailing) == 1:
        # biases: shard if the matching weight's out-dim is model-sharded
        return pad((_fit(mesh, trailing[0], MODEL),))
    return pad((None,) * len(trailing))


def _parent(names: list[str]) -> str:
    return names[-2] if len(names) >= 2 else ""


def _param_spec_fsdp_dp(names: list[str], leaf, cfg: ModelConfig, mesh) -> P:
    """fsdp_dp policy: no tensor parallelism; the weights' largest trailing
    dim that divides is sharded over "model" only, the batch spreads over
    the whole mesh."""
    del cfg
    shape = tuple(leaf.shape)
    n_lead = 1 if any(k in names for k in _STACK_KEYS) and len(shape) >= 1 else 0
    trailing = shape[n_lead:]
    if not trailing or names[-1] == "scale":
        return P(*([None] * len(shape)))
    sizes = list(trailing)
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    spec = [None] * len(sizes)
    for i in order:
        if sizes[i] % _axis_size(mesh, MODEL) == 0:
            spec[i] = MODEL
            break
    return P(*([None] * n_lead + spec))


def to_placements(spec: P, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` over ``mesh``:
    ``Shard(d)`` on every mesh dim that tensor dim ``d`` names,
    ``Replicate()`` on the rest and on a dim of one rank (where a split
    is the whole tensor, and DTensor's views of a dim sharded over one
    rank are stricter than of a whole one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    named: set[int] = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's order "
                             f"{names}; DTensor splits a dim over mesh dims in mesh order")
        for i in dims:
            if i in named:
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} named twice")
            named.add(i)
            if sizes[names[i]] > 1:  # an axis of one rank splits nothing
                out[i] = Shard(d)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return tuple(out)


def placed(spec: P, mesh, ndim: int | None = None) -> Placed:
    return Placed(mesh, to_placements(spec, mesh, ndim), spec)


def _map_with_names(tree: Any, fn) -> Any:
    """``fn(names, leaf)`` over every leaf of ``tree``, in its shape."""
    flat = dict(api.flatten_with_keys(tree, _SEP))
    return api.unflatten_like(tree, lambda k: fn(_path_names(k), flat[k]), _SEP)


def param_specs_tree(params_shape: Any, cfg: ModelConfig, mesh) -> Any:
    """:func:`param_spec` of every leaf of a parameter tree (meta tensors
    will do)."""
    return _map_with_names(params_shape, lambda n, x: param_spec(n, x, cfg, mesh))


def opt_state_spec(names: list[str], leaf, cfg: ModelConfig, mesh) -> P:
    """The spec of the AdamW moment of the parameter at ``names``: under
    ZeRO-1 (``dp_zero1``) the ``fsdp_dp`` rule's (the moments sharded over
    "model" though the parameters are replicated), else the parameter's."""
    if cfg.sharding_policy == "dp_zero1":
        return _param_spec_fsdp_dp(names or ["_"], leaf, cfg, mesh)
    return param_spec(names, leaf, cfg, mesh)


def param_shardings(params_shape: Any, cfg: ModelConfig, mesh) -> Any:
    """The parameter tree's :class:`Placed` leaves."""
    return _map_with_names(params_shape,
                           lambda n, x: placed(param_spec(n, x, cfg, mesh), mesh, x.ndim))


def batch_spec(leaf, cfg: ModelConfig, mesh) -> P:
    ndim = leaf.ndim
    b = leaf.shape[0] if ndim else 1
    if cfg.sharding_policy in ("fsdp_dp", "dp_zero1"):
        baxis = best_dp_axes(mesh, b)  # spread batch over the whole mesh
    else:
        dp = dp_axes(mesh)
        baxis = dp if (dp and b % _axis_size(mesh, dp) == 0) else None
    return P(baxis, *([None] * (ndim - 1)))


def batch_shardings(batch_shape: Any, cfg: ModelConfig, mesh) -> Any:
    return _map_with_names(batch_shape,
                           lambda n, x: placed(batch_spec(x, cfg, mesh), mesh, x.ndim))


def cache_spec(names: list[str], leaf, cfg: ModelConfig, mesh) -> P:
    """Decode caches: (L, B, S, ...) → batch on DP, sequence on model."""
    dp = dp_axes(mesh)
    shape = tuple(leaf.shape)
    nd = len(shape)
    parts: list = [None] * nd
    if nd >= 2:
        if dp and shape[1] % _axis_size(mesh, dp) == 0:
            parts[1] = dp
    name = names[-1]
    m = _axis_size(mesh, MODEL)
    if name in {"k", "v", "cross_k", "cross_v"} and nd == 5 and cfg.kv_replicate > 1:
        # replicated KV heads fill the model axis: heads sharded
        if shape[3] % m == 0:
            parts[3] = MODEL
    elif name in {"k", "v", "c_kv", "k_rope", "cross_k", "cross_v"} and nd >= 3:
        if shape[2] % m == 0:
            parts[2] = MODEL  # sequence dim (flash-decoding split)
    elif name == "state" and nd >= 3:  # ssm (L,B,H,P,N)
        if shape[2] % m == 0:
            parts[2] = MODEL
    elif name == "h" and nd == 3:  # rglru (L,B,W)
        if shape[2] % m == 0:
            parts[2] = MODEL
    elif name == "conv" and nd >= 4:  # (L,B,cw-1,dim)
        if shape[3] % m == 0:
            parts[3] = MODEL
    return P(*parts)


def cache_shardings(cache_shape: Any, cfg: ModelConfig, mesh) -> Any:
    return _map_with_names(cache_shape,
                           lambda n, x: placed(cache_spec(n, x, cfg, mesh), mesh, x.ndim))


def replicated(mesh) -> Placed:
    return placed(P(), mesh)


def constrain_activation_dp(x, batch_dim: int = 0):
    """Place an activation's batch dim on the DP axes of the ambient mesh.

    Under no ambient mesh, or on a plain tensor, ``x`` comes back as it is
    (the reference's constraint is a no-op there).  On a DTensor the batch
    dim is redistributed onto the largest prefix of ("pod","data","model")
    whose size divides it; other dims replicate.  A prefix of size 1 leaves
    ``x`` as it is, as the reference's.
    """
    from torch.distributed.tensor import DTensor

    mesh = AMBIENT_MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    names = axis_names(mesh)
    shape = mesh_shape(mesh)
    avail = [n for n in ("pod", "data", "model") if n in names]
    b = x.shape[batch_dim]
    best, size = None, 1
    for k in range(1, len(avail) + 1):
        prod = math.prod(shape[a] for a in avail[:k])
        if b % prod == 0:
            best, size = tuple(avail[:k]), prod
    if best is None or size == 1:
        return x
    spec = [None] * x.ndim
    spec[batch_dim] = best if len(best) > 1 else best[0]
    want = to_placements(P(*spec), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, list(want))


def sharding_report(params_shape: Any, cfg: ModelConfig, mesh) -> dict:
    """Bytes per device and replication diagnostics."""
    total, per_dev, replicated_bytes = 0, 0, 0
    for key, leaf in api.flatten_with_keys(params_shape, _SEP):
        spec = param_spec(_path_names(key), leaf, cfg, mesh)
        shape = tuple(leaf.shape)
        nbytes = math.prod(shape) * leaf.element_size()
        full = list(spec) + [None] * (len(shape) - len(spec))
        shards = 1
        for axis in full:
            if axis is not None:
                shards *= _axis_size(mesh, axis)
        total += nbytes
        per_dev += nbytes // shards
        if shards == 1:
            replicated_bytes += nbytes
    return {
        "total_bytes": total,
        "bytes_per_device": per_dev,
        "replicated_bytes": replicated_bytes,
        "devices": mesh_size(mesh),
    }


def replicate_dims(x, *dims: int):
    """``x`` with tensor dims ``dims`` unsharded (a DTensor's ``Shard`` on
    them redistributed to ``Replicate``; other placements kept).  Where an
    op has no DTensor strategy for a sharded dim (a gather along it), its
    input is made whole there first.  A plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor."""
    return type(x) is not torch.Tensor and hasattr(x, "device_mesh") and hasattr(x, "placements")


def whole(x):
    """A placed ``x`` gathered to the full tensor (the same on every rank);
    a plain tensor as it is."""
    return x.full_tensor() if is_placed(x) else x


def placed_ops():
    """Context in which plain tensors that meet DTensors (masks, positions,
    rotary tables made inside the model) count as replicated on every
    rank (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _view_groups(src: tuple, dst: tuple) -> list[tuple[list[int], list[int]]]:
    """The dims of ``src`` and ``dst`` (same element count) in matching
    groups of equal product, in order: ``[(src dims, dst dims), ...]``."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs, a, b = [], [], 1, 1
        if i < len(src):
            a, i = src[i], i + 1
            ins.append(i - 1)
        if j < len(dst):
            b, j = dst[j], j + 1
            outs.append(j - 1)
        while a != b and (i < len(src) or j < len(dst)):
            if (a < b and i < len(src)) or j == len(dst):
                a, i = a * src[i], i + 1
                ins.append(i - 1)
            else:
                b, j = b * dst[j], j + 1
                outs.append(j - 1)
        groups.append((ins, outs))
    return groups


def _placed_reshape(x, shape: list[int]):
    """A placed ``x`` reshaped, each sharded dim that DTensor cannot carry
    through the view made whole first."""
    from torch.distributed.tensor import Shard

    sizes = mesh_shape(x.device_mesh)
    ranks: dict[int, int] = {}
    for name, pl in zip(axis_names(x.device_mesh), x.placements):
        if isinstance(pl, Shard):
            ranks[pl.dim] = ranks.get(pl.dim, 1) * sizes[name]
    whole = []
    for ins, outs in _view_groups(tuple(x.shape), tuple(shape)):
        for pos, d in enumerate(ins):
            k = ranks.get(d, 1)
            if k > 1 and (pos > 0 or not outs or shape[outs[0]] % k or x.shape[d] % k):
                whole.append(d)
    if whole:
        x = replicate_dims(x, *whole)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """:func:`_placed_reshape` forward, and backward for the gradient (whose
    placement may differ from the input's)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = list(x.shape)
        return _placed_reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _placed_reshape(grad, ctx.in_shape), None


def reshape(x, *shape: int):
    """``x.reshape(*shape)``.  A placed ``x`` (and its gradient) first has
    made whole each sharded dim that DTensor cannot carry through the view:
    a dim split unevenly over its ranks, a dim split into dims whose first
    does not divide over them, or a dim merged behind another (DTensor has
    no strategy for such a view)."""
    if not is_placed(x):
        return x.reshape(*shape)
    shape = list(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = x.numel() // known if known else 0
    return _Reshape.apply(x, shape)


def take_last(x, index):
    """``x[..., index]`` along the last dim (``take_along_dim`` of
    ``index[..., None]``).  On a placed ``x`` DTensor has no exact strategy
    for this gather; the last dim is made whole, ``index`` takes ``x``'s
    placement on the other dims, and each rank gathers its block."""
    if not is_placed(x):
        return torch.take_along_dim(x, index[..., None].long(), dim=-1)[..., 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    want = [pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1 else Replicate()
            for pl in x.placements]
    x = x.redistribute(mesh, want)
    if not is_placed(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim)
    index = index.redistribute(mesh, want)
    local = torch.take_along_dim(x.to_local(), index.to_local()[..., None].long(), dim=-1)
    return DTensor.from_local(local[..., 0], mesh, want)
