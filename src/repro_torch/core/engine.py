"""Execution engine — owns *where* and *how* a ReductionPlan runs
(counterpart of ``repro.core.engine``, for the devices of one process).

  1. **Plan-bound backends** (§III-C): every spec carries a ``backend``
     (``auto`` | ``torch`` | ``cuda``); plan build resolves it and binds the
     kernels once, never per call.
  2. **Fan-out + async submission** (§V / Fig. 16): independent reductions
     (pytree leaves) are scheduled over the engine's devices on the
     executor's threads, each CUDA task on a stream of its own.  Same-spec
     leaves are bucketed so each bucket builds *one* plan (a CMM miss) and
     every other leaf is a real CMM hit.  A bucket of two or more leaves of
     a stage-graph codec runs the plan's batched pipeline
     (:meth:`~repro_torch.core.stages.base.CompiledPipeline.run_batched`)
     as one task on one device, buckets going round-robin over the
     devices: the reference's ``shard_map`` over the ``data`` mesh axis
     becomes the leaves stacked along a new axis on one GPU (ZFP: one
     kernel launch for the bucket).  Singleton buckets and codecs without a
     stage graph (``mgard-progressive``) run as per-leaf futures.
     ``submit()/result()`` are the future surface the checkpoint writer and
     the serving layer run on.

Most callers use the process-wide :func:`default_engine` (every visible
CUDA device) through ``api.compress_pytree``; the CPU path builds its own,
and an engine built on a DeviceMesh takes its device ring from the mesh's
``data`` axis (:func:`data_devices`, :func:`make_data_mesh`)::

    eng = ExecutionEngine(devices=[torch.device("cpu")], backend="torch")
    eng = ExecutionEngine(make_data_mesh())   # a ("data",) mesh over the card
    flat, stats = eng.compress_pytree(params)
    sub = eng.submit_encode(spec, x)      # async single reduction
    c = sub.result()
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import adapters
from .codecs import get_codec
from .codecs.base import ReductionSpec
from .container import Compressed
from .stages.base import CallEnv, LeafView, TransferStats
from ..runtime.executor import MESH, DeviceExecutor, Submission


def _rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank`` of a mesh (one device a rank)."""
    if device_type == "cuda":
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return torch.device(device_type)


def data_devices(mesh) -> list[torch.device]:
    """Devices holding distinct ``data``-axis shards (the fan-out ring).

    For a multi-axis DeviceMesh this walks the ``data`` axis with every
    other axis pinned at index 0: one device a data shard.  A mesh without
    a ``data`` axis gives every rank's device; no mesh, every visible card
    (the CPU without one).
    """
    if mesh is None:
        n = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]
    ranks = mesh.mesh
    names = list(mesh.mesh_dim_names or ())
    if "data" in names:
        ranks = ranks.movedim(names.index("data"), 0)
        ranks = ranks.reshape(ranks.shape[0], -1)[:, 0]
    return [_rank_device(mesh.device_type, int(r)) for r in ranks.reshape(-1)]


def make_data_mesh(devices=None):
    """One-axis ``("data",)`` DeviceMesh (``launch.mesh.make_data_mesh``,
    which starts a world-size-1 process group where none exists), on the
    type of ``devices`` where given (default: the card)."""
    from ..launch import mesh as launch_mesh  # runtime import: layering

    if devices is None:
        return launch_mesh.make_data_mesh()
    devices = [torch.device(d) for d in devices]
    return launch_mesh.make_data_mesh(len(devices), device=devices[0].type)


def _nbytes(arr: Any) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(arr.nbytes)


class ExecutionEngine:
    """Plan-bound, device-fanned, async reduction executor.

    The parameters are the reference's, in its order; ``devices=``
    (keyword only) gives the device ring without a mesh.  The first
    positional argument is a DeviceMesh: a list of devices there raises
    ``TypeError`` rather than being read as a mesh.
    """

    def __init__(
        self,
        mesh=None,
        backend: str = adapters.AUTO,
        max_workers: int | None = None,
        io_workers: int = 1,
        topology=None,
        *,
        devices: Sequence[Any] | None = None,
    ):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh  # lazy: distributed

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    f"ExecutionEngine's first argument is a DeviceMesh, got "
                    f"{type(mesh).__name__}; pass a device list as devices=")
        self.backend = adapters.resolve_backend(backend)
        want = "cuda" if self.backend == adapters.CUDA else "cpu"
        #: the DeviceMesh whose ``data`` axis gave the device ring, if any (an
        #: engine built without one starts no process group)
        self.mesh = mesh
        if mesh is not None:
            devices = data_devices(mesh)
        if devices:
            self.devices = [torch.device(d) for d in devices]
        elif want == "cuda":  # default: every visible card
            self.devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            self.devices = [torch.device("cpu")]
        if any(d.type != want for d in self.devices):
            raise ValueError(
                f"backend {self.backend!r} runs on {want} devices, got {self.devices}")
        if topology is None:
            from ..launch import mesh as launch_mesh  # runtime import: layering

            topology = launch_mesh.detect_topology()
        #: which controller process this engine runs in: ``encode_leaf_jobs``
        #: can drop leaves owned by other hosts before any plan work
        self.topology = topology
        self.executor = DeviceExecutor(self.devices, max_workers=max_workers,
                                       io_workers=io_workers)
        self._lock = threading.Lock()
        self.shard_map_calls = 0
        self.sharded_leaves = 0
        self.sharded_decoded_leaves = 0
        self.transfer_h2d = 0
        self.transfer_d2h = 0
        # the reference's workspace-donation counters: PyTorch has no
        # donation, so they stay 0 (as the reference's do where XLA has none)
        self.ws_stack_builds = 0
        self.ws_donated_calls = 0

    # ----------------------------------------------------------- single spec

    def make_spec(self, data: Any, method: str, **params: Any) -> ReductionSpec:
        """Spec for ``data`` with this engine's backend bound (unless given)."""
        from . import api  # runtime import: api ↔ engine are peer layers

        params.setdefault("backend", self.backend)
        return api.make_spec(data, method, **params)

    def submit_encode(self, spec: ReductionSpec, data: Any, device: Any = None) -> Submission:
        """Asynchronously compress ``data`` under ``spec``; returns a future."""
        from . import api

        return self.executor.submit(lambda: api.encode(spec, data), device=device)

    def submit_decode(self, c: Compressed, device: Any = None) -> Submission:
        from . import api

        return self.executor.submit(lambda: api.decode(c, self.backend), device=device)

    def stream(self, method: str = "zfp", **kwargs: Any):
        """A :class:`~repro_torch.core.api.CompressorStream` bound to this engine.

        The stream's chunks go round-robin over the engine's devices on the
        engine's executor lanes, with the engine's backend.  Defaults to the
        auto-tuned schedule (``chunk_size="auto", window="auto"``); pass
        explicit values to override.  Build streams from caller threads, not
        from inside engine lane tasks: the stream's staging loop must not
        occupy the lane its own chunks need.
        """
        from . import api  # runtime import: api ↔ engine are peer layers

        kwargs.setdefault("chunk_size", "auto")
        kwargs.setdefault("window", "auto")
        return api.CompressorStream(method, engine=self, **kwargs)

    def submit(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Submission:
        """Raw task submission (``lane="io"`` for orchestration work)."""
        return self.executor.submit(fn, *args, **kwargs)

    @staticmethod
    def result(sub: Submission, timeout: float | None = None) -> Any:
        return sub.result(timeout)

    def encode(self, spec: ReductionSpec, data: Any) -> Compressed:
        return self.submit_encode(spec, data).result()

    def decode(self, c: Compressed) -> torch.Tensor:
        return self.submit_decode(c).result()

    # ------------------------------------------------- bucket job surface
    #
    # The pytree entry points below and the serving layer share these
    # helpers: leaf-job construction (policy + spec + per-leaf CMM
    # resolution), bucketing by post-policy spec, and one submission per
    # stackable bucket.  Batched and per-leaf execution agree byte for byte.

    def encode_leaf_jobs(
        self,
        tree: Any,
        select: Callable[[str, Any], tuple[str, dict] | None] | None = None,
        *,
        sep: str = "/",
        owned_only: bool = False,
    ) -> tuple[list[str], dict[str, Any], list[tuple], dict]:
        """Flatten ``tree`` into encode jobs: ``(order, raw, jobs, stats)``.

        Each job is ``(key, arr, x, spec)`` — original leaf, post-policy
        tensor, and the engine-bound spec.  Plan resolution happens here,
        per leaf: the first leaf of a bucket builds the plan (CMM miss),
        every further leaf is a CMM hit.  ``owned_only=True`` drops leaves
        owned by other hosts under ``self.topology`` before any plan or
        compression work (``stats["remote_leaves"]`` counts them).
        """
        from . import api

        select = select or api.default_select
        stats = {
            "raw": 0, "compressed": 0, "leaves": 0, "compressed_leaves": 0,
            "buckets": 0, "sharded_leaves": 0, "devices": len(self.devices),
            "remote_leaves": 0,
        }
        order: list[str] = []
        raw_leaves: dict[str, Any] = {}
        jobs: list[tuple[str, Any, torch.Tensor, ReductionSpec]] = []
        for key, leaf in api.flatten_with_keys(tree, sep):
            if owned_only and not self.topology.owns(key):
                stats["remote_leaves"] += 1
                continue
            arr = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            order.append(key)
            stats["raw"] += _nbytes(arr)
            stats["leaves"] += 1
            choice = select(key, arr)
            if choice is None:
                raw_leaves[key] = arr
                stats["compressed"] += _nbytes(arr)
                continue
            method, params = choice
            x, pol_method, pol_params = api.leaf_policy(arr, method, params)
            # a per-leaf backend in the policy overrides the engine default
            backend = pol_params.pop("backend", None) or self.backend
            spec = api.make_spec(x, pol_method, backend=backend, **pol_params)
            api.get_plan(spec)
            jobs.append((key, arr, x, spec))
        return order, raw_leaves, jobs, stats

    @staticmethod
    def bucket_encode_jobs(jobs: list[tuple]) -> dict[ReductionSpec, list]:
        """Group encode jobs by their post-policy spec (insertion-ordered)."""
        buckets: dict[ReductionSpec, list] = {}
        for job in jobs:
            buckets.setdefault(job[3], []).append(job)
        return buckets

    def encode_bucket_stackable(self, spec: ReductionSpec, items: list) -> bool:
        """Whether a bucket runs the batched pipeline as one task."""
        from . import api

        codec = get_codec(spec.method)
        return (codec.supports_batched_encode and len(items) > 1
                and api.get_plan(spec).pipeline is not None)

    def submit_encode_bucket(
        self, spec: ReductionSpec, items: list, *, priority: str | None = None
    ) -> Submission:
        """One submission for a stackable bucket, placed on the next device.

        Resolves to the per-item containers (leaf meta finished), aligned
        with ``items``.
        """
        from . import api

        codec = get_codec(spec.method)

        def run() -> list:
            out = self._encode_bucket(codec, spec, items)
            for (_key, arr, _x, _s), c in zip(items, out):
                api.finish_leaf_meta(c, arr)
            with self._lock:
                self.sharded_leaves += len(items)
            return out

        return self.executor.submit(run, device=MESH, priority=priority)

    def submit_encode_job(self, job: tuple, *, priority: str | None = None) -> Submission:
        """Per-leaf submission; resolves to one finished container."""
        _key, arr, x, spec = job
        return self.executor.submit(self._encode_leaf, spec, x, arr, priority=priority)

    def decode_leaf_groups(self, comp: dict[str, Any]) -> dict[tuple, list[tuple[str, Compressed]]]:
        """Group a flat compressed mapping into decode buckets.

        Keys group by ``(decode spec, decode geometry)`` — the codec's
        :meth:`~repro_torch.core.codecs.base.Codec.decode_bucket_key` — with
        per-leaf plan resolution (CMM hit accounting) mirroring the encode
        direction.  Raw (non-``Compressed``) entries are skipped.
        """
        from . import api

        buckets: dict[tuple, list] = {}
        for key, val in comp.items():
            if not isinstance(val, Compressed):
                continue
            codec = get_codec(val.method)
            spec = dataclasses.replace(codec.decode_spec(val), backend=self.backend)
            api.get_plan(spec)
            buckets.setdefault((spec, codec.decode_bucket_key(val)), []).append((key, val))
        return buckets

    def decode_bucket_prepared(self, spec: ReductionSpec, items: list) -> list | None:
        """Per-item inverse-pipeline states, or ``None`` → per-leaf path."""
        from . import api

        codec = get_codec(spec.method)
        plan = api.get_plan(spec)
        if not (codec.supports_batched_decode and len(items) > 1
                and plan.pipeline is not None):
            return None
        return [codec.decode_state(plan, c) for _k, c in items]

    def submit_decode_bucket(
        self, spec: ReductionSpec, items: list, prepared: list,
        *, priority: str | None = None,
    ) -> Submission:
        """One submission for a stacked decode bucket; resolves to the
        restored per-item leaves (original dtype/shape), aligned with
        ``items``."""
        codec = get_codec(spec.method)

        def run() -> list:
            out = self._decode_bucket(codec, spec, items, prepared)
            with self._lock:
                self.sharded_decoded_leaves += len(items)
            return out

        return self.executor.submit(run, device=MESH, priority=priority)

    def submit_decode_job(
        self, spec: ReductionSpec, c: Compressed, *, priority: str | None = None
    ) -> Submission:
        """Per-leaf decode submission; resolves to the restored leaf."""
        return self.executor.submit(self._decode_leaf, spec, c, priority=priority)

    # -------------------------------------------------------- pytree fan-out

    def compress_pytree(
        self,
        tree: Any,
        select: Callable[[str, Any], tuple[str, dict] | None] | None = None,
        *,
        sep: str = "/",
        owned_only: bool = False,
    ) -> tuple[dict[str, Any], dict]:
        """Fanned-out :func:`repro_torch.core.api.compress_pytree`.

        Leaves are bucketed by post-policy spec (shape, dtype, method,
        params, backend); each bucket builds one plan, further leaves are
        CMM hits, and buckets run over the engine's devices: batched where
        the codec has a stage graph and the bucket holds two or more
        leaves, as per-leaf futures otherwise.  ``owned_only=True`` keeps
        this host's leaves under ``self.topology``.
        """
        order, raw_leaves, jobs, stats = self.encode_leaf_jobs(
            tree, select, sep=sep, owned_only=owned_only)
        buckets = self.bucket_encode_jobs(jobs)
        stats["buckets"] = len(buckets)

        results: dict[str, Compressed] = {}
        pending: list[tuple[str, Submission]] = []
        stacked: list[tuple[list, Submission]] = []
        for spec, items in buckets.items():
            if self.encode_bucket_stackable(spec, items):
                stacked.append((items, self.submit_encode_bucket(spec, items)))
            else:
                for job in items:
                    pending.append((job[0], self.submit_encode_job(job)))
        for items, sub in stacked:
            for (key, _arr, _x, _s), c in zip(items, sub.result()):
                results[key] = c
            stats["sharded_leaves"] += len(items)
        for key, sub in pending:
            results[key] = sub.result()

        flat: dict[str, Any] = {}
        for key in order:
            if key in raw_leaves:
                flat[key] = raw_leaves[key]
                continue
            c = results[key]
            flat[key] = c
            stats["compressed"] += c.nbytes()
            stats["compressed_leaves"] += 1
        stats["ratio"] = stats["raw"] / max(stats["compressed"], 1)
        return flat, stats

    def decompress_pytree(self, comp: dict[str, Any], like: Any, *, sep: str = "/") -> Any:
        """Fanned-out inverse of :meth:`compress_pytree`: ``like``'s
        structure with tensor leaves.

        Leaves are bucketed by decode spec and geometry (one plan
        resolution per leaf, so repeat leaves are CMM hits); a bucket of
        two or more leaves of a codec with a stage graph runs
        ``invert_batched`` as one task, every other leaf a per-leaf future.
        """
        from . import api

        results: dict[str, Any] = {}
        pending: list[tuple[str, Submission]] = []
        stacked: list[tuple[list, Submission]] = []
        for (spec, _geo), items in self.decode_leaf_groups(comp).items():
            prepared = self.decode_bucket_prepared(spec, items)
            if prepared is not None:
                stacked.append((items, self.submit_decode_bucket(spec, items, prepared)))
            else:
                for key, c in items:
                    pending.append((key, self.submit_decode_job(spec, c)))
        for items, sub in stacked:
            for (key, _c), out in zip(items, sub.result()):
                results[key] = out
        for key, sub in pending:
            results[key] = sub.result()

        flat = {key: results[key] if isinstance(val, Compressed) else val
                for key, val in comp.items()}
        return api.unflatten_like(like, lambda key: api.as_tensor(flat[key]), sep)

    # ------------------------------------------------------------- internals

    def _count(self, transfers: TransferStats, segments: int = 0) -> None:
        with self._lock:
            self.shard_map_calls += segments
            self.transfer_h2d += transfers.h2d
            self.transfer_d2h += transfers.d2h

    def _encode_leaf(self, spec: ReductionSpec, x: Any, arr: Any) -> Compressed:
        from . import api

        plan = api.get_plan(spec)
        env = CallEnv(plan)
        c = get_codec(spec.method).encode(plan, api.as_tensor(x), env=env)
        api.finish_leaf_meta(c, arr)
        self._count(env.transfers)
        return c

    def _decode_leaf(self, spec: ReductionSpec, c: Compressed) -> torch.Tensor:
        """Per-leaf decode under the engine-bound spec (the plan the bucket
        loop already resolved)."""
        from . import api

        plan = api.get_plan(spec)
        env = CallEnv(plan)
        out = get_codec(spec.method).decode(plan, c, env=env)
        self._count(env.transfers)
        return api.restore_leaf(out, c)

    def _encode_bucket(self, codec, spec: ReductionSpec, items: list) -> list[Compressed]:
        """Drive same-spec leaves through the plan's batched pipeline, then
        serialise each leaf's state (exact-sized fetches, as per leaf)."""
        from . import api

        plan = api.get_plan(spec)
        transfers = TransferStats()
        envs = [CallEnv(plan, transfers) for _ in items]
        states0 = [codec.encode_input(plan, api.as_tensor(x)) for (_k, _a, x, _s) in items]
        rows = plan.pipeline.run_batched(states0, envs)
        out = [codec.finish_container(plan, env, LeafView(row, env))
               for env, row in zip(envs, rows)]
        self._count(transfers, plan.pipeline.n_segments)
        return out

    def _decode_bucket(self, codec, spec: ReductionSpec, items: list, prepared: list) -> list:
        """Drive same-spec containers through the plan's batched inverse,
        then restore each leaf's dtype and shape."""
        from . import api

        plan = api.get_plan(spec)
        transfers = TransferStats()
        envs = []
        for _state0, meta in prepared:
            env = CallEnv(plan, transfers)
            env.meta.update(meta)
            envs.append(env)
        rows = plan.pipeline.invert_batched([p[0] for p in prepared], envs)
        out = [api.restore_leaf(codec.finish_decode(plan, env, row, c), c)
               for env, row, (_key, c) in zip(envs, rows, items)]
        self._count(transfers, plan.pipeline.n_inv_segments)
        return out

    # -------------------------------------------------------------- lifecycle

    def stats(self) -> dict[str, Any]:
        """The reference's keys with the same meaning; ``shard_map_calls``
        counts the segments the batched runs drove (the reference's fused
        device segments: maximal runs of device stages), ``devices`` the
        engine's devices."""
        s = self.executor.stats()
        with self._lock:
            s.update(
                backend=self.backend,
                shard_map_calls=self.shard_map_calls,
                sharded_leaves=self.sharded_leaves,
                sharded_decoded_leaves=self.sharded_decoded_leaves,
                transfer_h2d=self.transfer_h2d,
                transfer_d2h=self.transfer_d2h,
                ws_stack_builds=self.ws_stack_builds,
                ws_donated_calls=self.ws_donated_calls,
            )
        return s

    def close(self) -> None:
        self.executor.shutdown()

    def __enter__(self) -> "ExecutionEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# process-wide default engine (every visible CUDA device)
# ---------------------------------------------------------------------------

_DEFAULT_ENGINE: ExecutionEngine | None = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> ExecutionEngine:
    """Lazily-built shared engine; what ``api.compress_pytree`` runs on."""
    global _DEFAULT_ENGINE
    with _DEFAULT_LOCK:
        if _DEFAULT_ENGINE is None:
            _DEFAULT_ENGINE = ExecutionEngine()
        return _DEFAULT_ENGINE


def set_default_engine(engine: ExecutionEngine | None) -> ExecutionEngine | None:
    """Swap the process default (tests, a CPU engine); returns the old one."""
    global _DEFAULT_ENGINE
    with _DEFAULT_LOCK:
        old, _DEFAULT_ENGINE = _DEFAULT_ENGINE, engine
        return old
