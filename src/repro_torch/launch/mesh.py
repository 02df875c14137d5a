"""Device meshes, the ambient mesh, the multi-controller host topology
and the shared-filesystem barrier (counterpart of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are the reference's axis names; it spans the ranks of
the default process group, one device a rank.  :func:`use_mesh` makes a
mesh ambient (a ``contextvars`` variable), where
``runtime.sharding.constrain_activation_dp`` and the MoE dispatches look
for it, as the reference's code looks for JAX's ambient mesh.

The multi-host I/O layer (per-host aggregated shard files, global manifest,
topology-aware restore) and the engine's ``owned_only`` route are
parameterised by two integers: which controller process this is, out of
how many.  Leaf ownership derives from them by ``crc32(key) % n_hosts``, the
reference's rule, so both packages assign every leaf to the same host.
"""

from __future__ import annotations

import contextlib
import os
import time
import zlib
from dataclasses import dataclass
from pathlib import Path

from ..runtime.sharding import AMBIENT_MESH


def _mesh_device_type(device) -> str:
    """The DeviceMesh device type: ``"cuda"`` (the default: the card) or
    ``"cpu"``."""
    if device is None:
        return "cuda"
    return str(device).split(":")[0]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """A DeviceMesh of ``shape`` over the default process group's ranks,
    its dims named ``axes``; on the card unless ``device="cpu"``.  The
    group must exist and hold ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(device), tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh while the block runs."""
    token = AMBIENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        AMBIENT_MESH.reset(token)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``("data","model")`` mesh, or (2, 16, 16)
    ``("pod","data","model")``: over 256 or 512 ranks (the dry run's fake
    process group gives them to one process)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def ensure_process_group(device=None) -> bool:
    """Start a process group of world size 1 when none exists (``gloo`` on
    the CPU, ``nccl`` on the card; an in-process ``HashStore``, so nothing
    is listened on).  Returns whether it started one, so that the caller
    can end it with ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "gloo" if _mesh_device_type(device) == "cpu" else "nccl"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def make_test_mesh(n_data: int = 2, n_model: int = 2, device=None):
    """A ``("data","model")`` mesh over the ranks that exist (tests,
    examples, the card's smoke run): ``n_data`` cut to the world size,
    ``n_model`` to what is left; the two must cover every rank.  In one
    process with no process group it first starts a world-size-1 group
    (:func:`ensure_process_group`), so the mesh is (1, 1) there."""
    import torch.distributed as dist

    ensure_process_group(device)
    n = dist.get_world_size()
    n_data = min(n_data, n)
    n_model = min(n_model, max(1, n // n_data))
    return make_mesh((n_data, n_model), ("data", "model"), device)


def make_data_mesh(n: int | None = None, device=None):
    """One-axis ``("data",)`` mesh over the ranks of the default process
    group (the execution engine's canonical mesh: independent reductions
    shard over this axis), starting a world-size-1 group where none exists
    (:func:`ensure_process_group`).  ``n`` is cut to the world size; a
    DeviceMesh spans every rank, so a smaller ``n`` raises."""
    import torch.distributed as dist

    ensure_process_group(device)
    world = dist.get_world_size()
    n = world if n is None else min(n, world)
    if n != world:
        raise ValueError(f"a data mesh spans every rank: n={n}, world size {world}")
    return make_mesh((n,), ("data",), device)


def data_axis_size(mesh) -> int:
    """Size of the ``data`` axis (1 when the mesh has none)."""
    from ..runtime.sharding import mesh_shape

    return int(mesh_shape(mesh).get("data", 1))


ENV_HOST_ID = "HPDR_HOST_ID"
ENV_HOST_COUNT = "HPDR_HOST_COUNT"


@dataclass(frozen=True)
class HostTopology:
    """Which controller process this is, out of how many.

    Everything else — leaf ownership, shard naming, restore locality —
    derives deterministically from the two integers, so every host computes
    the same assignment without communicating.
    """

    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        if not 0 <= self.host_id < max(1, self.n_hosts):
            raise ValueError(
                f"host_id {self.host_id} out of range for {self.n_hosts} hosts"
            )

    @property
    def multi_host(self) -> bool:
        return self.n_hosts > 1

    def owner(self, key: str) -> int:
        """Deterministic leaf→host assignment (stable across processes).

        crc32 is byte-stable everywhere (unlike ``hash`` under
        ``PYTHONHASHSEED``), so every host — and every later process with
        the same host count — derives the identical mapping.
        """
        return zlib.crc32(str(key).encode()) % max(1, self.n_hosts)

    def owns(self, key: str) -> bool:
        return self.owner(key) == self.host_id


def detect_topology() -> HostTopology:
    """This process's :class:`HostTopology`.

    Resolution order: the ``HPDR_HOST_ID`` / ``HPDR_HOST_COUNT`` environment
    override (the subprocess-simulated multi-controller setting), then the
    rank and world size of an initialised ``torch.distributed`` process
    group, then a single host.
    """
    env_n = os.environ.get(ENV_HOST_COUNT)
    if env_n is not None:
        return HostTopology(int(os.environ.get(ENV_HOST_ID, 0)), int(env_n))
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return HostTopology(dist.get_rank(), dist.get_world_size())
    return HostTopology(0, 1)


def fs_barrier(
    directory: str | Path,
    name: str,
    topology: HostTopology,
    *,
    timeout: float = 120.0,
    poll_s: float = 0.005,
    payload: str = "ok",
) -> None:
    """Shared-filesystem rendezvous: block until every host arrives.

    Each host writes ``<directory>/.barrier-<name>.<host>`` (atomically, via
    rename) and polls until all ``n_hosts`` marker files exist — the
    reference's marker names, so hosts of both packages meet at one
    barrier.  This is the coordinator rendezvous of the multi-controller
    checkpoint writer; it needs only a shared filesystem.  Markers are left
    behind (names are unique per step) so a late arrival still sees the
    full barrier.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    mine = directory / f".barrier-{name}.{topology.host_id}"
    tmp = mine.with_name(mine.name + f".tmp{os.getpid()}")
    tmp.write_text(payload)
    os.replace(tmp, mine)
    deadline = time.monotonic() + timeout
    while True:
        present = {
            suffix
            for p in directory.glob(f".barrier-{name}.*")
            if (suffix := p.name.rsplit(".", 1)[-1]).isdigit()
        }
        if len(present) >= topology.n_hosts:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"fs_barrier {name!r}: {len(present)}/{topology.n_hosts} "
                f"hosts after {timeout}s (present: {sorted(present)})"
            )
        time.sleep(poll_s)


def barrier_payloads(
    directory: str | Path, name: str, topology: HostTopology
) -> dict[int, str]:
    """Every host's barrier marker payload (after :func:`fs_barrier`): the
    checkpoint coordinator's side channel for each host's shard stats."""
    out: dict[int, str] = {}
    for h in range(topology.n_hosts):
        p = Path(directory) / f".barrier-{name}.{h}"
        if p.exists():
            out[h] = p.read_text()
    return out
