"""Multi-controller host topology (counterpart of the topology half of
``repro.launch.mesh``).

The multi-host I/O layer (per-host aggregated shard files, global manifest,
topology-aware restore) and the engine's ``owned_only`` route are
parameterised by two integers: which controller process this is, out of
how many.  Leaf ownership derives from them by ``crc32(key) % n_hosts``, the
reference's rule, so both packages assign every leaf to the same host.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

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
