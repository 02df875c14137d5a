"""The reference's side of the mesh tests, on four XLA:CPU devices: run as
``python _jax_mesh_worker.py <what> <dir>`` (its own process: the device
count is fixed when JAX starts).

* ``a2a``: deepseek-v3's smoke-cut MoE layer 0 and an input, and the
  reference's ``moe_layer_a2a`` on the (2, 2) ``("data","model")`` mesh
  (and whether it declines 3 tokens) → ``<dir>/a2a_in.npz``,
  ``<dir>/a2a_ref.npz``;
* ``blocks``: for each ``(shape, spec)`` of ``<dir>/blocks_in.json``, the
  index that ``NamedSharding(mesh, spec).addressable_devices_indices_map``
  gives the device at each mesh position → ``<dir>/blocks_ref.json``.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import replace  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.mesh import make_mesh, use_mesh  # noqa: E402
from repro.models import build_model, moe  # noqa: E402


def a2a(out: Path) -> None:
    cfg = replace(get_config("deepseek-v3-671b").smoke(), moe_impl="a2a")
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), params["moe_layers"]["moe"])
    x = np.random.default_rng(7).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    mesh = make_mesh((2, 2), ("data", "model"))
    with use_mesh(mesh):
        y, aux = moe.moe_layer_a2a(jax.numpy.asarray(x), lp, cfg)
        none_tokens = moe.moe_layer_a2a(jax.numpy.asarray(x[:, :3]), lp, cfg) is None
    np.savez(out / "a2a_in.npz", x=x, router=lp["router"], wg=lp["wg"], wu=lp["wu"],
             wd=lp["wd"], **{"shared_" + k: v for k, v in lp["shared"].items()})
    np.savez(out / "a2a_ref.npz", y=np.asarray(y), aux=np.asarray(aux),
             none_tokens=np.array(none_tokens))


def blocks(out: Path) -> None:
    cases = json.loads((out / "blocks_in.json").read_text())
    mesh = make_mesh((2, 2), ("data", "model"))
    found = []
    for shape, spec in cases:
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        idx = NamedSharding(mesh, spec).addressable_devices_indices_map(tuple(shape))
        found.append([[[[s.start or 0, (s.stop if s.stop is not None else n) - (s.start or 0)]
                        for s, n in zip(idx[mesh.devices[i, j]], shape)]
                       for j in range(2)] for i in range(2)])
    (out / "blocks_ref.json").write_text(json.dumps(found))


if __name__ == "__main__":
    {"a2a": a2a, "blocks": blocks}[sys.argv[1]](Path(sys.argv[2]))
