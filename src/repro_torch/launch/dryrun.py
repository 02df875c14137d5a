"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``).

Runs every (architecture × input shape × mesh) cell's step — a train,
prefill or decode step built by :mod:`.specs` — on meta tensors placed
over the production meshes, (16, 16) ``("data","model")`` and (2, 16, 16)
``("pod","data","model")``, of 256 and 512 ranks of a fake process group
in this one process.  Nothing is allocated and nothing is computed: every
op runs on the ``meta`` device, with its DTensor placements and the
collectives it issues.  Each cell's record goes to
``results/dryrun-torch/<arch>__<shape>__<mesh>__<variant>.json``:

* ``param_report`` and ``param_counts``: the placements' bytes per device
  (``runtime.sharding.sharding_report``) and the parameter counts;
* ``memory``: ``argument_size_in_bytes``, the bytes of rank 0's blocks of
  the step's arguments (parameters, optimizer state, batch, cache) — a
  count from the placements, not a measurement.  The reference's compiled
  temporaries (``temp_size_in_bytes``) have no counterpart here and are
  left out;
* ``cost`` (``flops``, per rank: the step's counted FLOPs over the ranks)
  and ``collectives`` (``runtime.comm_analysis``: the collectives the step
  issued, at their local result shapes; the reference's
  ``collectives_raw`` is the same count here);
* ``model_flops``, ``analytic_memory_bytes_per_device`` and the roofline
  terms from ``runtime.roofline``, with ``NVLINK_BW`` where the reference
  uses ``ICI_BW``.

DTensor chooses each op's sharding strategy, and with it the collectives
counted, as it does in a real run.  On the 3-D mesh its search over
placement paths can take minutes a layer: a cell whose step runs past
``--time-limit`` seconds stops there and records a ``TimeoutError``.  A
cell whose step fails records the error and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod     # only the 512-rank mesh
  PYTHONPATH=src python -m repro_torch.launch.dryrun --time-limit 0    # no limit (default 600 s)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import signal
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, applicable_shapes, get_config
from ..core import api
from ..models import build_model
from ..optim import adamw
from ..runtime import comm_analysis, roofline
from ..runtime import sharding as shr
from . import specs as S
from .mesh import make_production_mesh, use_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun-torch"

# §Perf levers per (architecture × step kind) — variant "opt"; the
# reference's table
_ZERO1 = {"sharding_policy": "dp_zero1", "param_dtype": "bfloat16"}
_SERVE = {"fsdp": False, "param_dtype": "bfloat16", "decode_masked_update": True}
OPT_OVERRIDES: dict[str, dict[str, dict]] = {
    "qwen2.5-3b": {"train": _ZERO1},
    "minicpm-2b": {"train": _ZERO1},
    "qwen1.5-4b": {"train": _ZERO1},
    "mamba2-370m": {"train": _ZERO1},
    "deepseek-v3-671b": {
        "train": {"moe_group_size": 4096, "param_dtype": "bfloat16", "moe_impl": "a2a"},
        "prefill": {"moe_group_size": 4096, "param_dtype": "bfloat16", "moe_impl": "a2a"},
    },
    "llama4-scout-17b-a16e": {
        "train": {"moe_group_size": 4096, "param_dtype": "bfloat16"},
        "prefill": {"moe_group_size": 4096, "param_dtype": "bfloat16"},
    },
    "deepseek-67b": {"decode": _SERVE, "prefill": _SERVE},
    "qwen2-vl-72b": {"decode": _SERVE, "prefill": _SERVE},
    "recurrentgemma-9b": {},
    "seamless-m4t-medium": {},
}


def opt_overrides_for(arch: str, kind: str) -> dict:
    table = OPT_OVERRIDES.get(arch, {})
    out = dict(table.get("*", {}))
    out.update(table.get(kind, {}))
    return out


def fake_process_group(world_size: int) -> None:
    """A process group of ``world_size`` fake ranks in this process (this
    process is rank 0; collectives move nothing), replacing any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


@contextlib.contextmanager
def time_limit(seconds: float | None):
    """Raise ``TimeoutError`` in the block once it has run ``seconds``
    (none or 0: no limit; in the main thread only, where signals land).
    Yields a dict whose ``"expired"`` says whether it did (DTensor may
    re-raise the error as another type)."""
    state = {"expired": False}
    if not seconds or threading.current_thread() is not threading.main_thread():
        yield state
        return

    def expire(_signum, _frame):
        state["expired"] = True
        raise TimeoutError(f"the step ran past its limit of {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield state
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def argument_bytes(*trees) -> int:
    """Bytes of this rank's blocks of every tensor of ``trees``."""
    total = 0
    for tree in trees:
        for _k, x in api.flatten_with_keys(tree):
            local = x.to_local() if shr.is_placed(x) else x
            total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, variant: str = "baseline", cfg=None,
             limit_s: float | None = None) -> dict:
    """One cell's record (read from ``out_dir`` when there and not
    ``force``).  ``cfg`` replaces ``get_config(arch)`` (a smoke cut);
    ``limit_s`` bounds the step's seconds."""
    mesh_tag = "pod512" if multi_pod else "pod256"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}__{variant}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if variant == "opt":
        cfg = replace(cfg, **opt_overrides_for(arch, shape.kind))
    fake_process_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    model = build_model(cfg)
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh.mesh.shape),
        "multi_pod": multi_pod, "variant": variant, "kind": shape.kind,
    }
    t0 = time.time()
    clock = {"expired": False}
    try:
        param_sds = S.param_specs(model, mesh)
        params_shape = model.param_shapes()
        record["param_report"] = shr.sharding_report(params_shape, cfg, mesh)
        counts = roofline.count_params(params_shape)
        record["param_counts"] = counts

        recorder = comm_analysis.CollectiveRecorder()
        with use_mesh(mesh):  # ambient mesh: activation placements resolve
            if shape.kind == "train":
                moment_dtype = "bfloat16" if (variant == "opt" and cfg.fsdp) else "float32"
                opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
                opt_sds = S.opt_state_specs(param_sds, mesh, opt_cfg, cfg)
                batch_sds = S.batch_specs(cfg, shape, mesh)
                args = (param_sds, opt_sds, batch_sds)
                step = S.make_train_step(model, opt_cfg)
            elif shape.kind == "prefill":
                args = (param_sds, S.batch_specs(cfg, shape, mesh))
                step = S.make_prefill_step(model)
            else:  # decode: one step at the cache's last slot
                args = (param_sds, S.token_specs(cfg, shape, mesh),
                        S.cache_specs(model, shape, mesh), shape.seq_len - 1)
                step = S.make_decode_step(model)
            record["memory"] = {"argument_size_in_bytes": argument_bytes(*args[:3])}
            t1 = time.time()
            with recorder, time_limit(limit_s) as clock:
                cost, _out = comm_analysis.cost_analysis_dict(step, *args)
            record["run_s"] = time.time() - t1

        chips = shr.mesh_size(mesh)
        record["cost"] = {"flops": cost["flops"] / chips}
        coll = recorder.stats
        record["collectives"] = coll.to_dict()
        record["collectives_raw"] = record["collectives"]  # eager: one count
        mf = roofline.model_flops(cfg, shape, counts)
        record["model_flops"] = mf
        analytic_mem = roofline.analytic_memory_bytes(
            cfg, shape, counts, record["param_report"]["bytes_per_device"], chips)
        record["analytic_memory_bytes_per_device"] = analytic_mem
        terms = roofline.RooflineTerms(
            t_compute=(mf["model_flops"] / chips) / roofline.PEAK_FLOPS,
            t_memory=analytic_mem / roofline.HBM_BW,
            t_collective=coll.total_link_bytes / roofline.NVLINK_BW,
            flops=mf["model_flops"] / chips,
            bytes_accessed=analytic_mem,
            link_bytes=coll.total_link_bytes,
        )
        record["roofline"] = terms.to_dict()
        record["useful_flops_ratio_vs_counted"] = (
            mf["model_flops"] / cost["flops"] if cost["flops"] else None)
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = (f"TimeoutError: the step ran past its limit of {limit_s:g} s"
                           if clock["expired"] else f"{type(e).__name__}: {e}")
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = time.time() - t0

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2))
    print(f"[{record['status']}] {arch} × {shape_name} × {mesh_tag} ({record['total_s']:.1f}s)",
          flush=True)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true", help="only the 512-rank mesh")
    ap.add_argument("--single-pod", action="store_true", help="only the 256-rank mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--time-limit", type=float, default=600.0,
                    help="seconds a cell's step may run before it is recorded as timed out "
                         "(0: no limit)")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args()

    torch.set_grad_enabled(True)
    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    if args.single_pod:
        meshes = [False]

    results = []
    for arch in archs:
        shapes = [args.shape] if args.shape else applicable_shapes(get_config(arch))
        for shape_name in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape_name, mp, out_dir, args.force,
                                        variant=args.variant, limit_s=args.time_limit))
    ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{ok}/{len(results)} cells OK")
    for r in results:
        if r["status"] != "ok":
            print(f"  FAILED {r['arch']} × {r['shape']} × "
                  f"{'pod512' if r['multi_pod'] else 'pod256'}: {r.get('error')}")


if __name__ == "__main__":
    main()
