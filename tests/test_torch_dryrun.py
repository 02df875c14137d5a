"""The port's dry run (``repro_torch.launch.dryrun``) and collective
accounting (``repro_torch.runtime.comm_analysis``), on the CPU.

The dry run's cells run in a subprocess (a fake process group of 256 or
512 ranks must not outlive it), at qwen2.5-3b's smoke cut on meta tensors:
its decode cell on the (2, 16, 16) ``("pod","data","model")`` mesh, its
train cell on the (16, 16) ``("data","model")`` mesh at two depths, and the
train cell on the (2, 16, 16) mesh under a time limit it cannot meet
(DTensor's strategy search there takes minutes).  A cell's
``param_report`` is the reference's ``sharding_report`` on the same
abstract mesh, exactly.  The accounting is held to the reference's
``test_hlo_collective_parsing_scaled``: the same collectives give the same
record, key for key; and the recorder counts the collectives DTensor
issues inside an op.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import jax
from jax.sharding import AbstractMesh
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.runtime import hlo_analysis
from repro.runtime import sharding as jshr

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args], env=env, cwd=ROOT,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    return out


_CELLS = """
    import sys
    from dataclasses import replace
    from pathlib import Path
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    out = Path(sys.argv[1])
    smoke = get_config("qwen2.5-3b").smoke()
    dryrun.run_cell("qwen2.5-3b", "decode_32k", True, out, force=True, cfg=smoke)
    for n in (2, 4):
        dryrun.run_cell("qwen2.5-3b", "train_4k", False, out / f"layers{n}", force=True,
                        cfg=replace(smoke, n_layers=n))
    dryrun.run_cell("qwen2.5-3b", "train_4k", True, out, force=True, cfg=smoke, limit_s=3)
    import torch.distributed as dist
    dist.destroy_process_group()
"""

_MESHES = {"pod512": ((2, 16, 16), ("pod", "data", "model")),
           "pod256": ((16, 16), ("data", "model"))}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    _run(_CELLS, str(d))
    read = lambda path: json.loads(path.read_text())  # noqa: E731
    return {("decode_32k", "pod512"): read(d / "qwen2.5-3b__decode_32k__pod512__baseline.json"),
            ("train_4k", "pod256"): read(d / "layers4" / "qwen2.5-3b__train_4k__pod256__baseline.json"),
            "layers2": read(d / "layers2" / "qwen2.5-3b__train_4k__pod256__baseline.json"),
            "timed_out": read(d / "qwen2.5-3b__train_4k__pod512__baseline.json")}


def _check_cell(rec: dict, shape: str, mesh: str) -> None:
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == list(_MESHES[mesh][0]) and rec["kind"] == shape.split("_")[0]
    cfg = jget_config("qwen2.5-3b").smoke()
    jshape = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.PRNGKey(0)))
    want = jshr.sharding_report(jshape, cfg, AbstractMesh(*_MESHES[mesh]))
    assert rec["param_report"] == want
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert coll["by_type"] and coll["total_result_bytes"] > 0  # tp: activations cross ranks
    assert coll == rec["collectives_raw"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert "temp_size_in_bytes" not in rec["memory"]
    assert rec["roofline"]["t_collective_s"] > 0 and rec["model_flops"]["model_flops"] > 0


@pytest.mark.parametrize("shape", ["decode_32k"])
def test_dry_run_cell_on_the_512_rank_mesh(shape, cells):
    _check_cell(cells[(shape, "pod512")], shape, "pod512")


def test_dry_run_train_cell_on_the_256_rank_mesh(cells):
    _check_cell(cells[("train_4k", "pod256")], "train_4k", "pod256")


def test_dry_run_counts_every_layer_s_collectives(cells):
    """Four layers issue more collectives than two: each layer's, those
    DTensor issues inside its ops included, are counted."""
    four = cells[("train_4k", "pod256")]["collectives"]["by_type"]
    two = cells["layers2"]["collectives"]["by_type"]
    assert four["all-gather"]["count"] > two["all-gather"]["count"]
    assert four["all-gather"]["result_bytes"] > two["all-gather"]["result_bytes"]


def test_dry_run_cell_past_its_time_limit_records_a_timeout(cells):
    """A step that runs past ``limit_s`` is stopped and recorded as an
    error, with no cost, collectives or roofline claimed for it."""
    rec = cells["timed_out"]
    assert rec["status"] == "error"
    assert rec["error"] == "TimeoutError: the step ran past its limit of 3 s"
    assert not {"cost", "collectives", "roofline", "run_s"} & set(rec)
    assert rec["mesh"] == [2, 16, 16] and rec["param_report"]["total_bytes"] > 0


_TOY = """
    import json, sys, torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.runtime import comm_analysis
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    group = dist.group.WORLD
    x = torch.empty(4, dtype=torch.float32, device="meta")
    rec = comm_analysis.CollectiveRecorder()
    with rec:
        for _layer in range(12):  # a layer's all-reduce, 12 layers
            x = funcol.all_reduce(x, "sum", group)
        y = funcol.all_gather_tensor(x, 0, group)
        z = funcol.reduce_scatter_tensor(torch.empty(8, device="meta"), "sum", 0, group)
    cost, out = comm_analysis.cost_analysis_dict(torch.matmul, torch.ones(3, 5), torch.ones(5, 7))
    # a product of two row-sharded DTensors: DTensor gathers one inside mm
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (2,))
    a, b = (distribute_tensor(torch.empty(shape, device="meta"), mesh, [Shard(0)],
                              src_data_rank=None) for shape in ((4, 6), (6, 8)))
    inner = comm_analysis.CollectiveRecorder()
    with inner:
        torch.mm(a, b)
    print(json.dumps({"coll": rec.stats.to_dict(), "flops": cost["flops"],
                      "out": list(out.shape), "y": list(y.shape), "z": list(z.shape),
                      "inner": inner.stats.to_dict()}))
    dist.destroy_process_group()
"""

_HLO = """
%cond (p: (s32[], f32[4])) -> pred[] {
  %c = s32[] constant(12)
  ROOT %lt = pred[] compare(%gte, %c), direction=LT
}
%body (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ar = f32[4]{0} all-reduce(%x), replica_groups={}, to_apply=%add
  ROOT %t = (s32[], f32[4]) tuple(%i, %ar)
}
ENTRY %main (a: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]) while(%init), condition=%cond, body=%body
  ROOT %ag = f32[8]{0} all-gather(%gte2), dimensions={0}
  %rs = f32[4]{0} reduce-scatter(%v), replica_groups={{0,1}}, dimensions={0}, to_apply=%add
}
"""


def test_recorded_collectives_are_the_reference_s_accounting():
    """One all-reduce of 16 bytes in each of 12 layers, an all-gather of 32
    result bytes and a reduce-scatter over 2 ranks: the recorder's record
    equals the reference's ``parse_collectives_scaled`` of the HLO that
    holds the same collectives (the all-reduce in a while body of 12 trips)
    — counts, result bytes and link bytes by the reference's factors."""
    got = json.loads(_run(_TOY).stdout.decode().strip().splitlines()[-1])
    want = hlo_analysis.parse_collectives_scaled(_HLO).to_dict()
    coll = got["coll"]
    assert coll["by_type"]["all-reduce"]["result_bytes"] == 16 * 12
    assert coll["by_type"]["all-gather"]["result_bytes"] == 32
    assert coll["by_type"]["all-reduce"]["link_bytes"] == 2.0 * 16 * 12
    assert coll["by_type"]["reduce-scatter"]["link_bytes"] == 2 * 16
    assert {k: (v["result_bytes"], v["link_bytes"]) for k, v in coll["by_type"].items()} == \
        {k: (v["result_bytes"], v["link_bytes"]) for k, v in want["by_type"].items()}
    assert coll["total_link_bytes"] == want["total_link_bytes"]
    assert coll["by_type"]["all-reduce"]["count"] == 12  # every layer's, issued eagerly
    assert got["flops"] == 2 * 3 * 5 * 7 and got["out"] == [3, 7]
    assert got["y"] == [8] and got["z"] == [4]
    # the all-gather DTensor issued inside mm: one (6, 8) float32 block
    assert got["inner"]["by_type"] == {
        "all-gather": {"count": 1, "result_bytes": 6 * 8 * 4, "link_bytes": 6 * 8 * 4.0}}
