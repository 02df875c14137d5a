"""The run's last line, and a run that cannot measure: no card, no program."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from hpdr_bench import harness, run, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345  # past 32 signed bits: any whole-number seed is taken


@pytest.mark.parametrize("workload", ["mgard.snapshot", "zfp.resident"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape(workload, trace, tiny):
    cell = spec.find_cell(workload)
    out = harness.run_cell(cell, SEED, 0.3, bool(trace), CPU, scale=tiny)
    line = json.loads(json.dumps(run.result_line(out)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == bool(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"], name
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        b = line["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == names  # every end-to-end metric, every run


def test_same_seed_same_work(tiny):
    cell = spec.find_cell("zfp.resident")
    a = harness.run_cell(cell, SEED, 0.2, False, CPU, scale=tiny)
    b = harness.run_cell(cell, SEED, 0.2, False, CPU, scale=tiny)
    assert a.metrics["ratio"] == b.metrics["ratio"]
    data = {"generator": "nyx_like", "shape": [9, 8, 7], "fields": [1, 2]}
    f1 = harness.data.make_fields(data, SEED, CPU)
    f2 = harness.data.make_fields(data, SEED, CPU)
    assert all(torch.equal(x, y) for x, y in zip(f1, f2)) and not torch.equal(f1[0], f1[1])


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mgard.snapshot", "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_no_fallback_to_the_cpu(monkeypatch, capsys):
    """One card present but the cell asks for more: no result either."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "zfp.resident", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "hpdr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "hpdr_bench/run.py", "--workload", "zfp.resident",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro.core"]


@pytest.mark.parametrize("with_recon", [True, False])
def test_a_sample_without_its_reconstruction(with_recon, tiny):
    """Where the traffic decompresses, a kept stored form without its
    reconstruction is missing; where it does not, the stored form is judged
    alone and the reconstruction's numbers are not compared."""
    cell = spec.find_cell("zfp.resident")
    config = harness.scaled(cell.config, tiny)
    check = spec.module("checks", config["check"])
    driver = spec.module("drivers", config["driver"]).Driver(config, CPU)
    fields = harness.data.make_fields(config["data"], SEED, CPU)
    kept = {i: [driver.compress(f), None] for i, f in enumerate(fields)}
    checks = harness.judge(check, driver, config, fields, kept, with_recon, harness.Window())
    if with_recon:
        assert checks["samples_missing"]["value"] == len(fields)
        assert checks["recon_values_diff"]["value"] is None
    else:
        assert checks["samples_missing"]["value"] == 0
        assert set(check.NEEDS_RECON).isdisjoint(checks)
        assert checks["payload_words_diff"]["value"] == 0 and checks["emax_diff"]["value"] == 0
