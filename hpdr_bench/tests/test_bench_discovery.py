"""BENCHMARK.json keeps to its contract, and every name in it is found as a file."""

import json
import re
import shutil
import sys

import pytest
import torch

from hpdr_bench import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["hpdr_bench"] and 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_entries(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:  # every cell it is read in reports the metric it moves
            assert m["moves"] in [e["name"] for e in spec.find_cell(w, bench).end_to_end]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_a_file(bench):
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert spec.load_json("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert hasattr(spec.module("drivers", cell.config["driver"]), "Driver")
        check = spec.module("checks", cell.config["check"])
        assert callable(check.compare) and check.LIMITS and hasattr(check, "Control")
        assert cell.end_to_end and cell.per_layer
    for m in bench["end_to_end"]:
        assert callable(spec.module("end_to_end", m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_config_files_state_their_cut(bench):
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["assumed"] and cfg["guarantees"] and cfg["precision"] == "float32"


def test_new_files_are_found_without_edits(tmp_path, monkeypatch, bench, tiny):
    """A later cell brings a configuration, a traffic mix and a metric reader as
    new files, and entries in BENCHMARK.json; nothing that exists is edited.
    The new cell, a mix with no decompress phase, runs and is judged by its
    stored forms alone."""
    bench_dir = tmp_path / "hpdr_bench"
    for kind in ("configs", "traffic"):
        shutil.copytree(spec.BENCH_DIR / kind, bench_dir / kind)
    cfg = spec.load_json("configs", "nyx512-zfp-rate16")
    cfg["name"] = "nyx256-zfp-rate8"
    cfg["data"]["shape"], cfg["program"]["params"]["rate"] = [100, 500, 500], 8
    (bench_dir / "configs" / "nyx256-zfp-rate8.json").write_text(json.dumps(cfg))
    traffic = dict(spec.load_json("traffic", "rounds"), name="compress_only",
                   phases=["compress"])
    (bench_dir / "traffic" / "compress_only.json").write_text(json.dumps(traffic))
    readers = tmp_path / "readers"
    readers.mkdir()
    (readers / "calls_seen.py").write_text("def read(trace):\n    return len(trace.calls)\n")
    import hpdr_bench.metrics as metrics_pkg

    monkeypatch.setattr(metrics_pkg, "__path__", list(metrics_pkg.__path__) + [str(readers)])
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    extended = json.loads(json.dumps(bench))
    extended["workloads"].append({"name": "zfp.small", "config": "nyx256-zfp-rate8",
                                  "traffic": "compress_only", "chips": 1, "why": "x"})
    extended["per_layer"].append({"name": "calls_seen", "unit": "count", "better": "higher",
                                  "source": "host_clock", "layer": "device",
                                  "moves": "compress_GBps", "workloads": ["zfp.small"]})
    cell = spec.find_cell("zfp.small", extended)
    assert cell.config["program"]["params"]["rate"] == 8
    assert cell.traffic["phases"] == ["compress"]
    assert [m["name"] for m in cell.per_layer][-1] == "calls_seen"
    assert spec.module("metrics", "calls_seen").read(type("T", (), {"calls": [1, 2]})) == 2
    sys.modules.pop("hpdr_bench.metrics.calls_seen", None)
    out = harness.run_cell(cell, 2 ** 31 + 3, 0.05, False, torch.device("cpu"), scale=tiny)
    assert out.correct, out.checks
    assert set(out.checks) == {"failed_calls", "samples_missing", "payload_words_diff",
                               "emax_diff"}
    assert set(out.metrics) == {"compress_GBps", "ratio", "setup_s"}  # nothing decompressed


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        spec.find_cell("no.such.cell", bench)
    with pytest.raises(KeyError):
        spec.load_json("configs", "no-such-config")
