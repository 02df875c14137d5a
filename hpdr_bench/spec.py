"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:
``configs/<config>.json`` and ``traffic/<traffic>.json``.  A configuration
names its program driver (``drivers/<driver>.py``) and its check
(``checks/<check>.py``); a per-layer metric is read by
``metrics/<metric name>.py``.  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = matches[0]
    return Cell(
        workload=w,
        config=load_json("configs", w["config"]),
        traffic=load_json("traffic", w["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def module(kind: str, name: str) -> ModuleType:
    """``hpdr_bench/<kind>/<name>.py`` (``drivers``, ``checks`` or ``metrics``)."""
    return importlib.import_module(f"hpdr_bench.{kind}.{name}")
