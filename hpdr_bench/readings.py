"""Read the check's numbers on many seeds in one process, for the program and
for the control (the plain reference in a lower precision in the program's
place), to set and test the check's limits.

    python3 hpdr_bench/readings.py --workload mgard.snapshot --seeds 11 12 13 \\
        --control-seeds 21 22 23 --seconds 2

Each run is a short window at the cell's own load (whole rounds, so every
field's output is sampled); one JSON line a run on standard output.  The
benchmark's own runs (``run.py``) never run the control.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from hpdr_bench import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.find_cell(args.workload)
    runs = [(s, None) for s in args.seeds] + [(s, "control") for s in args.control_seeds]
    for seed, kind in runs:
        driver = None
        if kind == "control":
            check = spec.module("checks", cell.config["check"])
            driver = check.Control(cell.config, device, torch.bfloat16)
        t = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, device, driver=driver)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": kind or "program",
                          "correct": out.correct, "attempted": out.attempted,
                          "checks": {k: v["value"] for k, v in out.checks.items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
