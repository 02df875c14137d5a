"""Run one cell of the benchmark and print its result as the last line.

    python3 hpdr_bench/run.py --workload mgard.snapshot --seed 7 --seconds 30 --trace 0

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (the same window under the
profiler).  The run needs the CUDA cards the cell asks for and exits with a
non-zero code, printing no result, without them; so it does where the
program's package (``src/repro_torch``) is absent, and where JAX or the JAX
package was loaded.  Each number the check compares is printed beside its
limit as the last lines of standard error and under ``checks``, the last key
of the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def result_line(outcome) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": outcome.metrics, "device": outcome.device}
    if outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = outcome.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hpdr_bench import harness, spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    outcome = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for note in outcome.notes:
        print(note, file=sys.stderr)
    print(json.dumps(result_line(outcome)))
    sys.stdout.flush()
    for name, c in outcome.checks.items():
        print(f"check {name}: {c['value']!r} (limit <= {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
