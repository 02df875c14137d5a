"""The spread of each metric over sets of runs, as the bounds are set from.

    python3 hpdr_bench/spreads.py 'out/set1_*.out' 'out/set2_*.out'

Each argument is a glob of files whose last JSON line is a run's result.  For
every metric and set: the median, the spread (first to third quartile over the
median, ``statistics.quantiles``), the spread without the run farthest from the
median, and the spread of all runs pooled; then the second median's shift.
"""

import glob
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hpdr_bench.stats import spread  # noqa: E402


def without_farthest(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def results(pattern: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(pattern)):
        lines = [ln for ln in Path(path).read_text().splitlines() if ln.startswith("{")]
        if not lines:
            print(f"no result in {path}")
            continue
        line = json.loads(lines[-1])
        if not line["correct"]:
            print(f"not correct: {path}")
        rows.append({k: v["value"] for k, v in line["metrics"].items()})
    return rows


def main(patterns: list[str]) -> None:
    sets = [results(p) for p in patterns]
    for name in sorted({k for rows in sets for r in rows for k in r}):
        vals = [[r[name] for r in rows if name in r] for rows in sets]
        meds = [statistics.median(v) for v in vals]
        print(f"{name}: medians {meds}; spreads {[100 * spread(v) for v in vals]} %; "
              f"without the farthest {[100 * spread(without_farthest(v)) for v in vals]} %; "
              f"pooled {100 * spread(sum(vals, []))} %; "
              f"second median {100 * (meds[-1] - meds[0]) / meds[0]:+.3f} %")


if __name__ == "__main__":
    main(sys.argv[1:])
