"""The import guard: nothing the benchmark runs loads JAX or the JAX package
(``repro``), and the reference loads nothing of the program (``repro_torch``).
Top-level module names are compared whole: ``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the parts that make or judge the answers: they take nothing from the program
INDEPENDENT = ("reference", "checks", "data.py", "traffic.py", "stats.py")


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, relative imports
    resolved inside the benchmark's package."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("hpdr_bench" if node.level else node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in sources()
                                  if str(p.relative_to(BENCH)).startswith(INDEPENDENT)],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_names(tmp_path):
    f = tmp_path / "probe.py"
    f.write_text("import repro_torch.core\nimport jaxtyping\nfrom reprox import y\n")
    assert top_level_imports(f) == {"repro_torch", "jaxtyping", "reprox"}
    assert not top_level_imports(f) & FORBIDDEN


def test_a_dry_run_loads_none_of_them():
    """Both cells on the CPU at a tiny size, in a fresh interpreter, then
    ``sys.modules`` compared by whole top-level names."""
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from hpdr_bench import harness, spec\n"
        "for w in ('mgard.snapshot', 'zfp.resident'):\n"
        "    o = harness.run_cell(spec.find_cell(w), 5, 0.1, True, torch.device('cpu'),\n"
        "                         scale={'shape': [9, 9, 9], 'fields': ['a']})\n"
        "    assert o.correct\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded, found = proc.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in loaded and found == "[]"
    assert not set(eval(loaded)) & FORBIDDEN
