"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``kernels/*/csrc/`` exposes a plain C interface, so it
compiles in seconds without PyTorch's headers (``nvcc -shared``) and binds
through :mod:`ctypes`.  Libraries go to ``build/`` at the root of the
checkout (or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source and
the flags, so an edited source is rebuilt and a stale library never loads.
:func:`build` starts one nvcc per missing library, all at once, and waits
for all of them; a failed build raises with nvcc's output.

Nothing here runs at import: the CPU tests import every module, and only a
wrapper given a CUDA tensor builds or loads a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent

SOURCES = {
    name: _KERNELS / name / "csrc" / f"{name}.cu"
    for name in ("zfp_block", "histogram", "huffman_encode", "huffman_decode",
                 "quantize_map", "tridiag", "mgard_lerp")
}

# Built without -ftz / --use_fast_math: the kernels flush denormals
# themselves, where the reference does, and nowhere else.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _KERNELS.parents[2] / "build"


def nvcc() -> str:
    """The nvcc to build with: ``$NVCC``, then ``PATH``, then ``$CUDA_HOME/bin``."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # lazy: heavy import

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named library that is not built yet, in parallel.

    Returns ``{name: library path}``.  nvcc's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<library>.log``.
    """
    names = list(SOURCES) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        report, _ = proc.communicate()
        path.with_suffix(".so.log").write_text(report)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{report}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("CUDA build failed: " + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named library, built on first use and loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
