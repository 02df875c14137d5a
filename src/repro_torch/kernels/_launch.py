"""What every kernel wrapper of the port shares: binding a built library's C
entry points, checking the tensors it is given, and raising on a failed
launch.  Nothing here runs at import."""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

PTR, I64, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_COUNT_LOCK = threading.Lock()


def count_launch(launches: dict[str, int], name: str) -> None:
    """Add one launch of ``name`` to a wrapper's counter, under a lock: the
    engine's tasks launch from several threads at once, and nothing in the
    language makes ``launches[name] += 1`` atomic."""
    with _COUNT_LOCK:
        launches[name] += 1


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``_build.SOURCES[name]``, its entry points typed
    with ``signatures`` (each returns an int CUDA error code)."""
    lib = _build.load(name)
    for fn, argtypes in signatures.items():
        entry = getattr(lib, fn)
        if entry.argtypes is None:
            entry.argtypes = argtypes
            entry.restype = INT
    return lib


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def route(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor (the plain version's), False for a CUDA one
    (the kernel's); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or CPU tensors, got {t.device}")
    return False


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
