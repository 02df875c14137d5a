"""Spans of the program's own steps on the profiler's timeline.

:func:`span` names a step (an API call, a pipeline stage, a step of the
standalone ZFP API) as a ``torch.profiler.record_function`` range,
``repro_torch.<name>``, while a ``torch.profiler`` profile is running, and is
a shared no-op context otherwise.  The ranges land in the same Kineto
timeline as the device operations, so a trace puts each kernel, copy and
idle gap down to the step that caused it.

Spans are on exactly while a profile runs: there is no setting.  Off, a span
costs one read of the profiler's module-level flag and allocates nothing.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range ``repro_torch.<name>`` while a profile is
    running; otherwise one shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
