"""Milliseconds of device time a decompress call launches inside the
program's span ``stage.invert[mgard_decorrelate]`` (MGARD's recomposition):
what ``recompose_ms`` times after the window with a synchronise a stage, read
in the window without one."""

from ..program_spans import device_ms_per_call


def read(trace):
    return device_ms_per_call(trace, "stage.invert[mgard_decorrelate]", "decompress")
