"""Milliseconds of device time a compress call launches inside the program's
span ``stage.mgard_decorrelate`` (MGARD's multilevel decomposition), read in
the window without a synchronise."""

from ..program_spans import device_ms_per_call


def read(trace):
    return device_ms_per_call(trace, "stage.mgard_decorrelate", "compress")
