"""Milliseconds of device time a compress call launches inside the program's
span ``stage.bit_pack`` (the prefix sum and word packing of the codes): what
``bit_pack_ms`` times after the window with a synchronise a stage, read in
the window without one."""

from ..program_spans import device_ms_per_call


def read(trace):
    return device_ms_per_call(trace, "stage.bit_pack", "compress")
