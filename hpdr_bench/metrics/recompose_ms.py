"""Milliseconds a call of the multilevel recomposition (``mgard.recompose``):
the median over the program's stage-profiled calls after the window (its
``encode_profiled`` / ``decode_profiled`` synchronise the card after every
stage)."""

from statistics import median

KEY = "decode.invert[mgard_decorrelate]"


def read(trace):
    found = [s[KEY] for s in trace.stage_seconds or () if KEY in s]
    return median(found) * 1e3 if found else None
