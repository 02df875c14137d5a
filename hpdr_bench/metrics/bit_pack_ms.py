"""Milliseconds a call of the prefix sum and word packing of the codes
(``pack_stream``): the median over the program's stage-profiled calls after
the window (its ``encode_profiled`` / ``decode_profiled`` synchronise the
card after every stage)."""

from statistics import median

KEY = "encode.bit_pack"


def read(trace):
    found = [s[KEY] for s in trace.stage_seconds or () if KEY in s]
    return median(found) * 1e3 if found else None
