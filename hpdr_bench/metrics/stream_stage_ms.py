"""Milliseconds a compress call's main thread spends staging its chunks: the
program's spans ``pipeline.stage`` (a host chunk's copy into its slot's
page-locked buffer and the wait for its copy to the card), summed over the
call's chunks and averaged over the window's compress calls."""

from ..program_spans import per_call


def read(trace):
    calls = per_call(trace, "pipeline.stage", "compress")
    if not calls:
        return None
    return sum(b - a for spans in calls for a, b in spans) / len(calls) / 1e6
