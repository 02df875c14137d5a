"""Milliseconds from the start of the program's span ``zfp.decompress`` to the
start of the runtime call that launched its first device operation: host time
a decompress call spends before the card gets work, on the host's clock."""

from ..program_spans import lead_ms_per_call


def read(trace):
    return lead_ms_per_call(trace, "zfp.decompress", "decompress")
