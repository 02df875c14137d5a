"""Milliseconds a decompress call spends copying the container's sections from
host memory to the card (``_stage_in``, pageable): the device's ``Memcpy HtoD``
time inside the window's decompress spans over their calls."""


def read(trace):
    calls = trace.phase_spans("decompress")
    seconds = trace.seconds_in("decompress", "memcpy", "HtoD")
    return seconds / len(calls) * 1e3 if calls and seconds > 0 else None
