"""Milliseconds a compress call spends copying the container's sections from
the card to host memory (``LeafView.fetch``, pageable): the device's
``Memcpy DtoH`` time inside the window's compress spans over their calls.
The copy waits on the host's side of a pageable transfer, so its device time
is its wall time."""


def read(trace):
    calls = trace.phase_spans("compress")
    seconds = trace.seconds_in("compress", "memcpy", "DtoH")
    return seconds / len(calls) * 1e3 if calls and seconds > 0 else None
