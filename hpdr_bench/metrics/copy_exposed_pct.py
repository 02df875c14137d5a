"""The paper's memory transfer overhead, of the compress calls: inside their
spans, the time in which a host-device copy runs on the card and no kernel
does, as a share of the time in which any device operation runs (device
timestamps only).  The read-back's copies are left out: its rate is
``decompress_GBps``."""

from ..stats import union_seconds


def read(trace):
    calls = trace.phase_spans("compress")
    if not calls or not any(o.kind == "memcpy" for o in trace.device_ops):
        return None
    every = [(o.start, o.end) for o in trace.device_ops]
    kernels = [(o.start, o.end) for o in trace.device_ops if o.kind == "kernel"]
    copies = [(o.start, o.end) for o in trace.device_ops if o.kind in ("kernel", "memcpy")]
    busy = sum(union_seconds(every, a, b) for _call, a, b in calls)
    if busy <= 0:
        return None
    exposed = sum(union_seconds(copies, a, b) - union_seconds(kernels, a, b)
                  for _call, a, b in calls)
    return 100.0 * exposed / busy
