"""All field bytes compressed in the window over all the time of its compress phases."""

from ..stats import phase_rate_gbps


def read(window):
    phases = [p for p in window.phases if p.name == "compress"]
    if not phases:
        return None
    return phase_rate_gbps([p.field_bytes for p in phases], [p.seconds for p in phases])
