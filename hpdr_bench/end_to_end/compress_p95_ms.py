"""The 95th percentile (nearest rank) of every compress call's latency in the window."""

from ..stats import p95


def read(window):
    calls = window.of("compress")
    return p95([c.seconds for c in calls])[0] * 1e3 if calls else None
