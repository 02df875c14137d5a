"""Plan-cache misses (``GLOBAL_CMM.stats()``) across the traced window: a call
that builds its plan again pays the plan's tables and workspace."""


def read(trace):
    return trace.plan_misses
