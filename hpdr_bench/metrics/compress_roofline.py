"""Share of the compress spans' summed kernel time that the least time takes:
every field byte read once and every stored byte written once, at the card's
peak memory bandwidth (``peaks.json``), whatever implements the work (the
port's kernels and its plain torch operations on the card alike)."""

from ..stats import compress_roofline_bytes, roofline_pct


def read(trace):
    bw = trace.peak("hbm_bytes_per_s")
    calls = [c for c, _, _ in trace.phase_spans("compress")]
    if bw is None or not calls:
        return None
    least = sum(compress_roofline_bytes(c.field_bytes, c.stored_bytes) for c in calls)
    return roofline_pct(least, bw, trace.seconds_in("compress"))
