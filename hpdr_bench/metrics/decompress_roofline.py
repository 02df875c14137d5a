"""Share of the decompress spans' summed kernel time that the least time takes:
every stored byte read once and every field byte written once, at the card's
peak memory bandwidth (``peaks.json``)."""

from ..stats import decompress_roofline_bytes, roofline_pct


def read(trace):
    bw = trace.peak("hbm_bytes_per_s")
    calls = [c for c, _, _ in trace.phase_spans("decompress")]
    if bw is None or not calls:
        return None
    least = sum(decompress_roofline_bytes(c.field_bytes, c.stored_bytes) for c in calls)
    return roofline_pct(least, bw, trace.seconds_in("decompress"))
