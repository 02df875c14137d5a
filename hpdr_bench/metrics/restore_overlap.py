"""How far the read-back's lanes overlap: a decompress call's summed lane
seconds (main-thread staging, compute lane) over its wall time to the last
chunk's completion, from the program's own lane timings
(``CompressorStream.decompress(..., timings=)`` through
``pipeline.overlap_efficiency``) of one call a field after the window,
their mean.  1 is a serial run, 2 both lanes busy all the time."""

from statistics import mean

KEY = "restore_overlap"


def read(trace):
    found = [s[KEY] for s in trace.stage_seconds or () if KEY in s]
    return mean(found) if found else None
