"""How far the compress pipeline's lanes overlap: a compress call's summed
lane seconds (main-thread staging, compute lane, io lane) over its wall
time, from the program's own lane timings (``ChunkedResult.
overlap_efficiency``) of one call a field after the window, their mean.
1 is a serial run, 3 every lane busy all the time.  The lanes' own spans
are not read: the profiler records only the thread that started it."""

from statistics import mean

KEY = "stream_overlap"


def read(trace):
    found = [s[KEY] for s in trace.stage_seconds or () if KEY in s]
    return mean(found) if found else None
