"""Runtime layer of the port (counterpart of ``repro.runtime``): aggregated
segment-file I/O (:mod:`.io`) and the device-aware executor
(:mod:`.executor`)."""
