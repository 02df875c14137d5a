"""Runtime layer of the port (counterpart of ``repro.runtime``): aggregated
segment-file I/O (:mod:`.io`), the device-aware executor (:mod:`.executor`),
the sharding rules and their DTensor placements (:mod:`.sharding`) and the
collective and FLOP accounting of a step (:mod:`.comm_analysis`, the
counterpart of ``repro.runtime.hlo_analysis``)."""
