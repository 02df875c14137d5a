"""Launch-side helpers of the port (counterpart of ``repro.launch``): the
multi-controller host topology and the shared-filesystem barrier
(:mod:`.mesh`), and the one-device training launcher (:mod:`.train`)."""
