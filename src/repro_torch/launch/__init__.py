"""Launch-side helpers of the port (counterpart of ``repro.launch``): device
meshes, the ambient mesh, the multi-controller host topology and the
shared-filesystem barrier (:mod:`.mesh`), the input specs and step builders
(:mod:`.specs`), the training launcher, on one device or placed over a
mesh (:mod:`.train`), and the multi-pod dry run (:mod:`.dryrun`)."""
