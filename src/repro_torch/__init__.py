"""repro_torch — the HPDR reduction framework ported to PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference), mirroring its layout:
``core`` (container, CMM, adapters, codec registry, stage graph, the ZFP
codec and the public API) and ``kernels`` (hand-written Hopper kernels with
their plain PyTorch versions).  It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``backend="torch"``, which runs the plain versions on the CPU.
"""

__version__ = "0.1.0"
