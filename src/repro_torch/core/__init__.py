"""HPDR core in PyTorch (counterpart of ``repro.core``).

Layers, bottom-up: device adapters (`adapters`), the machine abstraction
(`machine`: GEM/DEM) and the parallel abstractions (`abstractions`), the
CMM (`context`), the ZFP, Huffman and MGARD pipelines
(`zfp`, `huffman`, `bitstream`, `mgard`, `quantize`) and the progressive
tier (`progressive`) behind the codec registry (`codecs`) and stage graph
(`stages`), the execution engine (`engine`), and the high-level API (`api`:
spec → plan → execute, with the `container` byte format, and the pytree
entry points).
"""

from . import (  # noqa: F401
    abstractions,
    adapters,
    api,
    bitstream,
    codecs,
    container,
    context,
    engine,
    huffman,
    machine,
    mgard,
    progressive,
    quantize,
    zfp,
)
from .api import (  # noqa: F401
    Compressed,
    ContainerError,
    ReductionPlan,
    ReductionSpec,
    compress,
    compress_pytree,
    decompress,
    decompress_pytree,
)
