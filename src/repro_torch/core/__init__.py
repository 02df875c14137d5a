"""HPDR core in PyTorch (counterpart of ``repro.core``).

Layers, bottom-up: device adapters (`adapters`), block views (`machine`,
`abstractions`), the CMM (`context`), the ZFP, Huffman and MGARD pipelines
(`zfp`, `huffman`, `bitstream`, `mgard`, `quantize`) behind the codec registry (`codecs`) and stage graph
(`stages`), and the high-level API (`api`: spec → plan → execute, with the
`container` byte format).
"""

from . import (  # noqa: F401
    abstractions,
    adapters,
    api,
    bitstream,
    codecs,
    container,
    context,
    huffman,
    machine,
    mgard,
    quantize,
    zfp,
)
from .api import (  # noqa: F401
    Compressed,
    ContainerError,
    ReductionPlan,
    ReductionSpec,
    compress,
    decompress,
)
