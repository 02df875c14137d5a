"""Stage-graph codec pipeline (see :mod:`repro_torch.core.stages.base`)."""

from __future__ import annotations

from .base import (  # noqa: F401
    CallEnv,
    CompiledPipeline,
    LeafView,
    Stage,
    StageGraph,
    TransferStats,
)
from .library import (  # noqa: F401
    AlphabetBind,
    AlphabetScan,
    BinSchedule,
    BitPack,
    ByteKeys,
    CodebookBuild,
    HuffmanEntropy,
    HuffmanHistogram,
    IntKeys,
    MgardDecorrelate,
    UniformQuantize,
    ZfpBlockTransform,
)
