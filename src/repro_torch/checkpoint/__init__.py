"""HPDR-compressed checkpoints in PyTorch (counterpart of ``repro.checkpoint``)."""

from .manager import CheckpointManager, CheckpointPolicy  # noqa: F401
