"""Training data of the port (counterpart of ``repro.data``)."""

from .pipeline import DataConfig, SyntheticLMStream  # noqa: F401
