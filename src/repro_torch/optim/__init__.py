"""Optimizer side of training (counterpart of ``repro.optim``): AdamW
(:mod:`.adamw`), the learning-rate schedules (:mod:`.schedule`) and
error-feedback gradient compression (:mod:`.grad_compress`)."""

from . import adamw, grad_compress, schedule  # noqa: F401
