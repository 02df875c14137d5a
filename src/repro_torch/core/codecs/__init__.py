"""HPDR codec registry (counterpart of ``repro.core.codecs``).

Every compression method is a :class:`~repro_torch.core.codecs.base.Codec`
registered under its public name with :func:`register_codec`; the API layer
dispatches ``compress``/``decompress`` through this registry and stores each
codec's plan in the CMM.

Every method of the reference is registered: ``mgard``, ``mgard-progressive``,
``zfp``, ``huffman`` and ``huffman-bytes``.
"""

from __future__ import annotations

from .base import Codec, ReductionPlan, ReductionSpec  # noqa: F401

_REGISTRY: dict[str, Codec] = {}

def register_codec(name: str):
    """Class decorator: instantiate ``cls(name)`` and register it."""

    def deco(cls):
        _REGISTRY[name] = cls(name)
        return cls

    return deco


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; expected one of {available_methods()}"
        ) from None


def available_methods() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


from . import huffman_codec, mgard_codec, progressive_codec, zfp_codec  # noqa: E402,F401  (self-register on import)
