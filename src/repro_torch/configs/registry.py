"""--arch <id> registry of the configs the port runs.

A copy of ``src/repro/configs/registry.py``: ``_load_all`` imports every
config module the reference has, so ``ASSIGNED`` lists its ten
architectures.
"""

from __future__ import annotations

from .base import Config

_REGISTRY = {}


def register(cfg: Config) -> Config:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> Config:
    import copy
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return copy.deepcopy(_REGISTRY[name])


def names():
    return sorted(_REGISTRY)


def _load_all():
    from . import (mixtral_8x7b, zamba2_1_2b, xlstm_125m, gemma_7b,  # noqa: F401
                   llama3_2_3b, yi_34b, mistral_large_123b, kimi_k2_1t_a32b,
                   qwen2_vl_2b, whisper_medium, ff_tiny)


_load_all()
ASSIGNED = [n for n in names() if n != "ff-tiny"]
