from .base import SHAPES, Config, batch_specs, cache_specs
from .registry import ASSIGNED, get, names, register

__all__ = ["SHAPES", "Config", "batch_specs", "cache_specs", "ASSIGNED", "get", "names", "register"]
