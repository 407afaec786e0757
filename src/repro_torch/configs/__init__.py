from .base import SHAPES, Config
from .registry import ASSIGNED, get, names, register

__all__ = ["SHAPES", "Config", "ASSIGNED", "get", "names", "register"]
