"""The lazy config system (executable Python configs)."""
from .lazy import ConfigDict, L, LazyCall, LazyConfig, instantiate, locate

__all__ = ["ConfigDict", "L", "LazyCall", "LazyConfig", "instantiate", "locate"]
