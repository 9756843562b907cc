"""``paddle.nn`` surface of the port (so far: ``nn.functional``'s
attention)."""
from . import functional

__all__ = ["functional"]
