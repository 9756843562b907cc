"""Distributed pieces of the port: the process-group environment
(``env``), collectives over one axis of the rank mesh
(``communication``), the hybrid topology (``fleet``), the slicing rule
of a leaf over the rank mesh (``layout``) and the checkpoint layer
(``checkpoint``, on one process or over ranks)."""
from .env import get_rank, get_world_size, init_parallel_env, is_initialized

__all__ = ["get_rank", "get_world_size", "init_parallel_env",
           "is_initialized"]
