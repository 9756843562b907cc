"""Distributed environment (port of ``paddle_tpu/distributed/env.py``).

One process per rank: ``init_parallel_env`` joins this process to a
``torch.distributed`` group, and ``get_rank``/``get_world_size`` are that
group's. The JAX package is a single controller whose ranks are hosts;
here every rank is a process, the same count the mesh has devices.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(*names: str, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value is not None:
            return int(value)
    return default


def _init_method() -> str:
    master = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    if not master:
        raise ValueError(
            "init_parallel_env: a world size above 1 needs a rendezvous: set "
            "PADDLE_MASTER (host:port) or MASTER_ADDR and MASTER_PORT, or "
            "pass store=")
    if ":" not in master:
        master = f"{master}:{os.environ.get('MASTER_PORT', '8475')}"
    return f"tcp://{master}"


def init_parallel_env(backend: Optional[str] = None, store=None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout: Optional[timedelta] = None) -> None:
    """Join this process to the default process group.

    The world size and rank come from the arguments, else from
    ``PADDLE_TRAINERS_NUM``/``PADDLE_TRAINER_ID`` as the JAX package reads
    them, else from torch's ``WORLD_SIZE``/``RANK``. A world of one with no
    ``store`` needs no group, as in the JAX package (a no-op). The
    rendezvous is ``store`` (a ``torch.distributed`` store, e.g. a
    ``FileStore``), else ``PADDLE_MASTER`` (host:port) or
    ``MASTER_ADDR``/``MASTER_PORT``.

    ``backend`` None means ``"nccl"``: each rank drives a card of its own,
    the one numbered by its rank modulo the cards present, made current
    here. ``"gloo"`` is asked for by name: the CPU, and ranks that share
    one card (gloo stages CUDA tensors through the host: a check of
    correctness, not of speed). Calling it again once a group is up does
    nothing."""
    if dist.is_initialized():
        return
    world = world_size if world_size is not None else _env_int(
        "PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    rank = rank if rank is not None else _env_int(
        "PADDLE_TRAINER_ID", "RANK", default=0)
    if world == 1 and store is None:
        return
    if not 0 <= rank < world:
        raise ValueError(f"init_parallel_env: rank {rank} is outside a "
                         f"world of {world}")
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: backend 'nccl' needs CUDA devices and "
                "none is available; pass backend='gloo' for the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, **kw)
    else:
        dist.init_process_group(backend, init_method=_init_method(),
                                rank=rank, world_size=world, **kw)


def is_initialized() -> bool:
    """Whether a process group is up (``init_parallel_env`` made one)."""
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (a :class:`..communication.Group`),
    else in the world; 0 with no process group."""
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else 0


def get_world_size(group=None) -> int:
    """The ranks in ``group``, else in the world; 1 with no process
    group."""
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() else 1
