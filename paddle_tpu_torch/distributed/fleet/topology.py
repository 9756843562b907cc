"""Hybrid-parallel topology (port of
``paddle_tpu/distributed/fleet/topology.py``).

The JAX package builds ONE device mesh with the axes [dp, pp, sharding,
sep, mp] and lets XLA emit the collectives of each named axis. Here every
rank is a process: rank ``r`` sits at the row-major position of ``r`` in
an array of the world's ranks shaped (dp, pp, sharding, sep, mp), the
position device ``r`` takes in ``make_mesh``'s reshape, and each axis of
degree above 1 gets one ``torch.distributed`` process group per line of
ranks along it. ``new_group`` is collective, so every rank creates every
line's group, axis by axis in that order.

Rank queries return this process's real coordinates; the JAX package,
a single controller, returns 0 from them.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch.distributed as dist

from ..communication import Group

_AXIS_ORDER = ["dp", "pp", "sharding", "sep", "mp"]


class CommunicateTopology:
    """Axis names and degrees of the rank mesh, and where each rank sits
    in it (pure: no process group)."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or _AXIS_ORDER)
        self._dims = list(dims or [1] * len(self._parallel_names))
        self._world_size = int(np.prod(self._dims))

    def world_size(self):
        return self._world_size

    def get_coord(self, rank: int):
        """Rank ``rank``'s index along each axis, in axis order."""
        return tuple(int(i) for i in np.unravel_index(rank, self._dims))

    def get_rank(self, **coords) -> int:
        """The rank at ``coords`` (axis name -> index; 0 where left out)."""
        return int(np.ravel_multi_index(
            [coords.get(n, 0) for n in self._parallel_names], self._dims))

    def get_comm_list(self, axis_name) -> List[List[int]]:
        """Every line of ranks along ``axis_name``: the ranks that differ
        only in that axis, lines in row-major order of the others."""
        mesh = np.arange(self._world_size).reshape(self._dims)
        axis = self._parallel_names.index(axis_name)
        return np.moveaxis(mesh, axis, -1).reshape(
            -1, self._dims[axis]).tolist()


class HybridCommunicateGroup:
    """This rank's place in the hybrid mesh and one :class:`Group` per
    axis. A mesh of more than one rank needs the process group that
    ``init_parallel_env`` makes, over exactly as many ranks; without it
    this raises ValueError. The port runs dp, sharding, mp and pp, so
    their groups are asked for; the sep queries come with the slice that
    runs it.

    Beside JAX's queries, :meth:`get_data_sharding_group` is the port's
    own: the ranks that share this rank's other coordinates across dp x
    sharding, over which a gradient replicated on them and the loss are
    summed (JAX's GSPMD program sums over the batch axes itself)."""

    def __init__(self, *, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, sep_degree=1):
        degrees = [dp_degree, pp_degree, sharding_degree, sep_degree,
                   mp_degree]
        self._topo = CommunicateTopology(_AXIS_ORDER, degrees)
        total = self.nranks = self._topo.world_size()
        up = dist.is_available() and dist.is_initialized()
        if total > 1 and not up:
            raise ValueError(
                f"a hybrid mesh of {total} ranks ({dict(zip(_AXIS_ORDER, degrees))}) "
                f"needs a process group: call "
                f"paddle_tpu_torch.distributed.init_parallel_env first, one "
                f"process per rank")
        if total > 1 and dist.get_world_size() != total:
            raise ValueError(
                f"a hybrid mesh of {total} ranks needs a world of {total} "
                f"processes; init_parallel_env made {dist.get_world_size()}")
        self.global_rank = dist.get_rank() if total > 1 else 0
        self._coord = dict(zip(_AXIS_ORDER,
                               self._topo.get_coord(self.global_rank)))
        self._groups = {}
        for axis, degree in zip(_AXIS_ORDER, degrees):
            mine = Group(axis, 1, 0, [self.global_rank])
            if degree > 1:
                for ranks in self._topo.get_comm_list(axis):
                    pg = dist.new_group(ranks)
                    if self.global_rank in ranks:
                        mine = Group(axis, degree,
                                     ranks.index(self.global_rank), ranks, pg)
            self._groups[axis] = mine
        self._groups["dp,sharding"] = self._data_sharding_group(degrees)

    def _data_sharding_group(self, degrees):
        """The ranks that differ only along dp and sharding: dp's or
        sharding's own group when only one of them exceeds 1, the world's
        when the plane is every rank, else one ``new_group`` a plane
        (one a coordinate of the other axes), made on every rank in the
        same order."""
        dp, sh = degrees[0], degrees[2]
        if dp == 1 or sh == 1:
            return self._groups["dp" if sh == 1 else "sharding"]
        name = "dp,sharding"
        if dp * sh == self.nranks:
            return Group(name, self.nranks, self.global_rank,
                         list(range(self.nranks)), dist.group.WORLD)
        mesh = np.arange(self.nranks).reshape(degrees)
        planes = np.transpose(mesh, (1, 3, 4, 0, 2)).reshape(
            -1, dp * sh).tolist()
        mine = None
        for ranks in planes:
            pg = dist.new_group(ranks)
            if self.global_rank in ranks:
                mine = Group(name, dp * sh, ranks.index(self.global_rank),
                             ranks, pg)
        return mine

    def get_data_parallel_world_size(self):
        return self._groups["dp"].nranks

    def get_sharding_parallel_world_size(self):
        return self._groups["sharding"].nranks

    def get_model_parallel_world_size(self):
        return self._groups["mp"].nranks

    def get_pipe_parallel_world_size(self):
        return self._groups["pp"].nranks

    def get_data_parallel_rank(self):
        """This process's index along dp (the JAX package, a single
        controller, answers 0)."""
        return self._coord["dp"]

    def get_sharding_parallel_rank(self):
        """This process's index along sharding (0 in the JAX package)."""
        return self._coord["sharding"]

    def get_model_parallel_rank(self):
        """This process's index along mp (0 in the JAX package)."""
        return self._coord["mp"]

    def get_stage_id(self):
        """This process's pipeline stage, its index along pp (0 in the JAX
        package, whose stage is ``lax.axis_index`` inside the program)."""
        return self._coord["pp"]

    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> Group:
        """The line of pp ranks through this rank: its stages in order."""
        return self._groups["pp"]

    def get_data_sharding_group(self) -> Group:
        """The dp x sharding plane through this rank (axis name
        ``"dp,sharding"``), or the dp or sharding group when only one of
        the two degrees exceeds 1."""
        return self._groups["dp,sharding"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank of stage ``stage_id`` on this rank's pp line
        (``kwargs``: other coordinates by axis name, this rank's where
        left out). The JAX package answers ``stage_id``: its ranks are
        devices of one program."""
        coords = {**self._coord, **kwargs, "pp": stage_id}
        return self._topo.get_rank(**coords)

    def topology(self):
        return self._topo
