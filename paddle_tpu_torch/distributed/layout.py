"""The one slicing rule of the port: how a whole leaf is split over the
rank mesh ``(dp, pp, sharding, sep, mp)``, laid out as JAX's
``make_mesh`` lays out its devices.

A spec is a tuple with one entry a dimension: None (whole), an axis
name, or a tuple of axis names (row-major over them, as a mesh splits a
dimension over several axes). :func:`split_dims` turns a spec into the
(dimension, parts, index) of this rank's slice; the train step's
sharding (``models.llama.shard_train_state``), the serving engine's
sharded swap and the checkpoint layer all slice by it. A
:class:`Layout` is the rule for a whole tree: the axis degrees, this
rank's coordinates and a spec tree. Nothing here imports a model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import env as dist_env

__all__ = ["AXES", "Layout", "split_dims", "local_shape", "shard",
           "mesh_place"]

AXES = ("dp", "pp", "sharding", "sep", "mp")


def split_dims(spec, degrees, coord):
    """(dim, parts, index) of each sharded dimension of ``spec``: it splits
    into ``parts`` equal slices and this rank holds slice ``index``
    (row-major over the entry's axes, as a mesh lays them out)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        parts, index = 1, 0
        for a in ((entry,) if isinstance(entry, str) else entry):
            parts *= degrees[a]
            index = index * degrees[a] + coord[a]
        if parts > 1:
            out.append((d, parts, index))
    return out


def local_shape(name, shape, spec, degrees, coord):
    """A leaf's shape on this rank; a dimension its ranks do not divide
    raises ValueError naming the leaf, where JAX's ``device_put`` of the
    leaf with that sharding raises."""
    shape = list(shape)
    for d, parts, _ in split_dims(spec, degrees, coord):
        if shape[d] % parts:
            raise ValueError(
                f"{name}: dimension {d} of shape {tuple(shape)} does not "
                f"divide over the {parts} ranks of its spec {spec}")
        shape[d] //= parts
    return shape


def shard(x, name, spec, degrees, coord):
    """This rank's slice of the whole leaf ``x``, a contiguous copy (the
    caller's tensor when ``spec`` splits nothing here)."""
    splits = split_dims(spec, degrees, coord)
    if not splits:
        return x
    local_shape(name, x.shape, spec, degrees, coord)
    for d, parts, index in splits:
        n = x.shape[d] // parts
        x = x.narrow(d, index * n, n)
    return x.clone(memory_format=torch.contiguous_format)


def mesh_place(parallel):
    """(degrees, this rank's coordinates) by axis name of a config with
    one attribute an axis (``ParallelConfig``); a mesh of more than one
    rank needs ``init_parallel_env``'s process group over as many
    ranks."""
    degrees = {a: int(getattr(parallel, a)) for a in AXES}
    total = int(np.prod([degrees[a] for a in AXES]))
    world = dist_env.get_world_size()
    if total > 1 and world != total:
        raise ValueError(
            f"{ {a: d for a, d in degrees.items() if d > 1} } needs "
            f"{total} ranks and this process is one of {world}: "
            f"call paddle_tpu_torch.distributed.init_parallel_env in each "
            f"of {total} processes first")
    coord = np.unravel_index(dist_env.get_rank(),
                             [degrees[a] for a in AXES])
    return degrees, {a: int(c) for a, c in zip(AXES, coord)}


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tree of whole leaves lies over the rank mesh: the axis
    ``degrees``, this rank's ``coord`` and ``specs``, a tree of nested
    dicts beside the state's whose leaves are specs. A key the spec tree
    lacks (or None) is a leaf every rank holds whole, with no spec."""
    degrees: Dict[str, int]
    coord: Dict[str, int]
    specs: Any = None

    def splits(self, spec) -> List[Tuple[int, int, int]]:
        return [] if spec is None else split_dims(spec, self.degrees,
                                                  self.coord)

    def full_shape(self, local, spec) -> Tuple[int, ...]:
        """The whole leaf's shape of this rank's ``local`` shape."""
        full = list(local)
        for d, parts, _ in self.splits(spec):
            full[d] *= parts
        return tuple(full)

    def region(self, full, spec) -> Tuple[slice, ...]:
        """This rank's slice of a whole leaf of shape ``full``, one slice
        a dimension."""
        out = [slice(0, n) for n in full]
        for d, parts, index in self.splits(spec):
            n = full[d] // parts
            out[d] = slice(index * n, (index + 1) * n)
        return tuple(out)

    def writes(self, spec) -> bool:
        """Whether this rank is the one that writes its slice of a leaf:
        of the ranks holding the same slice (they differ only on axes the
        spec does not name), the one at coordinate 0 on every other
        axis. Each region of a whole leaf has exactly one writer."""
        named = set()
        for entry in (spec or ()):
            if entry is not None:
                named.update((entry,) if isinstance(entry, str) else entry)
        return all(self.coord[a] == 0 for a in AXES if a not in named)

    def meta(self, spec) -> Optional[Dict[str, Any]]:
        """JAX's per-leaf sharding record (``_leaf_sharding_meta``: the
        mesh's axes and shape and the spec, a list), as it writes it for
        a leaf placed on its mesh with this spec; None for a leaf without
        a spec, as JAX writes for an uncommitted array or a host
        value."""
        if spec is None:
            return None
        return {"mesh_axes": list(AXES),
                "mesh_shape": [self.degrees[a] for a in AXES],
                "spec": [list(p) if isinstance(p, (tuple, list)) else p
                         for p in spec]}
