"""Checkpoint save/load with async writes (port of
``paddle_tpu/distributed/checkpoint/save_load.py``), on one process or
over ranks.

- ``save_state_dict(async_save=True)`` takes an OWNED host snapshot of
  every leaf before it returns (the only part that blocks the training
  loop: a device-to-host copy for a CUDA tensor, a clone for a CPU one,
  whose ``.cpu()``/``.numpy()``/``.detach()`` would be views of storage
  the next in-place AdamW update rewrites) and hands the write to a
  background thread, returning an :class:`AsyncSaveHandle`. The writer
  thread never touches a CUDA tensor.
- ``load_state_dict`` copies each saved leaf INTO the matching tensor of
  the target (``copy_``, cast to the leaf's dtype, on the leaf's device),
  so a train step's tensors and an engine's draft views stay the same
  objects: the port's counterpart of JAX's "reshard onto the current
  sharding".
- Over ranks (a process group of more than one rank, or a ``layout=``)
  both take a :class:`~..layout.Layout`: each rank's tree holds its
  shards, and the directory still holds WHOLE leaves at their global
  shapes, the bytes a one-process save of the gathered state writes.
  Saving is a collective: the coordinator makes ``path.tmp`` with every
  leaf file at full size, each rank writes the regions it is the writer
  of (:meth:`~..layout.Layout.writes`), and once every part is in, the
  coordinator hashes the whole leaves, writes the sidecars and
  publishes. Loading reads on each rank only its slice of each leaf
  under the target layout, whatever layout wrote it. The ranks agree
  through the process group's store (:class:`Ranks`), never through a
  collective of the train step's groups, with a timeout on every wait.

On-disk layout of one checkpoint directory:

- ``arrays/<i>.bin``: leaf ``i`` in flatten order (dict keys sorted, as
  ``jax.tree_util.tree_leaves`` orders them), its raw little-endian bytes;
- ``index.json``: the tree's structure and each leaf's file, shape and
  dtype name (numpy's names; ``"bfloat16"`` for bf16). No pickle;
- ``sharding_meta.json`` (``{"leaf_shardings": [...]}``: null a leaf on
  one process, JAX's ``{"mesh_axes", "mesh_shape", "spec"}`` a leaf over
  ranks) and, with a manifest, ``manifest.json`` (``step``,
  ``leaf_checksums``, ``n_leaves``): the JAX package's sidecars, with the
  same content for the same state. The array payload is the port's own:
  neither side reads the other's arrays.

A Python scalar leaf is saved as the 0-d array ``np.array(v)`` makes (an
int is int64), as the JAX package's snapshot makes it.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import sys
import threading
import traceback
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..._device import resolve_device
from ...testing import faults

__all__ = ["CKPT_WRITE_POINTS", "SYNC_TIMEOUT_S", "AsyncSaveHandle",
           "Ranks", "leaf_checksums", "save_state_dict", "load_state_dict",
           "wait_all_async_saves", "load_manifest", "load_sharding_meta",
           "read_tree", "file_checksums", "LeafFile"]

# The named stages of the write/publish protocol, in order. The crash
# matrix (tests/test_torch_checkpoint_manager.py) kills a save at every
# one of these and asserts CheckpointManager.latest() still resolves a
# complete checkpoint. "after_publish" is past the commit rename: a crash
# there loses nothing but the manager's COMMIT marker.
CKPT_WRITE_POINTS = (
    "ckpt.write.begin",          # before leftover cleanup / any I/O
    "ckpt.write.after_arrays",   # leaf files and index written in tmp
    "ckpt.write.after_meta",     # sharding_meta.json written
    "ckpt.write.after_manifest", # manifest.json (checksums) written
    "ckpt.write.before_publish", # one instant before the commit rename
    "ckpt.write.after_publish",  # tmp renamed to its final name
)

INDEX = "index.json"
ARRAYS = "arrays"

# seconds a rank waits for a peer at any point of a checkpoint collective
# before it raises: a rank that died leaves its peers an error, not a hang
SYNC_TIMEOUT_S = 600.0

# torch dtype -> numpy's name for it; bf16 leaves are stored and hashed as
# their int16 bits (numpy has no bfloat16 without ml_dtypes)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NAMES.items()}


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's little-endian bytes are read back as."""
    return np.dtype("<i2" if name == "bfloat16" else name).newbyteorder("<")


class _Snap:
    """One leaf's owned host snapshot: its bytes as a numpy array (the
    int16 bits for bf16), its dtype name and shape."""
    __slots__ = ("array", "dtype", "shape")

    def __init__(self, array: np.ndarray, dtype: str, shape: Tuple[int, ...]):
        self.array = array
        self.dtype = dtype
        self.shape = shape


def _host_view(v) -> _Snap:
    """A leaf's host bytes WITHOUT a copy where one can be avoided (for
    hashing); :func:`_snapshot` makes the owned copy."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")
        t = t.contiguous()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"checkpoint: unsupported dtype {t.dtype}")
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        return _Snap(a, name, tuple(int(s) for s in t.shape))
    a = np.asarray(v)
    if a.dtype == object or a.dtype.kind in "USV":
        raise TypeError(f"checkpoint: unsupported leaf {type(v).__name__}")
    return _Snap(a, str(a.dtype), tuple(int(s) for s in a.shape))


def _snapshot(v) -> _Snap:
    """An owned host copy of a leaf, complete when this returns: a CUDA
    tensor's blocking device-to-host copy, a CPU tensor's clone, an
    array's copy (``np.array(v)`` for a Python scalar)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        t = t.to("cpu") if t.device.type != "cpu" else t.clone()
        return _host_view(t)
    a = np.array(v, copy=True)
    return _Snap(a, str(a.dtype), tuple(int(s) for s in a.shape))


def _leaf_info(v) -> Tuple[str, Tuple[int, ...]]:
    """A leaf's dtype name and shape, without a copy."""
    if isinstance(v, torch.Tensor):
        name = _NAMES.get(v.dtype)
        if name is None:
            raise TypeError(f"checkpoint: unsupported dtype {v.dtype}")
        return name, tuple(int(s) for s in v.shape)
    a = np.asarray(v)
    if a.dtype == object or a.dtype.kind in "USV":
        raise TypeError(f"checkpoint: unsupported leaf {type(v).__name__}")
    return str(a.dtype), tuple(int(s) for s in a.shape)


def _nbytes(shape, dtype: str) -> int:
    return int(np.prod(shape, dtype=np.int64)) * \
        _storage_dtype(dtype).itemsize


def _is_leaf(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float))


def _flatten(tree, path=""):
    """(structure, leaves): the structure is JSON-able, the leaves in
    ``jax.tree_util.tree_leaves`` order (dict keys sorted, None no leaf)."""
    leaves: List[Any] = []

    def walk(node, p):
        if node is None:
            return {"t": "none"}
        if isinstance(node, dict):
            keys = sorted(node)
            for k in keys:
                if not isinstance(k, str):
                    raise TypeError(
                        f"checkpoint: dict key {k!r} at {p or '<root>'!r} "
                        "is not a string")
            return {"t": "dict", "k": keys,
                    "c": [walk(node[k], f"{p}.{k}" if p else k)
                          for k in keys]}
        if isinstance(node, (list, tuple)):
            return {"t": "tuple" if isinstance(node, tuple) else "list",
                    "c": [walk(v, f"{p}[{i}]") for i, v in enumerate(node)]}
        if _is_leaf(node):
            leaves.append(node)
            return {"t": "leaf", "i": len(leaves) - 1}
        raise TypeError(f"checkpoint: unsupported leaf "
                        f"{type(node).__name__} at {p or '<root>'!r}")

    return walk(tree, path), leaves


def _child_spec(spec, key):
    """The spec subtree under ``key`` (a dict key or a list index): None
    where the spec tree has nothing there."""
    if isinstance(spec, dict):
        return spec.get(key)
    if isinstance(spec, list) and isinstance(key, int) and key < len(spec):
        return spec[key]
    return None


def _flat_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree`` in flatten order, from the spec
    tree ``specs`` (a tuple at a leaf; None for a leaf it has no spec
    for)."""
    out = []

    def walk(node, spec):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], _child_spec(spec, k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, _child_spec(spec, i))
        else:
            out.append(spec if isinstance(spec, tuple) else None)

    walk(tree, specs)
    return out


def leaf_checksums(tree) -> list:
    """Per-leaf CRC32s in flatten order. Each entry folds shape and dtype
    name in first (``repr((shape, dtype))`` with a tuple of Python ints),
    then the leaf's bytes, as the JAX package's, so the same state gives
    the same list on both sides and a truncated or re-typed leaf cannot
    collide with its original."""
    _, leaves = _flatten(tree)
    return [_crc(_host_view(v)) for v in leaves]


def _crc(s: _Snap) -> int:
    crc = zlib.crc32(repr((s.shape, s.dtype)).encode())
    return int(zlib.crc32(_bytes(s.array), crc))


def _bytes(a: np.ndarray) -> memoryview:
    a = np.ascontiguousarray(a)
    if sys.byteorder != "little" and a.dtype.itemsize > 1:
        a = a.byteswap()
    return memoryview(a.reshape(-1).view(np.uint8))


class AsyncSaveHandle:
    """Future-like handle for a background checkpoint write."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self._error: Optional[BaseException] = None

    def started(self) -> bool:
        return self._thread.ident is not None

    def done(self) -> bool:
        # an unstarted thread is not alive, but its write hasn't happened
        # either: "done" means "the write finished", or a manager would
        # GC/commit over a save that never ran
        return self._thread.ident is not None and not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None):
        if self._thread.ident is None:
            raise RuntimeError(
                "checkpoint write thread was never started; the save that "
                "created this handle failed before launching its writer")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in progress")
        if self._error is not None:
            raise self._error


_pending_lock = threading.Lock()
_pending: Dict[str, AsyncSaveHandle] = {}


def wait_all_async_saves():
    """Block until every in-flight async checkpoint write has finished."""
    with _pending_lock:
        handles = list(_pending.values())
    for h in handles:
        h.wait()


def _wait_pending(path: str) -> None:
    with _pending_lock:
        prev = _pending.get(path)
    if prev is not None:
        prev.wait()


class Ranks:
    """The ranks of one checkpoint collective: this process's ``rank`` in
    ``world`` and the ``coordinator``, agreeing through the default
    process group's store (``set``, ``add``, ``wait``). A store call is
    safe from a writer thread while the train step's collectives run on
    the calling thread, under gloo and nccl alike; every wait raises
    TimeoutError after ``timeout`` seconds."""

    def __init__(self, rank: int, world: int, coordinator: int, store,
                 timeout: float):
        self.rank, self.world, self.coordinator = rank, world, coordinator
        self.store, self.timeout = store, timeout

    @classmethod
    def of(cls, process_group=None, coordinator_rank: int = 0,
           timeout: Optional[float] = None) -> Optional["Ranks"]:
        """The ranks of ``process_group`` (a ``torch.distributed`` group;
        None: the world), or None on one process (no group up, or a
        group of one rank)."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        pg = process_group
        world = dist.get_world_size(pg)
        if world == 1:
            return None
        if not 0 <= coordinator_rank < world:
            raise ValueError(f"checkpoint: coordinator_rank "
                             f"{coordinator_rank} is outside a group of "
                             f"{world} ranks")
        return cls(dist.get_rank(pg), world, coordinator_rank,
                   dist.distributed_c10d._get_default_store(),
                   SYNC_TIMEOUT_S if timeout is None else float(timeout))

    @property
    def is_coordinator(self) -> bool:
        return self.rank == self.coordinator

    def set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def get(self, key: str, what: str) -> str:
        """The value at ``key`` once a peer has set it."""
        try:
            self.store.wait([key], timedelta(seconds=self.timeout))
        except Exception as e:      # the store's timeout or a lost peer
            raise TimeoutError(
                f"checkpoint: rank {self.rank} of {self.world} waited "
                f"{self.timeout} s for {what} ({type(e).__name__}: "
                f"{e})") from None
        return self.store.get(key).decode()

    def broadcast(self, key: str, value: Optional[str], what: str) -> str:
        """The coordinator's ``value`` on every rank."""
        if self.is_coordinator:
            self.set(key, value)
            return value
        return self.get(key, what)

    def any(self, key: str, flag: bool, what: str) -> bool:
        """Whether ``flag`` is set on any rank: every rank adds its vote
        and its arrival, the last to arrive opens the gate."""
        self.store.add(f"{key}/votes", int(bool(flag)))
        if self.store.add(f"{key}/n", 1) == self.world:
            self.set(f"{key}/done", "1")
        self.get(f"{key}/done", what)
        return self.store.add(f"{key}/votes", 0) > 0

    def forget(self, key: str) -> None:
        """Delete the keys :meth:`any` made under ``key`` (once every rank
        has read them)."""
        for k in ("votes", "n", "done"):
            try:
                self.store.delete_key(f"{key}/{k}")
            except Exception:
                pass


_calls_lock = threading.Lock()
_calls: Dict[Tuple[str, str], int] = collections.Counter()


def op_key(kind: str, path: str) -> str:
    """The store key prefix of this process's next collective ``kind`` on
    ``path``: the n-th such call gets the same key on every rank, since
    every rank makes the same calls in the same order."""
    path = os.path.abspath(path)
    with _calls_lock:
        _calls[(kind, path)] += 1
        n = _calls[(kind, path)]
    return f"ckpt/{kind}/{n}/{path}"


def _why(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _write_checkpoint(path: str, structure, snaps: List[_Snap], meta,
                      manifest=None):
    tmp = path + ".tmp"
    faults.inject("ckpt.write.begin", dir=path)
    _clear_leftovers(path)
    os.makedirs(os.path.join(tmp, ARRAYS))
    entries = []
    for i, s in enumerate(snaps):
        name = f"{ARRAYS}/{i}.bin"
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(_bytes(s.array))
        entries.append({"file": name, "shape": list(s.shape),
                        "dtype": s.dtype})
    with open(os.path.join(tmp, INDEX), "w") as f:
        json.dump({"format": 1, "tree": structure, "leaves": entries}, f)
    faults.inject("ckpt.write.after_arrays", dir=tmp)
    _publish(path, meta, manifest,
             lambda: [_crc(s) for s in snaps])


def _clear_leftovers(path: str) -> None:
    for leftover in (path + ".tmp", path + ".old"):
        # residue of an earlier crashed save
        if os.path.exists(leftover):
            shutil.rmtree(leftover)


def _publish(path: str, meta, manifest, sums: Callable[[], List[int]]):
    """The sidecars into ``path.tmp``, then the crash-safe publish."""
    tmp, old = path + ".tmp", path + ".old"
    with open(os.path.join(tmp, "sharding_meta.json"), "w") as f:
        json.dump(meta, f)
    faults.inject("ckpt.write.after_meta", dir=tmp)
    if manifest is not None:
        manifest = dict(manifest)
        manifest["leaf_checksums"] = sums = sums()
        manifest["n_leaves"] = len(sums)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        faults.inject("ckpt.write.after_manifest", dir=tmp)
    # crash-safe publish: the previous complete checkpoint is moved aside
    # (rename, not delete) before the new one is renamed in, so a kill at
    # any instant leaves either `path` or `path + ".old"` complete;
    # load_state_dict falls back to ".old" if `path` is missing
    faults.inject("ckpt.write.before_publish", dir=tmp)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    faults.inject("ckpt.write.after_publish", dir=path)
    if os.path.exists(old):
        shutil.rmtree(old)


def _write_region(fname: str, full, region, snap: _Snap) -> None:
    """This rank's slice ``snap`` of a whole leaf of shape ``full`` into
    its region of the leaf's file (made at full size by the
    coordinator): the whole file in one write, or the slice's runs
    through a map of the file."""
    if all(r.start == 0 and r.stop == n for r, n in zip(region, full)):
        with open(fname, "r+b") as f:
            f.write(_bytes(snap.array))
        return
    if snap.array.size == 0:
        return
    mm = np.memmap(fname, dtype=_storage_dtype(snap.dtype), mode="r+",
                   shape=tuple(full))
    mm[region] = snap.array
    del mm


def _write_over_ranks(path: str, structure, infos, snaps, layout, specs,
                      meta, manifest, ranks: Optional[Ranks], key: str,
                      on_complete):
    """A save over ranks (the writer thread of each rank). The
    coordinator clears the leftovers and makes ``path.tmp`` with every
    leaf file at full size and the index, then says ``ready``; each rank
    writes the regions it is the writer of (``snaps[i]`` None: not this
    rank's) and reports its part; once every part is in, the coordinator
    hashes the whole leaf files, writes the sidecars, publishes, runs
    ``on_complete`` and says the ``outcome``, which every other rank
    waits for: each rank's save ends with the same outcome, and a
    failure on any rank publishes nothing."""
    tmp = path + ".tmp"
    files = [os.path.join(tmp, ARRAYS, f"{i}.bin") for i in range(len(infos))]

    def write_mine():
        for f, (_, shape), spec, snap in zip(files, infos, specs, snaps):
            if snap is not None:
                _write_region(f, shape, layout.region(shape, spec), snap)

    if ranks is not None and not ranks.is_coordinator:
        coordinator = f"the coordinator (rank {ranks.coordinator})"
        ready = ranks.get(f"{key}/ready", f"{coordinator} to make {tmp!r}")
        if ready != "ok":
            raise RuntimeError(f"checkpoint save to {path!r} failed on "
                               f"{coordinator}: {ready}")
        part = f"{key}/part/{ranks.rank}"
        try:
            faults.inject("ckpt.write.begin", dir=path)
            write_mine()
            faults.inject("ckpt.write.after_arrays", dir=tmp)
        except BaseException as e:
            ranks.set(part, _why(e))
            raise
        ranks.set(part, "ok")
        outcome = ranks.get(f"{key}/outcome",
                            f"{coordinator} to publish {path!r}")
        if outcome != "ok":
            raise RuntimeError(f"checkpoint save to {path!r} was not "
                               f"published: {outcome}")
        return
    outcome = "ok"
    try:
        try:
            faults.inject("ckpt.write.begin", dir=path)
            _clear_leftovers(path)
            os.makedirs(os.path.join(tmp, ARRAYS))
            for f, (dtype, shape) in zip(files, infos):
                with open(f, "wb") as fh:
                    fh.truncate(_nbytes(shape, dtype))
            entries = [{"file": f"{ARRAYS}/{i}.bin", "shape": list(shape),
                        "dtype": dtype} for i, (dtype, shape) in
                       enumerate(infos)]
            with open(os.path.join(tmp, INDEX), "w") as f:
                json.dump({"format": 1, "tree": structure,
                           "leaves": entries}, f)
        except BaseException as e:
            if ranks is not None:
                ranks.set(f"{key}/ready", _why(e))
            raise
        if ranks is not None:
            ranks.set(f"{key}/ready", "ok")
        mine = None
        try:
            write_mine()
        except BaseException as e:
            mine = e
        bad = []
        # every part is waited for, even after a failure here, so that no
        # rank still writes into this tmp when the outcome is out
        for r in range(ranks.world if ranks is not None else 0):
            if r != ranks.rank:
                try:
                    got = ranks.get(f"{key}/part/{r}",
                                    f"rank {r}'s part of {path!r}")
                except TimeoutError as e:
                    got = str(e)
                if got != "ok":
                    bad.append(f"rank {r}: {got}")
        if mine is not None:
            raise mine
        if bad:
            raise RuntimeError(f"checkpoint save to {path!r}: a rank's "
                               f"part failed ({'; '.join(bad)}); nothing "
                               f"is published")
        faults.inject("ckpt.write.after_arrays", dir=tmp)
        _publish(path, meta, manifest, lambda: file_checksums(
            [(f, shape, dtype) for f, (dtype, shape) in zip(files, infos)]))
        if on_complete is not None:
            on_complete()
    except BaseException as e:
        outcome = _why(e)
        raise
    finally:
        if ranks is not None:
            ranks.set(f"{key}/outcome", outcome)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False,
                    manifest: Optional[Dict[str, Any]] = None,
                    on_complete: Optional[Callable[[], None]] = None,
                    layout=None, timeout: Optional[float] = None):
    """Save `state_dict` (a nested dict/list/tuple of tensors, arrays and
    Python scalars) to `path`. The owned host snapshot is taken now; with
    async_save=True the write runs in a background thread and an
    AsyncSaveHandle is returned. A second save to the same path waits for
    the first (ordering is preserved per path).

    `manifest` (extra fields, e.g. the step number) opts into writing a
    ``manifest.json`` with per-leaf checksums inside the checkpoint before
    publish. `on_complete` runs in the writer thread after a successful
    publish and before the handle resolves (CheckpointManager writes its
    COMMIT marker there, so "handle done without error" implies "marker
    down"). An on_complete failure surfaces on wait() like a write
    failure.

    Over ranks this is a collective: every rank of ``process_group``
    (None: the world) calls it with its local shards and ``layout``, the
    :class:`~..layout.Layout` of its tree (a train step's
    ``step_fn.layout``). Each rank snapshots and writes only the regions
    it is the writer of; ``coordinator_rank`` makes the directory,
    hashes the whole leaves, publishes and alone runs `on_complete`; the
    files are those a one-process save of the gathered tree writes, and
    ``sharding_meta.json`` holds JAX's record of each leaf's spec. Every
    rank's save ends with the same outcome; a rank not heard from within
    `timeout` seconds (:data:`SYNC_TIMEOUT_S`) fails it. A process group
    of more than one rank without a layout raises ValueError: a rank's
    tree holds shards, which are not whole leaves."""
    ranks = Ranks.of(process_group, coordinator_rank, timeout)
    if ranks is not None and layout is None:
        raise ValueError(
            f"save_state_dict: a process group of {ranks.world} ranks is "
            f"up and no layout= was given: each rank's tree holds its "
            f"shards, and writing them as whole leaves would be wrong; "
            f"pass the tree's layout (a train step's step_fn.layout)")
    structure, leaves = _flatten(state_dict)
    path = os.path.abspath(path)
    if layout is None:
        snaps = [_snapshot(v) for v in leaves]  # values at call time
        meta = {"leaf_shardings": [None] * len(snaps)}

        def write():
            _write_checkpoint(path, structure, snaps, meta,
                              manifest=manifest)
            if on_complete is not None:
                on_complete()
    else:
        specs = _flat_specs(state_dict, layout.specs)
        infos = []
        for v, spec in zip(leaves, specs):
            dtype, shape = _leaf_info(v)
            infos.append((dtype, layout.full_shape(shape, spec)))
        # values at call time, of the regions this rank writes only
        snaps = [_snapshot(v) if layout.writes(spec) else None
                 for v, spec in zip(leaves, specs)]
        meta = {"leaf_shardings": [layout.meta(s) for s in specs]}
        key = op_key("save", path) if ranks is not None else ""

        def write():
            _write_over_ranks(path, structure, infos, snaps, layout, specs,
                              meta, manifest, ranks, key, on_complete)

    # a save (sync or async) to a path with an in-flight write must wait:
    # both would otherwise race on the same tmp dir and publish rename.
    # Every save (sync too) registers a handle, and the free slot is
    # RESERVED under the same lock hold that found it free
    handle_box = {}

    def run():
        nonlocal snaps
        try:
            write()
        except BaseException as e:  # surfaced on wait()
            # a kept error's traceback holds these frames: none of them
            # may keep the host copy of the state alive
            traceback.clear_frames(e.__traceback__)
            handle_box["h"]._error = e
        finally:
            snaps = None
            with _pending_lock:
                _pending.pop(path, None)

    thread = threading.Thread(target=run, name=f"ckpt-save:{path}",
                              daemon=True)
    handle = AsyncSaveHandle(thread)
    handle_box["h"] = handle
    while True:
        with _pending_lock:
            prev = _pending.get(path)
            if prev is None:
                # register AND start under one lock hold: a registered
                # handle must be joinable (started) before any concurrent
                # saver can observe it and wait() on it
                _pending[path] = handle
                thread.start()
                break
        try:
            prev.wait()
        except Exception:
            # the previous save's owner receives its failure via that
            # save's own handle; a poisoned predecessor must not abort
            # THIS save: its thread has exited, so the slot is free
            pass
        with _pending_lock:
            # drop a dead handle that is somehow still registered so this
            # loop cannot spin on it
            if _pending.get(path) is prev and prev.done():
                _pending.pop(path, None)
    if not async_save:
        handle.wait()
        return None
    return handle


class LeafFile:
    """One saved leaf, read on demand: ``shape`` and ``dtype`` (numpy's
    name) from the index, :meth:`read` returns an owned CPU tensor of the
    leaf or of a region of it."""
    __slots__ = ("path", "shape", "dtype")

    def __init__(self, path: str, shape, dtype: str):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def numpy(self, region=None) -> np.ndarray:
        """The leaf, or its ``region`` (a slice a dimension: read through
        a map of the file, only the pages it covers), as an owned numpy
        array (bf16 as its int16 bits)."""
        sd = _storage_dtype(self.dtype)
        n = int(np.prod(self.shape, dtype=np.int64))
        if region is None or all(r.start == 0 and r.stop == d
                                 for r, d in zip(region, self.shape)):
            a = np.fromfile(self.path, dtype=sd)   # an owned buffer
            if a.size != n:
                raise ValueError(
                    f"checkpoint leaf {self.path!r}: {a.size} elements on "
                    f"disk, {n} expected for shape {self.shape}")
            return a.reshape(self.shape)
        size = os.path.getsize(self.path) // sd.itemsize
        if size != n:
            raise ValueError(
                f"checkpoint leaf {self.path!r}: {size} elements on disk, "
                f"{n} expected for shape {self.shape}")
        mm = np.memmap(self.path, dtype=sd, mode="r", shape=self.shape)
        out = np.array(mm[region])          # a copy: owned, not the map
        del mm
        return out

    def read(self, region=None) -> torch.Tensor:
        a = self.numpy(region)
        if self.dtype == "bfloat16":
            return torch.from_numpy(a).view(torch.bfloat16)
        if self.dtype not in _TORCH:
            raise TypeError(f"checkpoint leaf {self.path!r}: dtype "
                            f"{self.dtype!r} has no torch counterpart")
        return torch.from_numpy(a)


_CRC_CHUNK = 1 << 26


def _file_crc(fname: str, shape, dtype: str) -> int:
    """:func:`_crc` of a leaf file, read in chunks: its bytes are the
    little-endian bytes the snapshot hashes."""
    shape = tuple(int(s) for s in shape)
    crc = zlib.crc32(repr((shape, dtype)).encode())
    want, got = _nbytes(shape, dtype), 0
    buf = bytearray(min(_CRC_CHUNK, max(want, 1)))
    view = memoryview(buf)
    with open(fname, "rb", buffering=0) as f:
        while True:
            k = f.readinto(buf)
            if not k:
                break
            crc = zlib.crc32(view[:k], crc)
            got += k
    if got != want:
        itemsize = _storage_dtype(dtype).itemsize
        raise ValueError(
            f"checkpoint leaf {fname!r}: {got // itemsize} elements on "
            f"disk, {want // itemsize} expected for shape {shape}")
    return int(crc)


def file_checksums(items) -> List[int]:
    """:func:`_file_crc` of each (file, shape, dtype name), hashed on
    several threads (zlib releases the GIL while it sums)."""
    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1,
                                                   len(items)))) as ex:
        return list(ex.map(lambda it: _file_crc(*it), items))


def _resolve(path: str) -> str:
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.isdir(path + ".old"):
        # a save crashed between moving the old checkpoint aside and
        # publishing the new one: the ".old" copy is the newest complete
        return path + ".old"
    return path


def read_tree(path: str):
    """The saved tree of `path` with :class:`LeafFile` leaves (nothing is
    read but the index). No in-flight-save wait and no ``.old``
    fallback: the caller resolves `path`."""
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    entries = index["leaves"]

    def build(node):
        t = node["t"]
        if t == "dict":
            return {k: build(c) for k, c in zip(node["k"], node["c"])}
        if t in ("list", "tuple"):
            out = [build(c) for c in node["c"]]
            return tuple(out) if t == "tuple" else out
        if t == "leaf":
            e = entries[node["i"]]
            return LeafFile(os.path.join(path, e["file"]), e["shape"],
                            e["dtype"])
        return None

    return build(index["tree"])


def _leaf_files(tree) -> List[LeafFile]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_files(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_files(v)]
    return [tree] if isinstance(tree, LeafFile) else []


def _from_host(saved: torch.Tensor, dtype=None, device="cpu") -> torch.Tensor:
    """A host tensor -> a tensor on `device` that OWNS its memory, always
    a copy: ``torch.from_numpy`` of an array whose buffer belongs to
    someone else (an mmap, ``np.frombuffer``) would let a later in-place
    update write into memory the tensor does not own."""
    return saved.to(device=device, dtype=dtype or saved.dtype, copy=True)


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    device=None, layout=None):
    """Fill `state_dict` in place from `path`: each tensor leaf gets the
    saved values copied into it (``copy_``, cast to its dtype, on its
    device; the same object stays in the tree). Waits for any in-flight
    async save to `path` first, and falls back to ``path + ".old"`` when
    a save crashed between its publish renames.

    Fill rules (the JAX package's): keys of the target that the
    checkpoint lacks keep their values; saved keys the target lacks are
    adopted whole as new tensors on `device` (None means the card, and is
    resolved only when a leaf is adopted); a namedtuple target is rebuilt
    positionally; a sequence length mismatch raises ValueError; a saved
    leaf whose shape differs from its tensor raises ValueError. A
    non-tensor target leaf (a Python scalar, an array) is replaced by the
    saved value as a numpy array (bf16: a CPU tensor).

    With ``layout`` (a :class:`~..layout.Layout`; over ranks it is
    required, and each rank calls this on its own) a tensor leaf holds
    this rank's shard: the whole leaf's shape under its spec must be the
    saved one, else ValueError naming the leaf, and only this rank's
    region of the saved leaf is read, whatever layout and world size
    wrote the directory. Nothing passes between the ranks."""
    world = Ranks.of(process_group, coordinator_rank)
    if world is not None and layout is None:
        raise ValueError(
            f"load_state_dict: a process group of {world.world} ranks is "
            f"up and no layout= was given: each rank's tree holds its "
            f"shards, which a whole saved leaf cannot be copied into; "
            f"pass the tree's layout (a train step's step_fn.layout)")
    path = os.path.abspath(path)
    _wait_pending(path)
    path = _resolve(path)
    restored = read_tree(path)
    adopt_dev = []

    def dev():
        if not adopt_dev:
            adopt_dev.append(resolve_device(device))
        return adopt_dev[0]

    def fill(target, saved, leaf_path="", spec=None):
        if isinstance(saved, LeafFile):
            if isinstance(target, torch.Tensor):
                region = None
                if layout is None:
                    if tuple(target.shape) != saved.shape:
                        raise ValueError(
                            f"checkpoint leaf {leaf_path!r}: saved shape "
                            f"{saved.shape}, target {tuple(target.shape)}")
                else:
                    spec = spec if isinstance(spec, tuple) else None
                    full = layout.full_shape(target.shape, spec)
                    if full != saved.shape:
                        raise ValueError(
                            f"checkpoint leaf {leaf_path!r}: saved shape "
                            f"{saved.shape}, target {full} (this rank "
                            f"holds {tuple(target.shape)} of it under the "
                            f"spec {spec})")
                    region = layout.region(full, spec)
                with torch.no_grad():
                    target.copy_(saved.read(region))
                return target
            if saved.dtype == "bfloat16":
                return saved.read()
            return saved.numpy()
        if isinstance(target, dict) and isinstance(saved, dict):
            for k in target:
                if k in saved:
                    target[k] = fill(target[k], saved[k],
                                     f"{leaf_path}.{k}" if leaf_path else k,
                                     _child_spec(spec, k))
            for k in saved:
                # structure the target hasn't materialized yet is adopted
                if k not in target:
                    target[k] = _adopt(saved[k], dev)
            return target
        if isinstance(target, (list, tuple)) and \
                isinstance(saved, (list, tuple)):
            if len(target) != len(saved):
                raise ValueError(
                    f"checkpoint sequence length mismatch: target has "
                    f"{len(target)} entries, saved has {len(saved)}")
            out = [fill(t, s, f"{leaf_path}[{i}]", _child_spec(spec, i))
                   for i, (t, s) in enumerate(zip(target, saved))]
            if isinstance(target, list):
                target[:] = out
                return target
            if hasattr(target, "_fields"):
                # namedtuples take positional fields, not an iterable
                return type(target)(*out)
            return type(target)(out)
        return _adopt(saved, dev)

    fill(state_dict, restored, "", None if layout is None else layout.specs)
    return state_dict


def _adopt(saved, dev):
    """Restored structure -> the same structure of owned tensors on the
    adopting device."""
    if isinstance(saved, dict):
        return {k: _adopt(v, dev) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        return type(saved)(_adopt(v, dev) for v in saved)
    if isinstance(saved, LeafFile):
        return _from_host(saved.read(), device=dev())
    return saved


def load_manifest(path: str):
    """The checksum manifest written at save time (None when absent or
    unparseable: an unparseable manifest marks the checkpoint incomplete,
    it is never an error here)."""
    p = os.path.join(os.path.abspath(path), "manifest.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_sharding_meta(path: str):
    """The per-leaf sharding metadata recorded at save time (or None),
    in flatten order: one None a leaf of a one-process save, JAX's
    ``{"mesh_axes", "mesh_shape", "spec"}`` (or None) a leaf over
    ranks."""
    p = os.path.join(_resolve(path), "sharding_meta.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
