"""Run a function on W ranks, one process each (``torch.multiprocessing``,
start method ``spawn``), joined by ``init_parallel_env`` through a
``FileStore``.

:func:`spawn` is what the multi-process tests and ``chip_smoke.py`` call;
:func:`train_job` is the rank function of the tests: it lives here, and
imports only torch and the port, so that no rank imports JAX (a function
defined in a test module would import it in every child).

Every join has a time limit: a rank that fails, dies or hangs makes
:func:`spawn` kill every rank and raise.
"""
from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback
import zlib
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


def _rank_main(rank, world, store_path, backend, timeout, fn, args, q):
    import torch.distributed as dist
    try:
        from paddle_tpu_torch.distributed import init_parallel_env
        init_parallel_env(backend, store=dist.FileStore(store_path, world),
                          rank=rank, world_size=world,
                          timeout=timedelta(seconds=timeout))
        q.put((rank, True, fn(rank, world, *args)))
    except BaseException:       # reported to the parent, which fails
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          timeout: float = 120.0, backend: str = "gloo",
          store_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` processes joined by one
    process group (``backend``; a ``FileStore`` in ``store_dir``, else in
    a temp directory), the results in rank order. ``fn`` and ``args``
    must pickle (``fn`` importable by name). Raises RuntimeError with the
    rank's traceback when one fails or dies, TimeoutError when the ranks
    are not done within ``timeout`` seconds; either way every rank is
    killed first."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, backend, timeout, fn,
                                   tuple(args), q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(results))} "
                        f"of {world} not done in {timeout} s")
                try:
                    rank, ok, value = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited ({procs[dead[0]].exitcode})"
                            f" without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                results[rank] = value
        finally:
            for p in procs:
                if len(results) < world:
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [results[r] for r in range(world)]


def flat_tree(tree, prefix=""):
    """{path: float64 numpy} of a tree of tensors (a list of per-layer
    slices stacked)."""
    import torch
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            out[prefix + k] = torch.stack(v).detach().double().numpy()
        else:
            out[prefix + k] = v.detach().double().cpu().numpy()
    return out


def _unflat(flat, dtype):
    import torch
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(a)).to(dtype)
    return tree


def train_job(rank: int, world: int, job: dict) -> dict:
    """The tests' rank function. ``job``: ``config`` (LlamaConfig fields,
    ``dtype`` by name), ``weights`` (an .npz of the full params by path,
    or None for the seeded init), ``batches`` (an .npz of ``ids`` and
    ``labels`` [steps, B, S]) and ``runs``, each ``name`` and
    ``parallel`` (ParallelConfig fields). Every run builds the port's step, loads the weights through
    :func:`shard_train_state` (zero moments), takes the steps and
    gathers the trees; rank 0 writes ``<out>/<name>.npz`` (the losses,
    ``p:<path>`` gathered params). Returns, by run, every rank's losses,
    the CRC32 of each local param leaf, this rank's mesh coordinates and
    groups; and the modules of JAX or of the JAX package this process
    imported. ``checkpoint_dir``: also tries a save and a restore with
    the group up and returns what each raised. ``roundtrip``: also
    shards the weights and a random AdamW state and gathers them back
    under each layout of this world (:func:`_roundtrip`)."""
    import torch
    from paddle_tpu_torch.models import llama as tl
    torch.set_num_threads(2)
    cfg_kw = dict(job["config"])
    cfg = tl.LlamaConfig(**{**cfg_kw, "dtype": getattr(torch,
                                                       cfg_kw["dtype"])})
    batches = np.load(job["batches"])
    weights = dict(np.load(job["weights"])) if job.get("weights") else None
    report = {"runs": {}}
    for run in job["runs"]:
        par = tl.ParallelConfig(**run["parallel"])
        step, p, o = tl.build_train_step(cfg, par, device="cpu")
        if weights is not None:
            full = _unflat(weights, cfg.dtype)
            p, o = tl.shard_train_state(full, tl._adamw_init(full), cfg, par)
        losses = []
        for ids, labels in zip(batches["ids"], batches["labels"]):
            p, o, loss = step(p, o, ids, labels)
            losses.append(float(loss))
        crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                for k, v in flat_tree(p).items()}
        hcg = getattr(step, "hcg", None)
        if hcg is not None:
            p, o = tl.gather_train_state(p, o, cfg, par, hcg=hcg)
        if rank == 0:
            np.savez(os.path.join(job["out"], f"{run['name']}.npz"),
                     losses=np.array(losses),
                     **{f"p:{k}": v for k, v in flat_tree(p).items()})
        topo = {}
        if hcg is not None:
            topo = {"coord": hcg.topology().get_coord(hcg.global_rank),
                    "groups": {
                        "dp": hcg.get_data_parallel_group().ranks,
                        "sharding": hcg.get_sharding_parallel_group().ranks},
                    "axis_ranks": {
                        "dp": (hcg.get_data_parallel_rank(),
                               hcg.get_data_parallel_world_size()),
                        "sharding": (hcg.get_sharding_parallel_rank(),
                                     hcg.get_sharding_parallel_world_size())}}
        report["runs"][run["name"]] = {"losses": losses, "crc": crcs,
                                       **topo}
    if job.get("roundtrip"):
        report["roundtrip"] = _roundtrip(cfg, weights)
    if job.get("checkpoint_dir"):
        report["checkpoint"] = _checkpoint_refusals(job["checkpoint_dir"],
                                                    rank)
    report["jax_modules"] = [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "paddle_tpu")]
    return report


def _roundtrip(cfg, weights):
    """{layout: whether gather_train_state of shard_train_state gave every
    leaf back bitwise}, for the layouts of this world (dp, then sharding
    at stages 1, 2, 3)."""
    import torch
    from paddle_tpu_torch.distributed import get_world_size
    from paddle_tpu_torch.models import llama as tl
    w = get_world_size()
    gen = torch.Generator().manual_seed(3)
    full = _unflat(weights, cfg.dtype)
    opt = tl._adamw_init(full)
    for k in ("m", "v"):
        opt[k] = tl._tree_map(lambda x: torch.randn(x.shape, generator=gen),
                              opt[k])
    out = {}
    for name, par in (("dp", tl.ParallelConfig(dp=w)),
                      *((f"stage{z}", tl.ParallelConfig(sharding=w,
                                                        zero_stage=z))
                        for z in (1, 2, 3))):
        p, o = tl.shard_train_state(full, opt, cfg, par)
        p, o = tl.gather_train_state(p, o, cfg, par)
        got = {**flat_tree(p), **flat_tree({"m": o["m"], "v": o["v"]})}
        want = {**flat_tree(full), **flat_tree({"m": opt["m"],
                                                "v": opt["v"]})}
        out[name] = all(np.array_equal(got[k], want[k]) for k in want)
    return out


def _checkpoint_refusals(root, rank):
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         load_state_dict,
                                                         save_state_dict)
    state = {"w": torch.zeros(4)}
    path = os.path.join(root, f"rank{rank}")
    out = {}
    for what, call in (
            ("save_state_dict", lambda: save_state_dict(state, path)),
            ("load_state_dict", lambda: load_state_dict(state, path)),
            ("CheckpointManager.save",
             lambda: CheckpointManager(path).save(state, 1)),
            ("CheckpointManager.restore",
             lambda: CheckpointManager(path).restore(state))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    out["written"] = sorted(os.path.join(d, f)
                            for d, _, files in os.walk(path) for f in files)
    return out
