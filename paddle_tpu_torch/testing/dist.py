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
    ``parallel`` (ParallelConfig fields), and optionally ``env``
    (environment variables set for the run only), ``config`` (LlamaConfig
    fields over the job's), ``weights`` (the run's own .npz) and
    ``grads`` (a pp run: also its gradients before the first step,
    :func:`_pipe_grads`, ``g:<path>`` in the npz). Every run builds the
    port's step, loads the weights through :func:`shard_train_state`
    (zero moments), takes the steps and gathers the trees; rank 0 writes
    ``<out>/<name>.npz`` (the losses, ``p:<path>`` gathered params).
    Returns, by run, every rank's losses, the CRC32 of each local param
    leaf, this rank's mesh coordinates and groups (mp's and pp's), the
    ``tp.``, ``pp.`` and ``comm.`` counters of its steps; and the modules
    of JAX or of the JAX package this process imported.
    ``roundtrip``: also shards the weights and a random AdamW state and
    gathers them back under each layout of this world
    (:func:`_roundtrip`; True: dp and sharding's, or a list of
    ParallelConfig field dicts). ``checkpoint_dir``: also saves that
    state with a ``CheckpointManager`` under two layouts of this world
    and restores each into both (:func:`_checkpoint_roundtrip`)."""
    import torch
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.observability import trace
    torch.set_num_threads(2)
    def config(kw):
        return tl.LlamaConfig(**{**kw, "dtype": getattr(torch, kw["dtype"])})

    def load(path):
        return dict(np.load(path)) if path else None
    cfg = config(job["config"])
    batches = np.load(job["batches"])
    weights = load(job.get("weights"))
    report = {"runs": {}}
    for run in job["runs"]:
        cfg_run = config({**job["config"], **run.get("config", {})})
        w_run = load(run["weights"]) if "weights" in run else weights
        par = tl.ParallelConfig(**run["parallel"])
        saved = {k: os.environ.get(k) for k in run.get("env", {})}
        os.environ.update(run.get("env", {}))
        step, p, o = tl.build_train_step(cfg_run, par, device="cpu")
        if w_run is not None:
            full = _unflat(w_run, cfg_run.dtype)
            p, o = tl.shard_train_state(full, tl._adamw_init(full), cfg_run,
                                        par)
        losses, grads = [], {}
        if run.get("grads"):
            grads = _pipe_grads(step, p, cfg_run, par, batches)
        trace.reset_counters()
        try:
            for ids, labels in zip(batches["ids"], batches["labels"]):
                p, o, loss = step(p, o, ids, labels)
                losses.append(float(loss))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        counters = {k: v for k, v in trace.counters().items()
                    if k.startswith(("tp.", "comm.", "pp."))}
        crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                for k, v in flat_tree(p).items()}
        hcg = getattr(step, "hcg", None)
        if hcg is not None:
            p, o = tl.gather_train_state(p, o, cfg_run, par, hcg=hcg)
        if rank == 0:
            np.savez(os.path.join(job["out"], f"{run['name']}.npz"),
                     losses=np.array(losses),
                     **{f"p:{k}": v for k, v in flat_tree(p).items()},
                     **{f"g:{k}": v for k, v in grads.get("full", {}).items()})
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
                                     hcg.get_sharding_parallel_world_size())},
                    "mp": {"group": hcg.get_model_parallel_group().ranks,
                           "rank": (hcg.get_model_parallel_rank(),
                                    hcg.get_model_parallel_world_size()),
                           "data_group":
                               hcg.get_data_sharding_group().ranks},
                    "pp": {"group": hcg.get_pipe_parallel_group().ranks,
                           "stage": (hcg.get_stage_id(),
                                     hcg.get_pipe_parallel_world_size()),
                           "first": hcg.is_first_stage(),
                           "last": hcg.is_last_stage(),
                           "stage_ranks": [
                               hcg.get_rank_from_stage(i) for i in
                               range(hcg.get_pipe_parallel_world_size())]}}
        report["runs"][run["name"]] = {"losses": losses, "crc": crcs,
                                       "counters": counters,
                                       "grad_crc": grads.get("crc", {}),
                                       **topo}
    if job.get("roundtrip"):
        layouts = job["roundtrip"]
        report["roundtrip"] = _roundtrip(
            cfg, weights, None if layouts is True else layouts)
    if job.get("checkpoint_dir"):
        report["checkpoint"] = _checkpoint_roundtrip(job["checkpoint_dir"],
                                                     cfg, weights)
    report["jax_modules"] = [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "paddle_tpu")]
    return report


def _pipe_grads(step, params, cfg, par, batches) -> dict:
    """A pp train step's gradients on the first batch, before any update:
    ``full``, the whole tree gathered from every rank (JAX's [S, L/S, ...]
    layer layout), and ``crc``, this rank's CRC32 of its embed,
    final_norm and lm_head gradients."""
    import torch
    from paddle_tpu_torch.models import llama as tl
    _, g = step.loss_and_grads(params, *step.local_batch(
        batches["ids"][0], batches["labels"][0]))
    tree = {k: ({n: torch.stack(ts)[None] for n, ts in v.items()}
                if k == "layers" else v) for k, v in g.items()}
    full, _ = tl.gather_train_state(tree, None, cfg, par, hcg=step.hcg)
    return {"full": flat_tree(full),
            "crc": {k: zlib.crc32(np.ascontiguousarray(
                v.detach().numpy()).tobytes())
                for k, v in g.items() if k != "layers"}}


def _roundtrip(cfg, weights, layouts=None):
    """{layout: whether gather_train_state of shard_train_state gave every
    leaf back bitwise}, for ``layouts`` ({name: ParallelConfig fields}),
    by default those of dp and sharding in this world (dp, then sharding
    at stages 1, 2, 3)."""
    from paddle_tpu_torch.distributed import get_world_size
    from paddle_tpu_torch.models import llama as tl
    w = get_world_size()
    full = _unflat(weights, cfg.dtype)
    opt = _random_opt(full)
    if layouts is None:
        layouts = {"dp": dict(dp=w),
                   **{f"stage{z}": dict(sharding=w, zero_stage=z)
                      for z in (1, 2, 3)}}
    out = {}
    for name, kw in layouts.items():
        par = tl.ParallelConfig(**kw)
        p, o = tl.shard_train_state(full, opt, cfg, par)
        p, o = tl.gather_train_state(p, o, cfg, par)
        got = {**flat_tree(p), **flat_tree({"m": o["m"], "v": o["v"]})}
        want = {**flat_tree(tl.stage_layers(full, cfg, par)),
                **flat_tree({k: tl.stage_layers(opt[k], cfg, par)
                             for k in ("m", "v")})}
        out[name] = all(np.array_equal(got[k], want[k]) for k in want)
    return out


def _random_opt(full, seed=3):
    """AdamW state of the full params with seeded random moments (the
    same on every rank) and ``t`` 2."""
    import torch
    from paddle_tpu_torch.models import llama as tl
    gen = torch.Generator().manual_seed(seed)
    opt = tl._adamw_init(full)
    for k in ("m", "v"):
        opt[k] = tl._tree_map(lambda x: torch.randn(x.shape, generator=gen),
                              opt[k])
    opt["t"] = torch.full((), 2.0)
    return opt


def _checkpoint_roundtrip(root, cfg, weights):
    """{"src->dst": whether a ``CheckpointManager`` save over the ranks of
    the weights and a random AdamW state sharded under layout src
    (``step_fn.layout``), restored into a fresh train step's state under
    layout dst, gives every local leaf bitwise what
    ``shard_train_state`` makes under dst}, for src and dst each dp and
    sharding at stage 3 of this world; and ``latest`` and
    ``files``, what the coordinator published under each root."""
    from paddle_tpu_torch.distributed import get_world_size
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.models import llama as tl
    w = get_world_size()
    full = _unflat(weights, cfg.dtype)
    opt = _random_opt(full)
    layouts = {"dp": dict(dp=w), "stage3": dict(sharding=w, zero_stage=3)}
    out = {"latest": {}, "files": {}}
    for name, kw in layouts.items():
        par = tl.ParallelConfig(use_flash=False, **kw)
        step, _, _ = tl.build_train_step(cfg, par, device="cpu")
        p, o = tl.shard_train_state(full, opt, cfg, par)
        mgr = CheckpointManager(os.path.join(root, name), layout=step.layout,
                                timeout=60)
        mgr.save({"params": p, "opt": o, "step": 5}, 5, block=True)
        out["latest"][name] = mgr.latest()
        out["files"][name] = sorted(os.listdir(mgr.step_dir(5)))
    for src in layouts:
        for dst, kw in layouts.items():
            par = tl.ParallelConfig(use_flash=False, **kw)
            step, state, got = tl.restore_train_step(
                cfg, par, CheckpointManager(os.path.join(root, src),
                                            timeout=60), device="cpu")
            want_p, want_o = tl.shard_train_state(full, opt, cfg, par)
            a = {**flat_tree(state["params"]),
                 **flat_tree({k: state["opt"][k] for k in ("m", "v")})}
            b = {**flat_tree(want_p),
                 **flat_tree({k: want_o[k] for k in ("m", "v")})}
            out[f"{src}->{dst}"] = (
                got == 5 and float(state["opt"]["t"]) == 2.0
                and all(np.array_equal(a[k], b[k]) for k in b))
    return out


def elastic_job(rank: int, world: int, job: dict) -> dict:
    """The elastic-resume tests' rank function. ``job``: ``config``
    (LlamaConfig fields, ``dtype`` by name), ``weights`` (an .npz of the
    full params by path), ``batches`` (an .npz of ``ids`` and ``labels``
    [steps, B, S]), ``lr``, ``env`` (set for the job) and ``tasks``, in
    order, each a dict with ``name``, ``kind``, ``parallel``
    (ParallelConfig fields) and ``root`` (a CheckpointManager root):

    - ``train``: the weights with zero moments, every step, ``on_step``
      after each; a blocking save at step ``save_at``, then each fault of
      ``crash`` ((point, rank) pairs: the point armed on that rank only)
      on a save of step ``save_at`` + 1, and ``preempt`` (a rank) asks
      for a preemption after step ``save_at`` + 1; training goes on past
      the ``Preempted``. Returns the losses, each fault's (what this rank's
      save raised, ``latest()`` after it) and the preemption's
      (step, whether its final save was made);
    - ``restore``: ``restore_train_step`` of checkpoint ``step`` (None:
      the newest) under ``parallel`` (and ``config``, LlamaConfig fields
      over the job's), then the steps after it. Returns the restored
      step and the losses, or what the restore raised; with
      ``check_slices`` also the restored leaves whose bits differ from
      their saved slices and how many were compared
      (:func:`restored_mismatches`);
    - ``peers``: a save and a load without a layout (what each raised),
      then a save under ``root`` that rank 1 never joins and a restore
      that rank 0 never joins, with a ``timeout`` of ``wait`` seconds
      (what each raised on the ranks that joined, and the seconds the
      task took).

    Returns {"tasks": {name: result}, "jax_modules"}."""
    import contextlib
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         Preempted)
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.testing import faults
    torch.set_num_threads(2)
    os.environ.update(job.get("env", {}))
    batches = np.load(job["batches"])
    ids, labels = batches["ids"], batches["labels"]
    weights = dict(np.load(job["weights"]))
    out = {}

    def config(kw):
        kw = {**job["config"], **kw}
        return tl.LlamaConfig(**{**kw, "dtype": getattr(torch, kw["dtype"])})

    def run(step, state, start):
        losses = []
        for i in range(start, len(ids)):
            state["params"], state["opt"], loss = step(
                state["params"], state["opt"], ids[i], labels[i])
            losses.append(float(loss))
            state["step"] = i + 1
        return losses

    for task in job["tasks"]:
        cfg = config(task.get("config", {}))
        par = tl.ParallelConfig(use_flash=False, remat=False,
                                **task["parallel"])
        mgr = CheckpointManager(task["root"], keep=3, timeout=60)
        if task["kind"] == "peers":
            out[task["name"]] = _absent_peers(cfg, par, task, rank)
            continue
        if task["kind"] == "restore":
            try:
                step, state, got = tl.restore_train_step(
                    cfg, par, mgr, step=task.get("step"), lr=job["lr"],
                    device="cpu")
            except (ValueError, FileNotFoundError) as e:
                out[task["name"]] = {"raised": f"{type(e).__name__}: {e}"}
                continue
            res = {"restored": got}
            if task.get("check_slices"):
                res["differing"], res["compared"] = restored_mismatches(
                    state, mgr.step_dir(got), step.layout)
            res["losses"] = run(step, state, got)
            out[task["name"]] = res
            continue
        step, _, _ = tl.build_train_step(cfg, par, lr=job["lr"],
                                         device="cpu")
        full = _unflat(weights, cfg.dtype)
        p, o = tl.shard_train_state(full, tl._adamw_init(full), cfg, par)
        state = {"params": p, "opt": o, "step": 0}
        mgr.layout = step.layout
        at = task["save_at"]
        res = {"losses": [], "crash": [], "preempted": None}
        for i in range(len(ids)):
            state["params"], state["opt"], loss = step(
                state["params"], state["opt"], ids[i], labels[i])
            res["losses"].append(float(loss))
            state["step"] = i + 1
            if res["preempted"] is not None:
                continue            # the run goes on unmanaged
            if i + 1 == at + 1 and task.get("preempt") == rank:
                mgr.request_preemption()
            try:
                mgr.on_step(i + 1, lambda: state)
            except Preempted as e:
                res["preempted"] = (e.step, e.checkpoint is not None)
            if i + 1 != at:
                continue
            mgr.save(state, at, block=True)
            for point, who in task.get("crash", []):
                armed = faults.scope(point, "raise", nth=1) \
                    if who == rank else contextlib.nullcontext()
                try:
                    with armed:
                        mgr.save(state, at + 1, block=True)
                    raised = None
                except Exception as e:
                    raised = type(e).__name__
                mgr.wait()
                res["crash"].append((raised, mgr.latest()))
        out[task["name"]] = res
    return {"tasks": out,
            "jax_modules": [m for m in sys.modules
                            if m.split(".")[0] in ("jax", "paddle_tpu")]}


def restored_mismatches(state, path, layout):
    """The leaves of ``state`` (this rank's shards, as restored) whose
    bits differ from their slice of the saved whole leaves under ``path``
    (under ``layout``), read and compared on the host one leaf at a time;
    and the number of leaves compared."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    bad, n = [], 0

    def walk(t, saved, spec, name):
        nonlocal n
        if isinstance(t, dict):
            for k in t:
                walk(t[k], saved[k],
                     spec.get(k) if isinstance(spec, dict) else None,
                     f"{name}/{k}" if name else k)
            return
        if not isinstance(t, torch.Tensor):
            return
        spec = spec if isinstance(spec, tuple) else None
        want = saved.read(layout.region(saved.shape, spec))
        got = t.detach().cpu()
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        n += 1
        if got.shape != want.shape or not torch.equal(got.view(bits),
                                                      want.view(bits)):
            bad.append(name)
    walk(state, sl.read_tree(path), layout.specs, "")
    return bad, n


def _absent_peers(cfg, par, task, rank):
    """The ``peers`` task of :func:`elastic_job`."""
    import time
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.models import llama as tl
    step, p, o = tl.build_train_step(cfg, par, device="cpu")
    state = {"params": p, "opt": o, "step": 0}
    out = {}

    def raised(call):
        try:
            call()
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        return None
    path = os.path.join(task["root"], "no_layout")
    out["save_without_layout"] = raised(lambda: save_state_dict(state, path))
    out["load_without_layout"] = raised(lambda: load_state_dict(state, path))
    t0 = time.monotonic()
    mgr = CheckpointManager(task["root"], layout=step.layout,
                            timeout=task["wait"])
    if rank != 1:
        out["save"] = raised(lambda: mgr.save(state, 1, block=True))
    if rank != 0:
        out["restore"] = raised(lambda: mgr.restore(state))
    out["seconds"] = time.monotonic() - t0
    return out


def pipeline_job(rank: int, world: int, job: dict) -> dict:
    """The pipeline tests' rank function: the world is one pp group of
    ``world`` stages. ``job``: ``inputs`` (an .npz of f32 arrays by case
    name, ``<case>/w`` [S, H, H], ``<case>/b`` [S, H] and ``<case>/x`` [B,
    H]; an interleaved case ``<case>/w`` [S V, H, H] in the round-robin
    layout, rank s's chunks rows s V ... s V + V - 1) and ``cases``, each
    a dict with ``name``, ``microbatches`` and ``overlap`` (True, False
    or None: the env), or ``virtual`` (interleaved), and optionally
    ``env`` (set for the case) and ``composed`` (the loss through
    ``build_pipeline_loss_fn``; no outputs). Each case runs stage
    tanh(h @ w + b) (the interleave: tanh(h @ w)) under remat, the loss
    ``last_stage_value`` of sum(out^2), and backward on every rank.
    Returns {case: the loss, this stage's gradients, the outputs (the
    last stage's), the ``pp.`` counters and this rank's
    ``comm.ppermute.pp`` calls and bytes}, and the modules of JAX or of
    the JAX package this process imported."""
    import torch
    from paddle_tpu_torch.distributed.fleet import HybridCommunicateGroup
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.parallel import pipeline as pl
    torch.set_num_threads(2)
    group = HybridCommunicateGroup(
        pp_degree=world).get_pipe_parallel_group()
    arrays = np.load(job["inputs"])
    out = {}
    for case in job["cases"]:
        name = case["name"]
        saved = {k: os.environ.get(k) for k in case.get("env", {})}
        os.environ.update(case.get("env", {}))
        trace.reset_counters()
        try:
            w = torch.from_numpy(arrays[f"{name}/w"])
            x = torch.from_numpy(arrays[f"{name}/x"])
            m = case["microbatches"]
            if "virtual" in case:
                v = case["virtual"]
                params = w[rank * v:(rank + 1) * v].clone().requires_grad_()
                pipe = pl.pipeline_apply_interleave(
                    lambda p, h: torch.tanh(h @ p), world, v, m, group)
            else:
                b = torch.from_numpy(arrays[f"{name}/b"])
                params = {"w": w[rank:rank + 1].clone().requires_grad_(),
                          "b": b[rank:rank + 1].clone().requires_grad_()}
                pipe = pl.pipeline_apply(
                    lambda p, h: torch.tanh(h @ p["w"] + p["b"]), world, m,
                    group, remat=True, overlap_p2p=case["overlap"])
            if case.get("composed"):    # the same through the loss builder
                outputs = None
                loss = pl.build_pipeline_loss_fn(
                    lambda _e, batch: pl.microbatch(batch, m),
                    lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                    lambda _h, out, _batch: (out ** 2).sum(), world, m,
                    group, overlap_p2p=case["overlap"])(
                        (None, params, None), x)
            else:
                outputs = pipe(params, pl.microbatch(x, m))
                loss = pl.last_stage_value((outputs ** 2).sum(), world,
                                           group)
            loss.backward()
        finally:
            for k, val in saved.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val
        grads = ({"w": params.grad} if "virtual" in case else
                 {k: t.grad for k, t in params.items()})
        out[name] = {
            "loss": loss.detach().numpy(),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "outputs": None if outputs is None else outputs.detach().numpy(),
            "counters": {k: val for k, val in trace.counters().items()
                         if k.startswith(("pp.", "comm.ppermute.pp"))}}
    return {"rank": rank, "cases": out,
            "jax_modules": [m for m in sys.modules
                            if m.split(".")[0] in ("jax", "paddle_tpu")]}


def _numpy_tree(flat):
    """A tree of CPU tensors, each in its array's own dtype, from
    {path: array}."""
    import torch
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(a))
    return tree


def _stacked(tree):
    """A gradient tree with each list of per-layer slices stacked."""
    import torch
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return torch.stack(tree) if isinstance(tree, list) else tree


def moe_job(rank: int, world: int, job: dict) -> dict:
    """The ERNIE-MoE tests' rank function. ``job``: ``config``
    (ErnieMoEConfig fields, ``dtype`` by name), ``weights`` (an .npz of
    the full params by path), ``batches`` (an .npz of ``ids`` and
    ``labels`` [steps, B, S]), ``out`` (rank 0's directory), ``lr`` and
    ``runs``, each ``name``, ``ep`` and ``dp`` (ep x dp must be the
    world), ``flags`` (``build_train_step`` keywords), and optionally
    ``config`` (fields over the job's), ``weights`` and ``batches`` (the
    run's own .npz),
    ``env`` (set for the run only), ``grads`` (also the gradients of the
    first batch before any update, gathered: ``g:<path>``) and
    ``control`` ("local_capacity": each rank routes the capacity path
    with its own rows' capacity, a fault the tests must catch;
    "ep_noise": each rank scales its loss, so its gradients, by
    1 + 1e-3 (rank + 1), as a backward that rounds apart on each rank
    would move them, which the step must not let into the leaves ep does
    not split). Every run
    builds the port's step, loads the weights through
    ``shard_train_state`` (zero moments), takes the steps and gathers the
    params; rank 0 writes ``<out>/<name>.npz`` (``losses``, ``p:<path>``,
    ``g:<path>``). Returns by run every rank's losses, stats (each step's,
    as lists), coordinates, the CRC32 of each local param leaf, and the
    ``moe.``, ``site.`` and ``comm.`` counters of its steps; and the
    modules of JAX or of the JAX package this process imported."""
    import torch
    from paddle_tpu_torch.models import ernie_moe as tm
    from paddle_tpu_torch.observability import trace
    torch.set_num_threads(2)

    def config(kw):
        return tm.ErnieMoEConfig(**{**kw, "dtype": getattr(torch,
                                                           kw["dtype"])})
    report = {"runs": {}}
    for run in job["runs"]:
        batches = np.load(run.get("batches") or job["batches"])
        cfg = config({**job["config"], **run.get("config", {})})
        full = _numpy_tree(dict(np.load(run.get("weights")
                                        or job["weights"])))
        saved = {k: os.environ.get(k) for k in run.get("env", {})}
        os.environ.update(run.get("env", {}))
        patched = None
        if run.get("control") == "local_capacity":
            patched = ("moe_dispatch_combine", tm.moe_dispatch_combine)
            tm.moe_dispatch_combine = lambda *a, dp=None, **kw: patched[1](
                *a, **kw)
        elif run.get("control") == "ep_noise":
            patched = ("moe_loss", tm.moe_loss)

            def noisy(*a, **kw):
                total, aux = patched[1](*a, **kw)
                return total * (1 + 1e-3 * (rank + 1)), aux
            tm.moe_loss = noisy
        try:
            step, _, _ = tm.build_train_step(
                cfg, ep_degree=run["ep"], dp_degree=run["dp"],
                lr=job.get("lr", 1e-3), device="cpu", **run["flags"])
            mesh = step.mesh
            p, o = tm.shard_train_state(
                full, tm._adamw_init(
                    full, run["flags"].get("multi_precision", True)),
                cfg, mesh)
            grads = {}
            if run.get("grads"):
                _, _, g = step.loss_and_grads(p, *step.local_batch(
                    batches["ids"][0], batches["labels"][0]))
                grads = flat_tree(tm.gather_train_state(
                    _stacked(g), None, cfg, mesh)[0])
            trace.reset_counters()
            losses, stats = [], []
            for ids, labels in zip(batches["ids"], batches["labels"]):
                p, o, loss, aux = step(p, o, ids, labels)
                losses.append(float(loss))
                if isinstance(aux, dict):
                    stats.append({k: v.tolist() for k, v in aux.items()})
            counters = {k: v for k, v in trace.counters().items()
                        if k.startswith(("moe.", "site.", "comm."))}
        finally:
            if patched is not None:
                setattr(tm, *patched)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                for k, v in flat_tree(p).items()}
        p, _ = tm.gather_train_state(p, None, cfg, mesh)
        if rank == 0:
            np.savez(os.path.join(job["out"], f"{run['name']}.npz"),
                     losses=np.array(losses),
                     **{f"p:{k}": v for k, v in flat_tree(p).items()},
                     **{f"g:{k}": v for k, v in grads.items()})
        report["runs"][run["name"]] = {
            "losses": losses, "stats": stats, "crc": crcs,
            "coord": mesh.coord, "counters": counters,
            "groups": {"dp": mesh.dp.ranks, "ep": mesh.ep.ranks}}
    report["jax_modules"] = [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "paddle_tpu")]
    return report


def moe_dispatch_job(rank: int, world: int, job: dict) -> dict:
    """The ep dispatch tests' rank function: the world is one ep group.
    ``job``: ``inputs`` (an .npz of f32 arrays by data name, ``<data>/x``
    [T, D], ``<data>/logits`` [T, E], ``<data>/w1`` [E, D, I],
    ``<data>/w2`` [E, I, D], ``<data>/cot`` [T, D]; and for the exchange,
    ``<data>/rows`` [world, R, D] and ``<data>/send_counts`` [world,
    world]), ``k``, ``tile_rows`` and ``cases``, each ``name``, ``data``,
    ``fn`` ("slot_local", "ragged_local", "a2a", "shard_map" or "ragged";
    the first two take every token on every rank, "a2a" and "shard_map"
    rank r's block r of them) and ``kwargs`` (a2a_impl, overlap,
    capacity_factor; for "ragged", ``impl`` and ``peer_rows``). Each
    dispatch case runs this rank's experts (E/world of them) with
    ``return_stats``, then backward of sum(out * cot) + aux. Returns
    {case: out, aux, stats, the gradients of x, logits, w1 and w2 (this
    rank's), the slots (``parallel.moe``'s layout helpers) and the
    ``moe.`` counters}, or for "ragged" ``ragged_all_to_all``'s (out,
    recv_counts), and the modules of JAX or of the JAX package this
    process imported."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.communication import ragged
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.parallel import moe as tmoe
    torch.set_num_threads(2)
    group = comm.Group("ep", world, rank, list(range(world)),
                       dist.group.WORLD)
    arrays = np.load(job["inputs"])
    k, tile = job["k"], job["tile_rows"]
    fns = {"slot_local": tmoe.moe_slot_dispatch_local,
           "ragged_local": tmoe.moe_ragged_dispatch_local,
           "a2a": tmoe.moe_ragged_dispatch_a2a,
           "shard_map": tmoe.moe_shard_map_dispatch}
    out = {}
    for case in job["cases"]:
        kind, kw = case["fn"], dict(case.get("kwargs", {}))

        def arr(name):
            return torch.from_numpy(np.array(arrays[f"{case['data']}/{name}"]))
        trace.reset_counters()
        if kind == "ragged":
            got, recv = ragged.ragged_all_to_all(
                arr("rows")[rank], arr("send_counts")[rank], group,
                kw["peer_rows"], impl=kw["impl"])
            out[case["name"]] = {"out": got.numpy(), "recv": recv.numpy()}
            continue
        x, logits, cot = arr("x"), arr("logits"), arr("cot")
        w1, w2 = arr("w1"), arr("w2")
        E = w1.shape[0]
        el = E // world
        if kind in ("a2a", "shard_map"):
            t = x.shape[0] // world
            x, logits, cot = (a[rank * t:(rank + 1) * t]
                              for a in (x, logits, cot))
        x, logits = x.requires_grad_(), logits.requires_grad_()
        w1 = w1[rank * el:(rank + 1) * el].clone().requires_grad_()
        w2 = w2[rank * el:(rank + 1) * el].clone().requires_grad_()
        if kind in ("slot_local", "shard_map"):
            kw.setdefault("capacity_factor", 1.25)
        else:
            kw["tile_rows"] = tile
        res, aux, st = fns[kind](x, logits, w1, w2, E, group, k=k,
                                 return_stats=True, **kw)
        ((res * cot).sum() + aux).backward()
        with torch.no_grad():
            probs = torch.softmax(logits, dim=-1)
            e_flat = tmoe._top_k(probs, k)[1].reshape(-1)
            T = x.shape[0]
            if kind == "slot_local":
                cap = tmoe.moe_capacity(T, k, E, kw["capacity_factor"])[0]
                slot = tmoe.local_slots(tmoe.topk_route(logits, k, cap)[0],
                                        rank, el * cap)[0]
            elif kind == "ragged_local":
                slot = tmoe.local_ragged_layout(e_flat, rank, el, T, k,
                                                tile)[0]
            elif kind == "a2a":
                slot = tmoe.a2a_layout(e_flat, rank, world, el, T, k,
                                       tile)[0]
            else:
                slot = torch.zeros(0)
        out[case["name"]] = {
            "out": res.detach().numpy(), "aux": float(aux),
            "stats": {n: v.numpy() for n, v in st.items()},
            "grads": {n: t.grad.numpy() for n, t in
                      (("x", x), ("logits", logits), ("w1", w1),
                       ("w2", w2))},
            "slot": slot.numpy(),
            "counters": {n: v for n, v in trace.counters().items()
                         if n.startswith("moe.")}}
    return {"rank": rank, "cases": out,
            "jax_modules": [m for m in sys.modules
                            if m.split(".")[0] in ("jax", "paddle_tpu")]}


def collective_inputs(n: int, t=128, k=32, out=48, ffn=(2, 64, 32, 128),
                      vocab=96, emb_h=32, seed=None) -> dict:
    """Seeded global f32 operands of :func:`collective_job` for an mp
    group of ``n``: (t, k n, out) of the row-parallel product, (t, k,
    out n) of the column-parallel one, [n, t, 8] addends of the bare
    rings, (b, s, H, I) of the FFN, the [vocab, emb_h] table with [b, s]
    ids, [t, vocab] logits with labels, and each case's cotangent
    ``g_<case>``."""
    rng = np.random.RandomState(20 + n if seed is None else seed)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)
    b, s, h, i = ffn
    a = {"x_row": f(t, k * n), "w_row": f(k * n, out),
         "x_col": f(t, k), "w_col": f(k, out * n), "x_rr": f(n, t, 8),
         "ffn_x": f(b, s, h), "ffn_gate": f(h, i) * 0.2,
         "ffn_up": f(h, i) * 0.2, "ffn_down": f(i, h) * 0.2,
         "ids": rng.randint(0, vocab, size=(b, s)).astype(np.int64),
         "table": f(vocab, emb_h), "logits": f(t, vocab) * 3,
         "labels": rng.randint(0, vocab, size=(t,)).astype(np.int64)}
    a.update({"g_rar": f(t, out), "g_rag": f(t, out * n), "g_rr": f(t, 8),
              "g_rg": f(n, t, 8), "g_ffn": f(b, s, h),
              "g_embed": f(b, s, emb_h), "g_ce": f(t)})
    return a


def collective_job(rank: int, world: int, job: dict) -> dict:
    """The collective-matmul tests' rank function: the world is one mp
    group. ``job``: ``inputs`` (an .npz of the GLOBAL operands, f32, as
    :func:`collective_inputs` makes them), ``env`` (set for the job), and
    optionally ``device`` ("cuda": every rank on the current card) and
    ``dtype`` (of the float operands, default float32). Each case runs
    forward and backward on this rank's part of the inputs under the
    loss sum(out * G) (G the npz's ``g_<case>``) and returns {case:
    {"out", "d<arg>"...}} as f32 numpy, every ring beside its blocking
    counterpart (:func:`_collective_cases`); and the modules of JAX or of
    the JAX package this process imported."""
    import torch
    from paddle_tpu_torch.distributed.fleet import HybridCommunicateGroup
    torch.set_num_threads(2)
    os.environ.update(job.get("env", {}))
    dev = torch.device(job.get("device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, job.get("dtype", "float32"))
    group = HybridCommunicateGroup(
        mp_degree=world).get_model_parallel_group()
    arrays = {k: torch.from_numpy(v).to(dev) for k, v in
              np.load(job["inputs"]).items()}
    arrays = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in arrays.items()}
    out = {"rank": group.rank,
           "cases": _collective_cases(arrays, group)}
    out["jax_modules"] = [m for m in sys.modules
                          if m.split(".")[0] in ("jax", "paddle_tpu")]
    return out


def _collective_cases(a, group):
    import torch
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.parallel import collective_matmul as cm
    n, r = group.nranks, group.rank

    def cols(x, dim):
        k = x.shape[dim] // n
        return x.narrow(dim, r * k, k).contiguous()

    def run(name, fn, **inputs):
        leaves = {k: v.clone().requires_grad_(v.is_floating_point())
                  for k, v in inputs.items()}
        y = fn(**leaves)
        (y * a[f"g_{name.split(':')[0]}"]).sum().backward()
        res = {"out": host(y)}
        res.update({f"d{k}": host(t.grad) for k, t in leaves.items()
                    if t.grad is not None})
        return res

    def host(t):
        return t.detach().float().cpu().numpy()

    x_row, w_row = cols(a["x_row"], 1), cols(a["w_row"], 0)
    x_col, w_col = a["x_col"], cols(a["w_col"], 1)
    x_rr = a["x_rr"][r]         # [n, t, c]: rank r's addend
    # one hop: rank r receives rank r - 1's addend
    cases = {"hop": {"out": host(comm.ring_hop(x_rr, group)),
                     "want": host(a["x_rr"][(r - 1) % n])}}
    for c in (1, 4):
        tag = "" if c == 1 else f":chunks{c}"
        cases["rar:ring" + tag] = run(
            "rar", lambda x, w: cm.ring_allreduce_matmul(x, w, group, c),
            x=x_row, w=w_row)
        cases["rag:ring" + tag] = run(
            "rag", lambda x, w: cm.ring_allgather_matmul(
                cm.copy_to_mp(x, group), w, group, c), x=x_col, w=w_col)
        cases["rr:ring" + tag] = run(
            "rr", lambda x: cm.ring_allreduce(x, group, c), x=x_rr)
        cases["rg:ring" + tag] = run(
            "rg", lambda x: cm.ring_allgather(x, group, c), x=x_rr)
    rows, cols_ = tuple(a["x_row"].shape), tuple(a["x_col"].shape)
    plan = cm.plan_row_parallel(rows, tuple(a["w_row"].shape), group)
    cases["rar:plan"] = run("rar", plan, x=x_row, w=w_row)
    plan = cm.plan_column_parallel(cols_, tuple(a["w_col"].shape), group)
    cases["rag:plan"] = run("rag", plan, x=x_col, w=w_col)
    cases["rar:blocking"] = run(
        "rar", lambda x, w: cm.blocking_allreduce_matmul(x, w, group),
        x=x_row, w=w_row)
    cases["rag:blocking"] = run(
        "rag", lambda x, w: cm.blocking_allgather_matmul(
            cm.copy_to_mp(x, group), w, group), x=x_col, w=w_col)
    cases["rr:blocking"] = run(
        "rr", lambda x: cm.reduce_from_mp(x, group), x=x_rr)
    cases["rg:blocking"] = run(
        "rg", lambda x: cm.gather_from_mp(x[None], 0, group), x=x_rr)

    ffn = dict(x=a["ffn_x"], gate=cols(a["ffn_gate"], 1),
               up=cols(a["ffn_up"], 1), down=cols(a["ffn_down"], 0))
    plan = cm.plan_fused_ffn(tuple(a["ffn_x"].shape),
                             tuple(a["ffn_gate"].shape),
                             tuple(a["ffn_down"].shape), group, n_cols=2,
                             activation=cm.swiglu)
    cases["ffn:ring"] = run(
        "ffn", lambda x, gate, up, down: plan(x, (gate, up), down), **ffn)

    def ffn_blocking(x, gate, up, down):
        xm = cm.copy_to_mp(x, group)
        return cm.reduce_from_mp(cm.swiglu(xm @ gate, xm @ up) @ down, group)
    cases["ffn:blocking"] = run("ffn", ffn_blocking, **ffn)

    ids, table = a["ids"], cols(a["table"], 0)
    cfg = tl.LlamaConfig(dtype=torch.float32)
    plan = cm.plan_vocab_parallel_embedding(tuple(ids.shape),
                                            tuple(a["table"].shape), group)
    cases["embed:ring"] = run("embed", lambda table: plan(ids, table),
                              table=table)
    cases["embed:blocking"] = run(
        "embed", lambda table: tl.vocab_parallel_embed(table, ids, cfg,
                                                       group), table=table)

    logits, labels = cols(a["logits"], 1), a["labels"]
    plan = cm.plan_parallel_cross_entropy(tuple(a["logits"].shape), group)
    cases["ce:ring"] = run("ce", lambda logits: plan(logits, labels),
                           logits=logits)
    cases["ce:blocking"] = run(
        "ce", lambda logits: tl._VocabParallelCE.apply(logits.float(),
                                                       labels, group),
        logits=logits)
    # the picked logit: each rank's masked pick, summed by the gather
    # ring the plan uses (one non-zero addend a row)
    vs = logits.shape[1]
    loc = labels.long() - r * vs
    ok = (loc >= 0) & (loc < vs)
    mine = torch.where(ok, logits.gather(1, torch.where(ok, loc, 0)[:, None])
                       [:, 0], logits.new_zeros(()))
    cases["picked"] = {"out": host(cm.ring_allgather(mine, group).sum(0))}
    return cases


def serve_tp_job(rank: int, world: int, job: dict) -> dict:
    """The tensor-parallel serving tests' rank function: the world is one
    mp group. ``job``: ``config`` (LlamaConfig fields, ``dtype`` by
    name), ``weights`` (an .npz of the FULL params by path), optionally
    ``device`` ("cuda": every rank on the current card), ``env`` (set for
    the job) and ``cases``, each a dict with ``name`` and ``kind``:

    - ``run``: an engine of ``serve`` (ServeConfig fields) over ``trace``
      (Request fields), deterministic; ``env`` and ``config`` (LlamaConfig
      fields over the job's, with its own ``weights``) for this case
      only;
    - ``swap``: as ``run``, with ``swap_weights(source, at_iteration)``
      first, ``source`` "tree" (the full params) or a directory;
    - ``crash``: ``serve`` with the journal ``journal`` and a swap of the
      full tree at ``swap_at``, killed by fault ``point`` at its ``nth``
      hit, recovered by a fresh engine on the same journal and driven to
      the end (the unjournaled requests resubmitted);
    - ``steps``: one decode step, one prefill chunk and one verify step
      on the inputs of the .npz ``inputs`` (full pools: each rank takes
      its kv heads), in the pools' dtype and, with ``int8``, over int8
      pools (``kinds``: only those of the three); returns the gathered
      logits (verify: also out, commit_len, fin_ok) and this rank's pools
      after each.

    Returns {"rank", "cases": {name: result}, "jax_modules"}; a result
    holds numpy arrays and plain Python values."""
    import torch
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.observability import trace
    torch.set_num_threads(2)
    os.environ.update(job.get("env", {}))
    dev = torch.device(job.get("device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False

    def model(case):
        kw = {**job["config"], **case.get("config", {})}
        cfg = tl.LlamaConfig(**{**kw, "dtype": getattr(torch, kw["dtype"])})
        flat = np.load(case.get("weights", job["weights"]))
        params = _unflat(dict(flat), cfg.dtype)
        return cfg, tl._tree_map(lambda t: t.to(dev), params)

    out = {}
    for case in job["cases"]:
        saved = {k: os.environ.get(k) for k in case.get("env", {})}
        os.environ.update(case.get("env", {}))
        trace.reset_counters()
        try:
            out[case["name"]] = _serve_case(case, *model(case), dev)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[case["name"]]["counters"] = {
            k: v for k, v in trace.counters().items()
            if k.startswith(("comm.", "serve.tp_ring", "site.serve.tp_ring"))
            and not k.endswith(".ms")}
    return {"rank": rank, "cases": out,
            "jax_modules": [m for m in sys.modules
                            if m.split(".")[0] in ("jax", "paddle_tpu")]}


def _engine_report(eng) -> dict:
    st = eng.stats()
    return {"streams": {s.req.request_id: list(s.generated)
                        for s in eng.finished},
            "events": [list(e) for e in eng.events],
            "outcomes": eng.outcomes(),
            "stats": {k: st[k] for k in (
                "mp", "pool_bytes_per_rank", "unfinished", "weight_swaps")},
            "compiles": sorted(st["compiles"]),
            "used_blocks": eng.pool.used_blocks}


def _serve_case(case, cfg, params, dev):
    import torch
    from paddle_tpu_torch.inference import (InferenceEngine, Request,
                                            ServeConfig)
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.testing import faults
    kind = case["kind"]
    if kind == "steps":
        return _tp_steps(case, cfg, params, dev)

    def requests():
        return [Request(**r) for r in case["trace"]]

    def engine(**kw):
        return InferenceEngine(params, cfg, ServeConfig(**case["serve"]),
                               record_events=True, device=dev, **kw)
    if kind == "run":
        eng = engine()
        eng.run(requests(), deterministic=True)
        return _engine_report(eng)
    if kind == "swap":
        eng = engine()
        src = (tl._tree_map(torch.clone, params) if case["source"] == "tree"
               else case["source"])
        eng.swap_weights(src, at_iteration=case["at_iteration"])
        eng.run(requests(), deterministic=True)
        rep = _engine_report(eng)
        rep["last_swap"] = {k: eng.last_swap[k] for k in (
            "in_flight_running", "in_flight_prefill", "n_leaves")}
        rep["shapes"] = {k: tuple(eng.params[k].shape)
                         for k in ("embed", "lm_head")}
        return rep
    # crash: the journal matrix point
    path = case["journal"]
    eng = engine(journal=path)
    eng.swap_weights(tl._tree_map(torch.clone, params),
                     at_iteration=case["swap_at"])
    reqs = requests()
    with faults.scope(case["point"], "raise", nth=case["nth"]) as plan:
        try:
            eng.run(reqs, deterministic=True)
            raised = None
        except faults.FaultError as e:
            raised = repr(e)
        fired, leaked = plan.fired, eng.pool.used_blocks
        eng2 = engine(journal=path)
        rec = eng2.recover()
        journaled = ({s.req.request_id for s in eng2.waiting}
                     | {s.req.request_id for s in eng2.finished})
        eng2.run([Request(r.prompt, max_new_tokens=r.max_new_tokens,
                          request_id=r.request_id)
                  for r in reqs if r.request_id not in journaled],
                 deterministic=True)
    rep = _engine_report(eng2)
    rep.update(raised=raised, fired=fired, leaked=leaked,
               torn=rec["torn_lines"])
    return rep


def _tp_steps(case, cfg, params, dev):
    """One decode step, prefill chunk and verify step at mp = world over
    this rank's shards of ``params`` and of the full pools in
    ``case["inputs"]``."""
    import torch
    from paddle_tpu_torch.inference.engine import serving_group
    from paddle_tpu_torch.models import llama as tl
    tp = serving_group(int(case["mp"]))
    shards = tl.shard_for_serving(params, cfg, tp)
    a = {k: torch.from_numpy(np.array(v)).to(dev)
         for k, v in np.load(case["inputs"]).items()}
    n, r = tp.nranks, tp.rank
    hd = cfg.head_dim

    def heads(pool, per):
        k = pool.shape[2] // n
        assert k % per == 0
        return pool[:, :, r * k:(r + 1) * k].clone()

    def host(t):    # a copy: the pools are written in place later
        return t.detach().cpu().clone().numpy()
    res = {}
    for quant in ((False, True) if case.get("int8") else (False,)):
        tag = "int8" if quant else "fp"
        if quant:
            pools = [heads(a["kq"], hd), heads(a["vq"], hd),
                     heads(a["ks"], 1), heads(a["vs"], 1)]
        else:
            pools = [heads(a["k"], hd), heads(a["v"], hd)]

        def call(fn, *args):
            kw = {"tp": tp}
            if quant:
                kw["kv_scales"] = (pools[2], pools[3])
            got = fn(shards, pools[0], pools[1], *args, cfg, **kw)
            pools[:] = got[-len(pools):]
            return got[:-len(pools)]
        kinds = case.get("kinds", ("decode", "prefill", "verify"))
        logits, = call(tl.llama_paged_decode_step, a["tables"],
                       a["positions"], a["ids"])
        res[f"{tag}/decode/logits"] = host(logits)
        res[f"{tag}/decode/pools"] = [host(p) for p in pools]
        if "prefill" not in kinds:
            continue
        logits, = call(tl.llama_paged_prefill_chunk, a["table_row"],
                       int(a["start"]), a["chunk_ids"], int(a["n_live"]))
        res[f"{tag}/prefill/logits"] = host(logits)
        res[f"{tag}/prefill/pools"] = [host(p) for p in pools]
        logits = tl._tp_gather_logits(tl._verify_logits(
            shards, pools[0], pools[1], a["vtables"], a["qstart"],
            a["fed"], cfg, (pools[2], pools[3]) if quant else None,
            tp)[0], tp)
        res[f"{tag}/verify/logits"] = host(logits)
        got = call(tl.llama_paged_verify_step, a["vtables"], a["qstart"],
                   a["t_live"], a["fed"])
        res[f"{tag}/verify/out"] = [host(t) for t in got]
        res[f"{tag}/verify/pools"] = [host(p) for p in pools]
    return res
