"""Probes which gloo collectives take CUDA tensors, and how fast gloo moves
them, with two ranks sharing the one card.

    python3 tools/gloo_probe.py [MB]
    python3 tools/gloo_probe.py --startup

``--startup`` instead times how long spawned ranks take to come up, for
2 and 4 ranks, with ``GLOO_SOCKET_IFNAME`` unset and set to ``lo``: the
seconds from the parent's spawn to each rank's first line, to its
imports of the port, to ``init_process_group`` and to its first CUDA
tensor.

Spawns two processes (``torch.multiprocessing``, start method ``spawn``)
that join one gloo group through a ``FileStore`` in a temp directory and
both use ``cuda:0``. Each rank tries ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``reduce``,
``broadcast``, list ``all_gather`` and a ``new_group`` all-reduce, on CUDA
and on CPU tensors in f32 and bf16, and checks the values. Then it times
``all_reduce``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
(or all-reduce plus the rank's slice where that is missing) on MB
megabytes of bf16 (default 256) on each device type. Also reports
whether ``Tensor.register_post_accumulate_grad_hook`` exists. Prints one
JSON line and writes ``chiprun_out/gloo_probe.json``; last the card's
name and power limit. Gloo stages CUDA tensors through the host, so its
rates say nothing of NCCL.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2


def _try(fn):
    try:
        ok = fn()
        return "ok" if ok else "wrong values"
    except Exception as e:      # the probe reports every refusal
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _cases(dev, dtype, rank, sub):
    def t(vals):
        return torch.tensor(vals, dtype=dtype, device=dev)

    def all_reduce():
        x = t([rank + 1.0] * 4)
        dist.all_reduce(x)
        return bool((x == 3).all())

    def all_gather_into_tensor():
        out = t([0.0] * 4)
        dist.all_gather_into_tensor(out, t([rank + 1.0] * 2))
        return out.tolist() == [1, 1, 2, 2]

    def reduce_scatter_tensor():
        out = t([0.0] * 2)
        dist.reduce_scatter_tensor(out, t([1.0, 2.0, 3.0, 4.0]))
        return out.tolist() == ([2, 4] if rank == 0 else [6, 8])

    def reduce():
        x = t([rank + 1.0] * 4)
        dist.reduce(x, dst=1)
        return rank != 1 or bool((x == 3).all())

    def broadcast():
        x = t([rank + 5.0] * 4)
        dist.broadcast(x, src=1)
        return bool((x == 6).all())

    def all_gather_list():
        outs = [t([0.0] * 2) for _ in range(W)]
        dist.all_gather(outs, t([rank + 1.0] * 2))
        return [o.tolist() for o in outs] == [[1, 1], [2, 2]]

    def new_group_all_reduce():
        x = t([rank + 1.0] * 4)
        dist.all_reduce(x, group=sub)
        return bool((x == 3).all())

    return {f.__name__: f for f in (all_reduce, all_gather_into_tensor,
                                    reduce_scatter_tensor, reduce, broadcast,
                                    all_gather_list, new_group_all_reduce)}


def _rate(fn, nbytes, reps=3):
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return {"ms": dt * 1e3, "GB_per_s": nbytes / dt / 1e9}


def _timings(dev, mb, works):
    n = mb * 2 ** 20 // 2
    x = torch.ones(n, dtype=torch.bfloat16, device=dev)
    half = torch.empty(n // W, dtype=torch.bfloat16, device=dev)
    out = {"all_reduce": _rate(lambda: dist.all_reduce(x), x.nbytes),
           "all_gather_into_tensor": _rate(
               lambda: dist.all_gather_into_tensor(x, half), x.nbytes)}
    if works["reduce_scatter_tensor"] == "ok":
        out["reduce_scatter_tensor"] = _rate(
            lambda: dist.reduce_scatter_tensor(half, x), x.nbytes)
    else:
        def rs():
            dist.all_reduce(x)
            half.copy_(x.view(W, -1)[dist.get_rank()])
        out["all_reduce + slice"] = _rate(rs, x.nbytes)
    return out


def worker(rank, store_path, mb, q):
    try:
        torch.cuda.set_device(0)
        store = dist.FileStore(store_path, W)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=W)
        sub = dist.new_group([0, 1])
        res = {}
        for dev in ("cuda", "cpu"):
            for dtype in (torch.float32, torch.bfloat16):
                key = f"{dev}/{str(dtype).split('.')[-1]}"
                res[key] = {name: _try(fn) for name, fn in
                            _cases(dev, dtype, rank, sub).items()}
                dist.barrier()
        res["timings"] = {dev: _timings(dev, mb, res[f"{dev}/bfloat16"])
                          for dev in ("cuda", "cpu")}
        res["post_accumulate_grad_hook"] = hasattr(
            torch.Tensor, "register_post_accumulate_grad_hook")
        dist.destroy_process_group()
        q.put((rank, res))
    except Exception:
        q.put((rank, traceback.format_exc()))


def startup_worker(rank, world, store_path, t0, q):
    import time as _t
    out = {"entry": _t.time() - t0}
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch  # noqa: F401
    out["imports"] = _t.time() - t0
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    out["init"] = _t.time() - t0
    torch.cuda.set_device(0)
    torch.ones(1, device="cuda").sum().item()
    out["cuda"] = _t.time() - t0
    dist.barrier()
    dist.destroy_process_group()
    q.put((rank, out))


def startup():
    ctx = mp.get_context("spawn")
    res = {}
    for ifname in (None, "lo"):
        for world in (2, 4):
            if ifname is None:
                os.environ.pop("GLOO_SOCKET_IFNAME", None)
            else:
                os.environ["GLOO_SOCKET_IFNAME"] = ifname
            q = ctx.Queue()
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.time()
                procs = [ctx.Process(target=startup_worker, args=(
                    r, world, os.path.join(tmp, "store"), t0, q))
                    for r in range(world)]
                for p in procs:
                    p.start()
                got = dict(q.get(timeout=300) for _ in range(world))
                for p in procs:
                    p.join(timeout=60)
                joined = time.time() - t0
            key = f"world {world}, GLOO_SOCKET_IFNAME={ifname}"
            res[key] = {"ranks": [got[r] for r in range(world)],
                        "joined": joined}
            print(key, json.dumps(res[key]), flush=True)
    return res


def main():
    if sys.argv[1:] == ["--startup"]:
        startup()
        return
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    if not torch.cuda.is_available():
        sys.exit("gloo_probe: needs a CUDA device")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=worker,
                             args=(r, os.path.join(tmp, "store"), mb, q))
                 for r in range(W)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=600) for _ in range(W))
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in range(W):
        if isinstance(got[r], str):
            print(f"rank {r} failed:\n{got[r]}")
            sys.exit(1)
    print(json.dumps(got[0]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gloo_probe.json"), "w") as f:
        json.dump(got, f, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
