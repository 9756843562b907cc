"""Probes which gloo collectives take CUDA tensors, and how fast gloo moves
them, with two ranks sharing the one card.

    python3 tools/gloo_probe.py [MB]
    python3 tools/gloo_probe.py --startup
    python3 tools/gloo_probe.py --p2p [MB]

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

``--p2p`` probes point-to-point instead: blocking ``send``/``recv``,
``isend``/``irecv`` and a ring hop by ``batch_isend_irecv`` (each rank
sends to rank r+1 mod 2 and receives from r-1), on CUDA and CPU tensors
in f32 and bf16, values checked, each case in its own pair of processes
(a rank that dies on one, e.g. when gloo reads a device pointer from the
host, marks that case and no other); then times a ring hop of MB
megabytes of bf16 (default 256) on CPU tensors, on CUDA tensors where
the cases passed, and on CUDA tensors staged through a host copy on
each side. Writes ``chiprun_out/gloo_probe_p2p.json``.
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


def _p2p_cases(dev, dtype, rank):
    peer = 1 - rank

    def t(vals):
        return torch.tensor(vals, dtype=dtype, device=dev)

    def send_recv():
        if rank == 0:
            dist.send(t([1.0, 2.0, 3.0]), 1)
            return True
        out = t([0.0] * 3)
        dist.recv(out, 0)
        return out.tolist() == [1, 2, 3]

    def isend_irecv():
        out = t([0.0] * 3)
        works = [dist.isend(t([rank + 1.0] * 3), peer),
                 dist.irecv(out, peer)]
        for w in works:
            w.wait()
        return out.tolist() == [peer + 1.0] * 3

    def batch_isend_irecv_ring():
        out = t([0.0] * 4)
        ops = [dist.P2POp(dist.isend, t([rank + 1.0] * 4), (rank + 1) % W),
               dist.P2POp(dist.irecv, out, (rank - 1) % W)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out.tolist() == [(rank - 1) % W + 1.0] * 4

    return {f.__name__: f for f in (send_recv, isend_irecv,
                                    batch_isend_irecv_ring)}


def _hop(x, out, staged):
    """One ring hop of ``x`` into ``out``: direct, or through host copies
    on each side."""
    rank = dist.get_rank()
    src, dst = (x.cpu(), torch.empty_like(out, device="cpu")) if staged \
        else (x, out)
    ops = [dist.P2POp(dist.isend, src, (rank + 1) % W),
           dist.P2POp(dist.irecv, dst, (rank - 1) % W)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        out.copy_(dst)


def p2p_case_worker(rank, store_path, dev, dtype, name, q):
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, W),
                                rank=rank, world_size=W)
        q.put((rank, _try(_p2p_cases(dev, getattr(torch, dtype),
                                     rank)[name])))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        q.put((rank, traceback.format_exc().splitlines()[-1][:200]))


def p2p_time_worker(rank, store_path, mb, forms, q):
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, W),
                                rank=rank, world_size=W)
        n = mb * 2 ** 20 // 2
        out = {}
        for form in forms:
            dev = "cpu" if form == "cpu" else "cuda"
            x = torch.full((n,), rank + 1.0, dtype=torch.bfloat16, device=dev)
            y = torch.empty_like(x)
            rate = _rate(lambda: _hop(x, y, form == "cuda staged"), x.nbytes)
            rate["right"] = bool((y == (rank - 1) % W + 1.0).all())
            out[form] = rate
        dist.destroy_process_group()
        q.put((rank, out))
    except Exception:
        q.put((rank, traceback.format_exc()))


def _pair(target, args, timeout):
    """Run ``target(rank, store, *args, q)`` on two fresh processes;
    {rank: what it put} (a rank that died or hung: its exit code)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, args=(
            r, os.path.join(tmp, "store"), *args, q)) for r in range(W)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < W and time.monotonic() < deadline:
            try:
                r, v = q.get(timeout=1.0)
                got[r] = v
            except Exception:       # queue.Empty: look for dead ranks
                if all(p.exitcode is not None for r, p in enumerate(procs)
                       if r not in got):
                    break
        for r, p in enumerate(procs):
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
            got.setdefault(r, f"died (exit code {p.exitcode})")
    return got


def p2p(mb):
    res = {}
    for dev in ("cuda", "cpu"):
        for dtype in ("float32", "bfloat16"):
            key = f"{dev}/{dtype}"
            res[key] = {}
            for name in _p2p_cases(dev, torch.float32, 0):
                got = _pair(p2p_case_worker, (dev, dtype, name), 60)
                res[key][name] = got[0] if got[0] == got[1] else \
                    {f"rank {r}": v for r, v in got.items()}
            print(key, json.dumps(res[key]), flush=True)
    cuda_ok = all(v == "ok" for d in ("cuda/float32", "cuda/bfloat16")
                  for v in res[d].values())
    forms = ["cpu", "cuda staged"] + (["cuda"] if cuda_ok else [])
    res["ring_hop_timings"] = _pair(p2p_time_worker, (mb, forms), 600)[0]
    res["mb"] = mb
    return res


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
    if sys.argv[1:2] == ["--p2p"]:
        if not torch.cuda.is_available():
            sys.exit("gloo_probe: needs a CUDA device")
        res = p2p(int(sys.argv[2]) if len(sys.argv) > 2 else 256)
        print(json.dumps(res))
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "gloo_probe_p2p.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
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
