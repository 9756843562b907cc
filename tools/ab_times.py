"""Times kernels of two trees side by side on one card.

    python3 tools/ab_times.py BEFORE AFTER             # rows 24, 25, 26
    python3 tools/ab_times.py --varlen BEFORE AFTER    # rows 22, 23; 20, 21

BEFORE and AFTER are directories that each hold a ``paddle_tpu_torch/``
package, for example a ``git archive`` of the parent commit unpacked
into a git-ignored directory, and ``.``. Each tree runs in a process of
its own (its kernels build there), in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the card over the call shows. Times are
device ms per call with the calls queued ahead (chip_smoke.py's
``_time_ms``), in bf16, on one ERNIE MoE layer's schedule (16,384 routed
rows of 32 experts, chip_smoke's ``_slice_schedule``) at (K, N) =
(1024, 512) and (512, 1024):

  gmm_fwd (row 24), gmm_dx (row 25)
  gmm_dw (row 26)   a control where both trees hold the same kernel

Each run also gives the forward's and dX's drift along a product summed
in f64, kernel and plain version (chip_smoke's ``gmm_drifts``, taken from
this checkout's chip_smoke.py whatever the tree).

With --varlen, the packed varlen kernels at chip_smoke's varlen shapes
(32 heads x 128, bf16, causal self-attention, ``varlen_times``' inputs):

  varlen_bwd_dkv (row 22), varlen_bwd_dq (row 23)   at the long pack
  varlen_fwd (row 20) at the long pack, varlen_bwd (row 21) at the short
  pack: controls where both trees hold the same kernel

and the drift of rows 22 and 23 along a product summed in f64
(chip_smoke's ``varlen_split_drifts``, four heads of the long pack).

Needs one CUDA device and nvcc; prints one JSON line per run, the card's
name and power limit first, and writes chiprun_out/ab_times.json (or
ab_times_varlen.json).
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(tree):
    """In a tree's process: every time and drift, as one JSON line."""
    import torch
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert tg.__file__.startswith(tree), tg.__file__
    _build.build_all(["grouped_matmul"])
    dev = torch.device("cuda", 0)
    out = {}
    counts, n_rows, sched = chip_smoke._slice_schedule(dev)
    e = counts.shape[0]
    for k, n in chip_smoke.MOE_SHAPES:
        lhs, rhs, dout = chip_smoke._gmm_operands(dev, torch.bfloat16,
                                                  n_rows, e, k, n, 0)
        key = f"[K={k},N={n}]"
        for name, fn in (
                ("gmm_fwd", lambda: tg.gmm_fwd(lhs, rhs, sched)),
                ("gmm_dx", lambda: tg.gmm_dx(dout, rhs, sched)),
                ("gmm_dw", lambda: tg.gmm_dw(lhs, dout, sched,
                                             num_experts=e))):
            out[name + key] = chip_smoke._time_ms(fn, 50)[0]
        del lhs, rhs, dout
    drifts = {key: {"kernel": dk, "plain": dp}
              for key, (dk, dp) in chip_smoke.gmm_drifts(tg, dev).items()}
    print(json.dumps({"tree": tree, "ms": out, "drift": drifts}))


def run_one_varlen(tree):
    """In a tree's process: the varlen times and drifts, as one JSON line."""
    import torch
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_varlen as fv
    assert fv.__file__.startswith(tree), fv.__file__
    _build.build_all(["flash_varlen"])
    dev = torch.device("cuda", 0)
    h, d, scale = cs.VARLEN_H, cs.VARLEN_D, cs.VARLEN_D ** -0.5
    out, drifts = {}, None
    for pack, lens in (("short", cs.VARLEN_SHORT), ("long", cs.VARLEN_LONG)):
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, h,
                                        d, cs.SEED + 60)
        cu = cs._cu_dev(lens, dev)
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        o, lse = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        delta = (doh.float() * o.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        if pack == "short":
            calls = {"varlen_bwd": lambda: fv.varlen_bwd(*args)}
        else:
            calls = {"varlen_fwd": lambda: fv.varlen_fwd(qh, kh, vh, cu, cu,
                                                         True, scale),
                     "varlen_bwd_dkv": lambda: fv.varlen_bwd_dkv(*args),
                     "varlen_bwd_dq": lambda: fv.varlen_bwd_dq(*args)}
        for name, fn in calls.items():
            out[f"{name}[{pack} pack]"] = cs._time_ms(fn, 20)[0]
        if pack == "long":
            drifts = {n: {kk: x[kk] for kk in ("kernel", "plain", "excess")}
                      for n, x in cs.varlen_split_drifts(fv, q, k, v, do,
                                                         lens).items()}
        del q, k, v, do, o, args
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": out, "drift": drifts}))


def main():
    varlen = sys.argv[1:2] == ["--varlen"]
    if varlen:
        del sys.argv[1]
    before, after = (os.path.realpath(p) for p in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    runs = []
    for tree in (before, after, after, before):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one-varlen" if varlen else "--one", tree],
                           capture_output=True, text=True)
        if p.returncode != 0:
            sys.exit(f"{tree}: exit {p.returncode}\n{p.stderr[-4000:]}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "ab_times_varlen.json" if varlen else "ab_times.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    elif sys.argv[1:2] == ["--one-varlen"]:
        run_one_varlen(sys.argv[2])
    else:
        main()
