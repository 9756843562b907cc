"""Times rows 14 and 26 of two trees side by side on one card.

    python3 tools/ab_times.py BEFORE AFTER

BEFORE and AFTER are directories that each hold a ``paddle_tpu_torch/``
package, for example a ``git archive`` of the parent commit unpacked
into a git-ignored directory, and ``.``. Each tree runs in a process of
its own (its kernels build there), in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the card over the call shows. Times are
device ms per call with the calls queued ahead (chip_smoke.py's
``_time_ms``), in bf16:

  flash_fwd (row 14)  causal: BH 128, S 2048, D 128 (the train phase);
                      BH 8, S 16384, D 128 (row 13's shape, attn-long);
                      BH 128, S 512, D 64 (the ERNIE phase)
  flash_bwd (row 16)  BH 128, S 2048, D 128, causal (a control: the
                      same kernel in both trees)
  gmm_dw (row 26)     one ERNIE MoE layer's schedule (16,384 routed rows
                      of 32 experts) at (K, N) = (1024, 512), (512, 1024)

Needs one CUDA device and nvcc; prints one JSON line per run, the card's
name and power limit first, and writes chiprun_out/ab_times.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = [(128, 2048, 128, 20), (8, 16384, 128, 10), (128, 512, 64, 50)]


def run_one(tree):
    """In a tree's process: every time, as one JSON line."""
    import torch
    sys.path.insert(0, tree)
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert fa.__file__.startswith(tree), fa.__file__
    _build.build_all(["flash_attention", "grouped_matmul"])
    dev = torch.device("cuda", 0)
    out = {}

    def t(fn, iters):
        return chip_smoke._time_ms(fn, iters)[0]

    for bh, s, d, iters in FWD:
        qs, k, v, do = chip_smoke._flash_inputs(bh, s, d, torch.bfloat16, 0,
                                                dev)
        key = f"[BH={bh},S={s},D={d}]"
        out["flash_fwd" + key] = t(lambda: fa.flash_fwd(qs, k, v, True),
                                   iters)
        if (bh, s, d) == (128, 2048, 128):
            o, lse = fa.flash_fwd(qs, k, v, True)
            delta = (do.float() * o.float()).sum(-1)
            args = (qs, k, v, do, lse, delta, True, d ** -0.5)
            out["flash_bwd" + key] = t(lambda: fa.flash_bwd(*args), iters)
            del o, lse, delta, args
        del qs, k, v, do
        torch.cuda.empty_cache()
    counts, n_rows, sched = chip_smoke._slice_schedule(dev)
    for k, n in chip_smoke.MOE_SHAPES:
        lhs, _, dout = chip_smoke._gmm_operands(dev, torch.bfloat16, n_rows,
                                                32, k, n, 0)
        out[f"gmm_dw[K={k},N={n}]"] = t(
            lambda: tg.gmm_dw(lhs, dout, sched, num_experts=32), 50)
    print(json.dumps({"tree": tree, "ms": out}))


def main():
    before, after = (os.path.realpath(p) for p in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    runs = []
    for tree in (before, after, after, before):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree], capture_output=True, text=True)
        if p.returncode != 0:
            sys.exit(f"{tree}: exit {p.returncode}\n{p.stderr[-4000:]}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_times.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main()
