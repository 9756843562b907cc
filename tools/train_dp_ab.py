"""Times chip_smoke.py's train-dp phase of two trees on one card.

    python3 tools/train_dp_ab.py BEFORE AFTER

BEFORE and AFTER are directories that each hold a ``chip_smoke.py`` and
a ``paddle_tpu_torch/`` package, for example a ``git archive`` of the
parent commit unpacked into a git-ignored directory, and ``.``. Each
tree runs its own ``train_dp`` in a process of its own (its RMSNorm,
flash and grouped-matmul kernels built there first; a tree without the
ERNIE runs builds the last for nothing), in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the machine over the call shows. Prints each
run's phase seconds and, where the tree has it, its ``elastic`` line
(the checkpoint's save and restore seconds), the card's name and power
limit, and writes every run's record to ``chiprun_out/train_dp_ab.json``.
train-dp's ranks share the card over gloo, which stages every
collective through the host: its seconds move with the host's load.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree):
    """One train-dp run of ``tree`` in this process; prints its record as
    the last line."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    cs.probe()
    _build.build_all(["rms_norm", "flash_attention", "grouped_matmul"])
    t0 = time.perf_counter()
    res = cs.train_dp(torch.device("cuda", 0))
    secs = time.perf_counter() - t0
    print(json.dumps({"tree": tree, "seconds": secs,
                      "elastic": res.get("elastic"),
                      "worlds": {k: v for k, v in res.items()
                                 if k.startswith("world")}}, default=str))


def main(before, after):
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in (before, after, after, before):
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True,
                             text=True)
        if out.returncode:
            sys.exit(f"train-dp of {tree} failed ({out.returncode}):\n"
                     f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(rec)
        print(f"{tree}: train-dp {rec['seconds']:.1f} s; elastic "
              f"{rec['elastic']}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_dp_ab.json"),
              "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    if sys.argv[1] == "--one":
        one(sys.argv[2])
    else:
        main(*sys.argv[1:3])
