"""Runs chip_smoke.py's ERNIE-MoE runs over ranks alone, on one card.

    python3 tools/moe_dp_runs.py

The train-dp phase of chip_smoke.py runs ERNIE's ``build_train_step``
over ep and dp ranks (MOE_DP_RUNS) after its Llama runs, in the same
spawns. This script runs only the ERNIE part, through chip_smoke's own
functions: the single process's references (``moe_dp_references``),
one spawn of 2 ranks and one of 4 on ``cuda:0`` over gloo
(``moe_dp_rank_runs``) and the checks (``_moe_dp_checks``), with the
RMSNorm, flash and grouped-matmul kernels built first. Prints the checks'
lines, the card's name and power limit, and writes the record to
``chiprun_out/moe_dp_runs.json``; exits 1 if a check failed.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_runs(rank, world, dev, refs, grads):
    import torch
    import chip_smoke as cs
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cs.moe_dp_rank_runs(world, dev, refs, grads)
    refs.clear()
    grads.clear()
    return out


def main():
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.testing.dist import spawn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    cs.probe()
    _build.build_all(["rms_norm", "flash_attention", "grouped_matmul"])
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    refs, grads, control = cs.moe_dp_references(dev)
    ref_s = time.perf_counter() - t0
    runs, joined = {}, {}
    for world in (2, 4):
        mine = [r for r in cs.MOE_DP_RUNS if r[1] == world]
        t0 = time.perf_counter()
        ranks = spawn(rank_runs, world, (
            dev, {k: v[:1] for k, v in refs.items()
                  if any((r[4], r[6]) == k for r in mine)},
            {k: g for k, g in grads.items()
             if any(r[4] == k and r[0] in cs.MOE_GRAD_RUNS for r in mine)}),
            timeout=cs.DP_JOIN_S)
        joined[world] = time.perf_counter() - t0
        for name in ranks[0]:
            runs[name] = [{name: r[name]} for r in ranks]
    info = {k: v[1:] for k, v in refs.items()}
    refs.clear()
    grads.clear()
    fails = []
    res = cs._moe_dp_checks(runs, info, control, fails)
    res.update(references_s=ref_s, joined_s=joined, fails=fails, card=card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe_dp_runs.json"),
              "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(f"references {ref_s:.1f} s; joined {joined}")
    print("FAILS:", fails if fails else "none")
    print(card)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
