"""Times rows 10, 11, 16 and 17 of two trees side by side on one card.

    python3 tools/ab_times.py BEFORE AFTER

BEFORE and AFTER are directories that each hold a ``paddle_tpu_torch/``
package, for example a ``git archive`` of the parent commit unpacked
into a git-ignored directory, and ``.``. Each tree runs in a process of
its own (its kernels build there), in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the card over the call shows. Times are
device ms per call with the calls queued ahead (chip_smoke.py's
``_time_ms``), in bf16, causal:

  flash_bwd, flash_bwd_dkv   BH 128, S 2048, D 128 (the train phase);
                             BH 128, S 512, D 64 (the ERNIE phase);
                             BH 4, S 131072, D 128 (attn-long)
  slab update, slab read     B 8, NH 32 over NKV 4, HD 64, T 1152,
                             pos 1023 (the generate phase)

Needs one CUDA device and nvcc; prints one JSON line per run, the card's
name and power limit first, and writes chiprun_out/ab_times.json.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH = [(128, 2048, 128, 20), (128, 512, 64, 50), (4, 131072, 128, 2)]


def run_one(tree):
    """In a tree's process: every time, as one JSON line."""
    import torch
    sys.path.insert(0, tree)
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    assert fa.__file__.startswith(tree), fa.__file__
    _build.build_all(["flash_attention", "decode_attention"])
    dev = torch.device("cuda", 0)
    out = {}

    def t(fn, iters):
        return chip_smoke._time_ms(fn, iters)[0]

    for bh, s, d, iters in FLASH:
        g = torch.Generator(device=dev).manual_seed(0)
        qs = (torch.randn((bh, s, d), generator=g, device=dev)
              * (fa.LOG2E / math.sqrt(d))).to(torch.bfloat16)
        k, v, do = (torch.randn((bh, s, d), generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(3))
        o, lse = fa.flash_fwd(qs, k, v, True)
        delta = (do.float() * o.float()).sum(-1)
        args = (qs, k, v, do, lse, delta, True, d ** -0.5)
        out[f"flash_bwd[BH={bh},S={s},D={d}]"] = t(
            lambda: fa.flash_bwd(*args), iters)
        out[f"flash_bwd_dkv[BH={bh},S={s},D={d}]"] = t(
            lambda: fa.flash_bwd_dkv(*args), iters)
        del qs, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    q, nk, nv, kc, vc = chip_smoke._slab_inputs(dev, torch.bfloat16, 8, 32,
                                                4, 64, 1152, 0)
    out["slab update[B=8,pos=1023]"] = t(
        lambda: da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, 1023), 200)
    out["slab read[B=8,pos=1023]"] = t(
        lambda: da.decode_attention_slab(q, kc, vc, 1, 1023), 200)
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
