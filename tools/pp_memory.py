"""Where a pipeline rank's peak device memory goes, phase by phase.

    python3 tools/pp_memory.py

Spawns 2 ranks sharing cuda:0 over gloo (as chip_smoke's train-dp does)
and builds ``build_train_step`` at llama_7b's width cut to chip_smoke's
DP_LAYERS, B and S, bf16, full remat, once as pp 2 (microbatches 4) and
once as dp 2 for contrast. Each rank takes one step from the seeded
params, split into its phases (pp: the pipeline's forward and the loss,
the backward, the gradient sums, AdamW; dp: the loss and gradients
together, AdamW), and reports for each phase the bytes allocated when it
began and its peak (``torch.cuda.max_memory_allocated`` after a reset at
its start), with the state's bytes. Prints one JSON line a run and the
card's name and power limit; writes chiprun_out/pp_memory.json. Needs one
CUDA device.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"pp2": dict(pp=2, microbatches=4), "dp2": dict(dp=2)}


def rank(rank, world, runs, device="cuda"):
    import dataclasses
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.models import llama as tl
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    x = cs.train_batches(tl.llama_7b().vocab_size, 1)[0]
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=cs.DP_LAYERS)
    out = {}
    for name, kw in runs.items():
        par = tl.ParallelConfig(remat=True, remat_policy="full", **kw)
        step, p, o = tl.build_train_step(cfg, par, seed=cs.SEED, device=dev)
        phases = {}

        def phase(label, fn):
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn()
            torch.cuda.synchronize()
            phases[label] = {"start_gb": start / 1e9,
                             "peak_gb": torch.cuda.max_memory_allocated()
                             / 1e9}
            return got
        ids, labels = step.local_batch(x[:, :-1], x[:, 1:])
        if kw.get("pp", 1) > 1:
            leaves = {k: ({n: [tl._grad_leaf(t) for t in w[0]]
                           for n, w in v.items()} if k == "layers"
                          else tl._grad_leaf(v)) for k, v in p.items()}
            _, roots = phase("forward and loss",
                             lambda: step._pipeline(leaves, ids, labels))
            phase("backward", lambda: torch.autograd.backward(*roots))
            del roots
            grads = phase("gradient sums", lambda: step._sync(leaves))
            del leaves
        else:
            _, grads = phase("loss and gradients",
                             lambda: step.loss_and_grads(p, ids, labels))
        phase("AdamW", lambda: step.update(p, grads, o))
        out[name] = {"state_gb": cs._tree_bytes(p) / 1e9 + cs._tree_bytes(
            {"m": o["m"], "v": o["v"]}) / 1e9, "phases": phases}
        del step, p, o, grads
        torch.cuda.empty_cache()
    return out


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.testing.dist import spawn
    cs.probe()
    _build.build_all(["rms_norm", "flash_attention"])
    ranks = spawn(rank, 2, (RUNS,), timeout=900)
    res = {"card": cs._card_line(), "runs": {
        name: [r[name] for r in ranks] for name in RUNS}}
    for name, per in res["runs"].items():
        print(json.dumps({"run": name, "ranks": per}))
    print(res["card"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "pp_memory.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
