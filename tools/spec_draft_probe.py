"""How often the default 1-layer draft's proposals are accepted on
llama_7b's random weights, as the residual damping shrinks.

    python3 tools/spec_draft_probe.py

chip_smoke.py's serve-spec phase scales o_proj and down_proj by 0.05, as
bench.py's speculative benchmark does, so that a draft made of the first
layer would track the base. This script serves the first 12 requests of
that phase's trace (512-token shared prefix plus a 16-95 token tail,
RandomState(18), 32 new tokens, deterministic clock, draft_k 4) on
llama_7b (bf16, 32 layers, seed 0) at several dampings, speculation off
and on, and prints for each the accept rate, tokens per iteration off
and on, how many of the 12 streams are identical off and on, and each
run's seconds. Needs one CUDA device; writes
chiprun_out/spec_draft_probe.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAMPINGS = (0.05, 0.01, 0.003, 0.001, 0.0003)
N_REQUESTS = 12


def main():
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_7b)
    if not torch.cuda.is_available():
        sys.exit("spec_draft_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=0)
    rng = np.random.RandomState(18)
    system = rng.randint(1, cfg.vocab_size, size=512).tolist()
    prompts = [system + rng.randint(1, cfg.vocab_size,
                                    size=rng.randint(16, 96)).tolist()
               for _ in range(24)][:N_REQUESTS]
    serve = dict(block_size=128, num_blocks=257, max_batch=8,
                 prefill_chunk=256, max_seq_len=2048, draft_k=4)
    # warm-up: the kernels' build, cuBLAS handles, the allocator
    InferenceEngine(params, cfg, ServeConfig(
        speculative=True, **dict(serve, num_blocks=17))).run(
        [Request(prompts[0], max_new_tokens=6)])
    rows, scale = [], 1.0
    for damp in DAMPINGS:
        for name in ("o_proj", "down_proj"):
            params["layers"][name].mul_(damp / scale)
        scale = damp
        runs = {}
        for spec in (False, True):
            eng = InferenceEngine(params, cfg,
                                  ServeConfig(speculative=spec, **serve))
            t0 = time.perf_counter()
            stats = eng.run([Request(list(p), max_new_tokens=32,
                                     arrival=float(i))
                             for i, p in enumerate(prompts)],
                            deterministic=True)
            runs[spec] = (stats, time.perf_counter() - t0,
                          {s.req.request_id: s.generated
                           for s in eng.finished})
            del eng
            torch.cuda.empty_cache()
        off, on = runs[False], runs[True]
        row = {"damping": damp,
               "accept_rate": on[0]["speculative"]["accept_rate"],
               "tokens_per_iteration_off": off[0]["generated_tokens"]
               / off[0]["iterations"],
               "tokens_per_iteration_on": on[0]["generated_tokens"]
               / on[0]["iterations"],
               "streams_identical": sum(off[2][r] == on[2][r]
                                        for r in off[2]),
               "run_s_off": off[1], "run_s_on": on[1]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "spec_draft_probe.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
