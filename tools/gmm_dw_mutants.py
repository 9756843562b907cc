"""Shows how far a bf16 dW that carries its sum in the tensor cores drifts.

    python3 tools/gmm_dw_mutants.py

Copies paddle_tpu_torch/ into a temporary directory twice: unchanged, and
with one fault in csrc/grouped_matmul.cu's wgmma dW (``dw_consume``): each
expert's whole sum carried in the wgmma accumulator over all its tiles,
where the kernel sums each 128-row tile in a zeroed accumulator and adds
it to f32 sums with IEEE adds. Each copy builds and runs in a process of
its own (both at once) on the case where one expert holds 16,384 rows
(128 tiles into one output block), bf16, at several seeds and both
MOE_SHAPES, with operands made as chip_smoke's ``_gmm_operands`` makes
them (4 experts, as the card test's; 32 at chip_smoke's seed). For each
it prints the drift along an f64 product of the same operands,
sum((x - ref) ref) / sum(ref ref), of the kernel and of the plain
version, and the kernel's excess over the plain drift. Exits non-zero
unless every seed's unchanged copy passes ``chip_smoke.dw_drift_ok`` and
every seed's faulty copy fails it. Needs one CUDA device and nvcc;
writes chiprun_out/gmm_dw_mutants.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 16384
# (experts, K, N, seed); chip_smoke's case is (32, 1024, 512, SEED + 40)
CASES = ([(4, 1024, 512, s) for s in range(6)]
         + [(4, 512, 1024, s) for s in range(3)] + [(32, 1024, 512, 40)])

MUTANTS = {
    "unchanged": [],
    # the expert's whole sum carried in the accumulator across its tiles
    "dw_carried_accumulator": [
        ("  float sum[R];\n", "  float sum[R], acc[R];\n"),
        ("    float acc[R];\n", ""),
        ("half | kk);", "tl | half | kk);"),
        ("    for (int i = 0; i < R; ++i) sum[i] += acc[i];\n",
         "    for (int i = 0; i < R; ++i) sum[i] = acc[i];\n"),
    ],
}


def run_one():
    """In a copy's process: every case's drifts, as one JSON line."""
    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert not tg.__file__.startswith(ROOT), tg.__file__
    _build.build_all(["grouped_matmul"])
    dev = torch.device("cuda", 0)
    out = []
    for e, k, n, seed in CASES:
        c = torch.zeros((e,), dtype=torch.int32, device=dev)
        c[0] = ROWS
        sched = tg.tile_schedule(c, ROWS // 128, 128)[:2]
        lhs, _, dout = chip_smoke._gmm_operands(dev, torch.bfloat16, ROWS,
                                                e, k, n, seed)
        got = tg.gmm_dw(lhs, dout, sched, num_experts=e)
        want = tg.gmm_dw_plain(lhs, dout, sched, num_experts=e)
        ref = lhs.double().T @ dout.double()
        torch.cuda.synchronize()
        dk, dp = (chip_smoke.dw_drift(x[0], ref) for x in (got, want))
        out.append({"case": f"E={e} K={k} N={n} seed={seed}",
                    "kernel_drift": dk, "plain_drift": dp,
                    "ok": chip_smoke.dw_drift_ok(dk, dp)})
        del lhs, dout, got, want, ref
    print(json.dumps(out))


def main():
    tmp = tempfile.mkdtemp(prefix="gmm_dw_mutants_")
    procs = {}
    try:
        for name, edits in MUTANTS.items():
            pkg = os.path.join(tmp, name, "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "grouped_matmul.cu")
            src = open(cu).read()
            for old, new in edits:
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(cu, "w") as f:
                f.write(src)
            env = dict(os.environ, PYTHONPATH=os.path.join(tmp, name))
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--one"],
                cwd=os.path.join(tmp, name), env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        record, good = {}, True
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                print(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
                good = False
                continue
            cases = json.loads(stdout.strip().splitlines()[-1])
            record[name] = cases
            expected = name == "unchanged"
            for c in cases:
                good &= c["ok"] == expected
                dk, dp = c["kernel_drift"], c["plain_drift"]
                print(f"{name} {c['case']}: kernel drift {dk:+.4e}  plain "
                      f"{dp:+.4e}  excess {dk - dp:+.4e}"
                      f"  {'passes' if c['ok'] else 'fails'} "
                      f"({'as expected' if c['ok'] == expected else 'WRONG'})")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gmm_dw_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one()
    else:
        main()
