"""Mutation check of the grouped-matmul card check (chip_smoke's
``check_gmm``) and of the bf16 dW's drift rule.

    python3 tools/gmm_mutants.py

Copies paddle_tpu_torch/ into a temporary directory once unchanged and
once for each fault in csrc/grouped_matmul.cu below:

  dw_carried_accumulator  the wgmma dW (``dw_consume``) carries each
                          expert's whole sum in the wgmma accumulator over
                          all its tiles, where the kernel sums each
                          128-row tile in a zeroed accumulator and adds it
                          to f32 sums with IEEE adds;
  dead_tile_unwritten     the bf16 forward and dX store nothing for a dead
                          tile (live == 0), where they write zeros;
  fwd_last_block_dropped  the bf16 forward leaves out the last block of N
                          when it is narrower than the block (the 64-wide
                          block at N = 192);
  dx_neighbour_rhs        the bf16 dX multiplies by the rhs of the
                          neighbouring expert (e ^ 1).

Every copy builds and runs in a process of its own (all at once) and runs
``check_gmm``. The unchanged copy and dw_carried_accumulator also run dW
on the case where one expert holds 16,384 rows (128 tiles into one output
block), bf16, at several seeds and both MOE_SHAPES, with operands made as
chip_smoke's ``_gmm_operands`` makes them (4 experts, as the card test's;
32 at chip_smoke's seed), and print the drift along an f64 product of the
same operands, sum((x - ref) ref) / sum(ref ref), of the kernel and of
the plain version, and the kernel's excess over the plain drift. Exits
non-zero unless the unchanged copy passes ``check_gmm`` and
``chip_smoke.dw_drift_ok`` in every case, and every faulty copy fails
``check_gmm`` (dw_carried_accumulator also ``dw_drift_ok`` in every
case). Needs one CUDA device and nvcc; writes
chiprun_out/gmm_mutants.json.
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
    "dw_carried_accumulator": [
        ("  float sum[R];\n", "  float sum[R], acc[R];\n"),
        ("    float acc[R];\n", ""),
        ("half | kk);", "tl | half | kk);"),
        ("    for (int i = 0; i < R; ++i) sum[i] += acc[i];\n",
         "    for (int i = 0; i < R; ++i) sum[i] = acc[i];\n"),
    ],
    "dead_tile_unwritten": [
        ("    bf16* o = out + (size_t)t * kTileRows * no + n0;\n",
         "    if (!lv) continue;\n"
         "    bf16* o = out + (size_t)t * kTileRows * no + n0;\n"),
    ],
    "fwd_last_block_dropped": [
        ("const int nblk = (no + C::BNW - 1) / C::BNW,",
         "const int nblk = B_MN ? no / C::BNW : (no + C::BNW - 1) / C::BNW,"),
    ],
    "dx_neighbour_rhs": [
        ("const int brow = tile_expert[t] * (B_MN ? kc : no);",
         "const int brow = (tile_expert[t] ^ (B_MN ? 0 : 1)) * "
         "(B_MN ? kc : no);"),
    ],
}
DRIFT_COPIES = ("unchanged", "dw_carried_accumulator")


def dw_cases(chip_smoke, tg, dev):
    import torch
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
    return out


def run_one(name):
    """In a copy's process: check_gmm's verdict and, for DRIFT_COPIES,
    every dW case's drifts, as one JSON line."""
    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert not tg.__file__.startswith(ROOT), tg.__file__
    _build.build_all(["grouped_matmul"])
    dev = torch.device("cuda", 0)
    try:
        chip_smoke.check_gmm(dev, {})
        verdict = "passed"
    except AssertionError as e:
        verdict = f"failed: {str(e)[:300]}"
    cases = dw_cases(chip_smoke, tg, dev) if name in DRIFT_COPIES else []
    print(json.dumps({"check_gmm": verdict, "dw_cases": cases}))


def main():
    tmp = tempfile.mkdtemp(prefix="gmm_mutants_")
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
                [sys.executable, os.path.abspath(__file__), "--one", name],
                cwd=os.path.join(tmp, name), env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        record, good = {}, True
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                print(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
                good = False
                continue
            res = json.loads(stdout.strip().splitlines()[-1])
            record[name] = res
            sound = name == "unchanged"
            passed = res["check_gmm"] == "passed"
            good &= passed == sound
            print(f"{name}: check_gmm {res['check_gmm']} "
                  f"({'as expected' if passed == sound else 'WRONG'})")
            for c in res["dw_cases"]:
                good &= c["ok"] == sound
                dk, dp = c["kernel_drift"], c["plain_drift"]
                print(f"{name} {c['case']}: kernel drift {dk:+.4e}  plain "
                      f"{dp:+.4e}  excess {dk - dp:+.4e}"
                      f"  {'passes' if c['ok'] else 'fails'} "
                      f"({'as expected' if c['ok'] == sound else 'WRONG'})")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gmm_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main()
