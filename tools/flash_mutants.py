"""Shows that chip_smoke.py's flash check fails a wrong kernel.

    python3 tools/flash_mutants.py

Copies paddle_tpu_torch/ into a temporary directory once per mutant, writes
one deliberate fault into the copy's csrc/flash_attention.cu, and runs
chip_smoke's flash check (``flash_case``) on the copy's kernels in a
process of its own (all copies build and run at once). The unchanged copy
must pass and every faulty one must fail. Beside each verdict it prints
what the earlier rule (atol = rel * max |ref| of the whole tensor, rtol =
rel) would have said. Cases: the train phase's shape (BH 128, S 2048,
D 128, causal, bf16) and BH 8, S 200, D 128, not causal, bf16.

The backward mutants write their faults into the bf16 kernel on wgmma
(flash_bwd_wg_kernel), which both cases run. Needs one CUDA device and
nvcc; writes chiprun_out/flash_mutants.json and exits non-zero unless
every verdict is as expected.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(128, 2048, 128, True), (8, 200, 128, False)]

_FWD_P = "      st_pair(pw + (g + 8) * LDP + n * 8 + 2 * t, p2, p3);\n"
_FWD_PV = ("    warp_mm<NTO, true, false>(acc, pw, LDP, v_s, LD, BK);"
           "  // acc += round(P) V\n")
_BWD_DV_STEPS = ("        wgmma_rs<1>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], "
                 "pf[4 * kk + 3],\n")
_BWD_DK_ADD = "      for (int e = 0; e < 32; ++e) dkc[h][e] += pr[e];\n"
_BWD_DQ_REDUCE = "          if ((tid & 127) == 0) {\n            bulk_reduce_add_f32("


def _lo(ptr, row, a, b):
    """st_pair of what rounding to T dropped from the f32 pair (a, b)."""
    return (f"      st_pair({ptr} + {row} * LDP + n * 8 + 2 * t, "
            f"{a} - to_f(from_f<T>({a})), {b} - to_f(from_f<T>({b})));\n")


# name -> [(text, replacement)]; each text occurs once in the source
MUTANTS = {
    "unchanged": [],
    # P.V with P as bf16 hi + lo, i.e. P left unrounded (to 2^-16)
    "fwd_p_unrounded": [
        ("(size_t)BQ * LD + 4 * BK * LD + BQ * LDP);",
         "(size_t)BQ * LD + 4 * BK * LD + 2 * BQ * LDP);"),
        (_FWD_P, _FWD_P + _lo("pw + BQ * LDP", "g", "p0", "p1")
         + _lo("pw + BQ * LDP", "(g + 8)", "p2", "p3")),
        (_FWD_PV, _FWD_PV + "    warp_mm<NTO, true, false>(acc, pw + BQ * "
         "LDP, LDP, v_s, LD, BK);\n"),
    ],
    # o 20% too large on every q tile of the second half
    "fwd_late_q_tiles_20pct": [
        ("  T* og = o + bh * sq * D;\n",
         "  if (q0 >= sq / 2)\n    for (int n = 0; n < NTO; ++n)\n"
         "      for (int e = 0; e < 4; ++e) acc[n][e] *= 1.2f;\n"
         "  T* og = o + bh * sq * D;\n"),
    ],
    # dV misses one of the four wgmma products (16 q rows) of every q tile
    "bwd_dv_drop_a_product": [
        ("      for (int kk = 0; kk < 4; ++kk)\n" + _BWD_DV_STEPS,
         "      for (int kk = 0; kk < 3; ++kk)\n" + _BWD_DV_STEPS),
    ],
    # dK misses the last q tile's share
    "bwd_dk_drop_last_q_tile": [
        (_BWD_DK_ADD, "      for (int e = 0; e < 32; ++e)\n"
         "        if (i + 1 < nq) dkc[h][e] += pr[e];\n"),
    ],
    # key tile 0 never adds its dQ partials
    "bwd_skip_dq_reduce": [
        (_BWD_DQ_REDUCE, "          if ((tid & 127) == 0 && kt != 0) {\n"
         "            bulk_reduce_add_f32("),
    ],
}


def _old_rule(got, ref, rel):
    """The earlier check: max |got - ref| within rel of the largest |ref|
    of the whole tensor, elementwise rtol rel."""
    g, r = got.float(), ref.float()
    return bool(((g - r).abs() <= rel * r.abs().max() + rel * r.abs()).all())


def run_one(name):
    """In a copy's process: both cases through chip_smoke's check."""
    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    assert not fa.__file__.startswith(ROOT), fa.__file__
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda", 0)
    rel = chip_smoke.FLASH_TOL[torch.bfloat16][0][0]
    closes, olds = chip_smoke.flash_close, []

    def spy(got, ref, rel_, frob):
        olds.append(_old_rule(got, ref, rel))
        return closes(got, ref, rel_, frob)

    chip_smoke.flash_close = spy
    out = []
    for i, (bh, s, d, causal) in enumerate(CASES):
        olds.clear()
        res, err_lse = chip_smoke.flash_case(fa, bh, s, d, causal,
                                             torch.bfloat16, i, dev)
        out.append({
            "case": f"BH={bh} S={s} D={d} causal={causal} bf16",
            "lse_max_abs_err": err_lse,
            "outputs": {k: {"ok": r[0], "excess": r[1], "rel_frob": r[2],
                            "max_abs_err": r[3], "old_rule_ok": o}
                        for (k, r), o in zip(res.items(), olds)}})
    print(json.dumps(out))


def main():
    tmp = tempfile.mkdtemp(prefix="flash_mutants_")
    procs = {}
    try:
        for name, edits in MUTANTS.items():
            pkg = os.path.join(tmp, name, "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "flash_attention.cu")
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
            cases = json.loads(stdout.strip().splitlines()[-1])
            record[name] = cases
            passed = all(o["ok"] for c in cases
                         for o in c["outputs"].values()) and all(
                c["lse_max_abs_err"] <= 1e-4 for c in cases)
            expected = name == "unchanged"
            good &= passed == expected
            print(f"{name}: check {'passes' if passed else 'fails'} "
                  f"({'as expected' if passed == expected else 'WRONG'})")
            for c in cases:
                print(f"  {c['case']}: lse err {c['lse_max_abs_err']:.2e}")
                for k, o in c["outputs"].items():
                    print(f"    {k}: {'ok' if o['ok'] else 'FAILS'}  excess "
                          f"{o['excess']:+.3e}  rel frob {o['rel_frob']:.3e}"
                          f"  max_abs_err {o['max_abs_err']:.3e}  old rule "
                          f"{'ok' if o['old_rule_ok'] else 'fails'}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main()
