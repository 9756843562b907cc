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

The mutants write their faults into the bf16 kernels on wgmma, which
both cases run: three into the forward (flash_fwd_wg_kernel) and three
into the fused backward (flash_bwd_wg_kernel), and two into the split
backward's dQ pass (flash_bwd_dq_wg_kernel, row 18): dQ carried in the
tensor cores' accumulator over the key stages, and dS rounded after the
scale. Each copy also runs chip_smoke's ``check_split`` (rows 17 and 18
against their plain versions under the flash rule at the train shape and
on small layouts, and row 18's dQ drift along f64 products at S = 16384
within VARLEN_DRIFT_EXCESS); a copy passes when both checks pass. Needs
one CUDA device and nvcc; writes chiprun_out/flash_mutants.json and
exits non-zero unless every verdict is as expected.
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

_FWD_PF = "      uint32_t pf[16];  // P rounded to bf16, as the A fragments of P V\n"
_FWD_PACK = "        pf[2 * n + 1] = pack_bf16(p2, p3);\n"
_FWD_PV = ("          wgmma_rs<1>(pv[h], pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], "
           "pf[4 * kk + 3],\n"
           "                      sw128_desc(va + h * (BK * 128) + hh * 8192 + kk * 2048, "
           "BK * 128, 1024),\n"
           "                      kk);\n")
_FWD_ADD = "        for (int e = 0; e < 32; ++e) acc[h][e] += pv[h][e];\n"
_BWD_DV_STEPS = ("        wgmma_rs<1>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], "
                 "pf[4 * kk + 3],\n")
_BWD_DK_ADD = "      for (int e = 0; e < 32; ++e) dkc[h][e] += pr[e];\n"
_BWD_DQ_REDUCE = "          if ((tid & 127) == 0) {\n            bulk_reduce_add_f32("
_DQ_PRODUCT = """      float pr[D / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1, D>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                       sw128_desc(ka + kk * 2048, BK * 128, 1024), kk);
      wg_commit();
      wg_wait<0>();
      reg_fence(pr);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] += pr[e];
"""
_DQ_CARRIED = """      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1, D>(acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                       sw128_desc(ka + kk * 2048, BK * 128, 1024), 1);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
"""
_DQ_DS = "          de[e] = p * (dp[4 * n + e] - (e < 2 ? dl0 : dl1));\n"
_DQ_STAGE0 = "        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);\n"
_DQ_STAGE1 = "        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);\n"


def _lo(a, b):
    """bf16 pair of what rounding to bf16 dropped from the f32 pair."""
    return (f"pack_bf16({a} - __bfloat162float(__float2bfloat16_rn({a})), "
            f"{b} - __bfloat162float(__float2bfloat16_rn({b})))")


# name -> [(text, replacement)]; each text occurs once in the source
MUTANTS = {
    "unchanged": [],
    # P.V with P as bf16 hi + lo, i.e. P left unrounded (to 2^-16)
    "fwd_p_unrounded": [
        (_FWD_PF, _FWD_PF.replace("pf[16]", "pf[16], pl[16]")),
        (_FWD_PACK, _FWD_PACK + f"        pl[2 * n] = {_lo('p0', 'p1')};\n"
         f"        pl[2 * n + 1] = {_lo('p2', 'p3')};\n"),
        (_FWD_PV, "        {\n" + _FWD_PV + _FWD_PV.replace("pf[", "pl[")
         .replace("kk);", "1);") + "        }\n"),
    ],
    # o 20% too large on every q tile of the second half
    "fwd_late_q_tiles_20pct": [
        ("  bf16* og = o + (size_t)bh * sq * D;\n",
         "  if (q0 >= sq / 2)\n    for (int h = 0; h < NB; ++h)\n"
         "      for (int e = 0; e < 32; ++e) acc[h][e] *= 1.2f;\n"
         "  bf16* og = o + (size_t)bh * sq * D;\n"),
    ],
    # key stage 1's first 64-key half never adds its P.V
    "fwd_drop_a_key_tile_pv": [
        (_FWD_ADD, "        for (int e = 0; e < 32; ++e)\n"
         "          if (j != 1 || hh) acc[h][e] += pv[h][e];\n"),
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
    # row 18: dQ summed in the tensor cores' accumulator across key stages
    "dq_carried_in_the_accumulator": [(_DQ_PRODUCT, _DQ_CARRIED)],
    # row 18: dS rounded to bf16 after the softmax scale, not before it
    "dq_ds_rounded_after_the_scale": [
        (_DQ_DS, _DQ_DS.replace(");\n", ") * scale;\n")),
        (_DQ_STAGE0, _DQ_STAGE0.replace(" * scale", "")),
        (_DQ_STAGE1, _DQ_STAGE1.replace(" * scale", "")),
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
    chip_smoke.flash_close = closes
    try:
        chip_smoke.check_split(dev, {})
        split = "passes"
    except AssertionError as e:
        split = f"fails: {str(e)[-600:]}"
    print(json.dumps({"cases": out, "split": split}))


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
            res = json.loads(stdout.strip().splitlines()[-1])
            record[name] = res
            cases = res["cases"]
            passed = all(o["ok"] for c in cases
                         for o in c["outputs"].values()) and all(
                c["lse_max_abs_err"] <= 1e-4 for c in cases) \
                and res["split"] == "passes"
            expected = name == "unchanged"
            good &= passed == expected
            print(f"{name}: check {'passes' if passed else 'fails'} "
                  f"({'as expected' if passed == expected else 'WRONG'}); "
                  f"check_split {res['split']}")
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
