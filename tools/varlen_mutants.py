"""Shows that chip_smoke.py's varlen checks fail a wrong split backward.

    python3 tools/varlen_mutants.py

Copies paddle_tpu_torch/ into a temporary directory once per mutant, writes
one deliberate fault into the copy's csrc/flash_varlen.cu, in the bf16
split backward on wgmma (row 22's varlen_bwd_wg_kernel, row 23's
varlen_dq_wg_kernel), and runs chip_smoke's varlen checks on the copy's
kernels in a process of its own (all copies build at once, then run
three at a time):
``check_varlen`` (every varlen kernel against its plain version on the
short pack and the f32 layouts, fused against split, the split outputs
bitwise over two runs, segment isolation, GQA), then the drift rule of
``varlen_split_drifts`` (rows 22 and 23 against a product summed in f64,
the excess over the plain version held to ``VARLEN_DRIFT_EXCESS``) on
four heads of the long pack (16 x 4,096) and on one head of one
65,536-token segment. The unchanged copy must pass and every faulty one
must fail. Needs one CUDA device and nvcc; prints each copy's drifts,
writes chiprun_out/varlen_mutants.json and exits non-zero unless every
verdict is as expected.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DKV_LIVE = ("          const int ql = 8 * j + 2 * t + (e & 1), qrow = r0 + ql;\n"
             "          const bool live = e < 2 ? (qrow >= lo0 && qrow < hi0) : "
             "(qrow >= lo1 && qrow < hi1);\n")
_DQ_LIVE = ("          const int col = c0 + 8 * j + 2 * t + (e & 1);\n"
            "          const bool live = e < 2 ? (col >= lo0 && col < hi0) : "
            "(col >= lo1 && col < hi1);\n")
_DKV_PF = "      uint32_t pf[16];\n"
_DKV_PACK = "        pf[2 * j + 1] = pack_bf16(pe[2], pe[3]);\n"
_DKV_DV = ("        wgmma_rs<1, D>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], "
           "pf[4 * kk + 3],\n"
           "                       sw128_desc(doa + kk * 2048, BQ * 128, 1024), kk);\n")
_DKV_DK = ("        wgmma_rs<1, D>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], "
           "dsf[4 * kk + 3],\n"
           "                       sw128_desc(qa + kk * 2048, BQ * 128, 1024), kk);\n")
_DQ_DQ = ("        wgmma_rs<1, D>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], "
          "dsf[4 * kk + 3],\n"
          "                       sw128_desc(ka + kk * 2048, BK * 128, 1024), kk);\n")


def _lo(a, b):
    """bf16 pair of what rounding to bf16 dropped from the f32 pair."""
    return (f"pack_bf16({a} - __bfloat162float(__float2bfloat16_rn({a})), "
            f"{b} - __bfloat162float(__float2bfloat16_rn({b})))")


# name -> [(text, replacement)]; each text occurs once in the source
MUTANTS = {
    "unchanged": [],
    # row 22: a key's live q rows run on past its segment's end (the q
    # interval's upper end is not tested on a masked tile)
    "dkv_mask_dropped_at_segment_end": [
        (_DKV_LIVE, _DKV_LIVE.replace(" && qrow < hi0", "")
         .replace(" && qrow < hi1", "")),
    ],
    # row 23: a row's live keys reach back past its segment's start
    "dq_mask_dropped_at_segment_start": [
        (_DQ_LIVE, _DQ_LIVE.replace("col >= lo0 && ", "")
         .replace("col >= lo1 && ", "")),
    ],
    # row 22: each key sees one q row past its interval
    "dkv_interval_end_off_by_one": [
        (_DKV_LIVE, _DKV_LIVE.replace("qrow < hi", "qrow <= hi")),
    ],
    # row 23: each row sees one key past its interval (the next token
    # under causal)
    "dq_interval_end_off_by_one": [
        (_DQ_LIVE, _DQ_LIVE.replace("col < hi", "col <= hi")),
    ],
    # row 22: dV from P as bf16 hi + lo, i.e. P left unrounded (to 2^-16)
    "dkv_p_unrounded": [
        (_DKV_PF, "      uint32_t pf[16], pl[16];\n"),
        (_DKV_PACK, _DKV_PACK
         + f"        pl[2 * j] = {_lo('pe[0]', 'pe[1]')};\n"
         f"        pl[2 * j + 1] = {_lo('pe[2]', 'pe[3]')};\n"),
        (_DKV_DV, _DKV_DV + "      for (int kk = 0; kk < 4; ++kk)\n"
         + _DKV_DV.replace("pf[", "pl[").replace("kk);", "1);")),
    ],
    # row 22: P and dS from the next head's lse
    "dkv_lse_of_next_head": [
        ("    const float* src = (pt < BQ ? lse : delta) + (size_t)h * S.tq;\n",
         "    const float* src = pt < BQ ? lse + (size_t)((h + 1) % gridDim.y) * S.tq\n"
         "                               : delta + (size_t)h * S.tq;\n"),
    ],
    # row 23: P and dS from the next head's lse
    "dq_lse_of_next_head": [
        ("  const float lse0 = row0 < S.tq ? lse[(size_t)h * S.tq + row0] * kLog2e : 0.f;\n"
         "  const float lse1 = row1 < S.tq ? lse[(size_t)h * S.tq + row1] * kLog2e : 0.f;\n",
         "  const size_t hn = (h + 1) % gridDim.y;\n"
         "  const float lse0 = row0 < S.tq ? lse[hn * S.tq + row0] * kLog2e : 0.f;\n"
         "  const float lse1 = row1 < S.tq ? lse[hn * S.tq + row1] * kLog2e : 0.f;\n"),
    ],
    # rows 22 and 23: every sum carried in the wgmma accumulator (dV and
    # dK over q tiles, dQ over key stages), as the parent's mma.sync
    # kernels did
    "carried_sum": [
        (_DKV_DV, _DKV_DV.replace("(pr,", "(dvc,").replace("kk);", "1);")),
        ("      for (int e = 0; e < D / 2; ++e) dvc[e] += pr[e];\n", ""),
        (_DKV_DK, _DKV_DK.replace("(pr,", "(dkc,").replace("kk);", "1);")),
        ("      for (int e = 0; e < D / 2; ++e) dkc[e] += pr[e];\n", ""),
        (_DQ_DQ, _DQ_DQ.replace("(pr,", "(acc,").replace("kk);", "1);")),
        ("      for (int e = 0; e < D / 2; ++e) acc[e] += pr[e];\n", ""),
    ],
}


def mutated(src, edits, name):
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    return src


AT_ONCE = 3


def _run(mode, copy):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode],
                            cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def build_one():
    """In a copy's process: build its kernels."""
    from paddle_tpu_torch import _build
    _build.build_all(["flash_varlen"])


def run_one():
    """In a copy's process: chip_smoke's varlen checks, as one JSON line."""
    import torch
    sys.path.append(ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_varlen as fv
    assert not fv.__file__.startswith(ROOT), fv.__file__
    _build.build_all(["flash_varlen"])
    dev = torch.device("cuda", 0)
    out = {}
    try:
        cs.check_varlen(dev, {})
        out["check"] = "passes"
    except AssertionError as e:
        out["check"] = f"fails: {str(e)[:300]}"
    torch.cuda.empty_cache()
    for key, lens, h in (("long pack, 4 heads", cs.VARLEN_LONG, cs.VARLEN_H),
                         ("one 65,536-token segment", [65536], 1)):
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, h,
                                        cs.VARLEN_D, cs.SEED + 70)
        out[key] = cs.varlen_split_drifts(fv, q, k, v, do, lens,
                                          min(h, cs.VARLEN_DRIFT_HEADS))
        del q, k, v, do
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    tmp = tempfile.mkdtemp(prefix="varlen_mutants_")
    procs, copies, started = {}, {}, []
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "flash_varlen.cu")).read()
    try:
        for name, edits in MUTANTS.items():
            pkg = os.path.join(tmp, name, "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            with open(os.path.join(pkg, "csrc", "flash_varlen.cu"), "w") as f:
                f.write(mutated(src, edits, name))
            copies[name] = os.path.join(tmp, name)
        # every copy builds at once; then they run AT_ONCE at a time (the
        # card's memory holds a few of them)
        builds = {name: _run("--build", copy) for name, copy in copies.items()}
        started.extend(builds.values())
        for name, p in builds.items():
            _, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"{name}: build exit {p.returncode}\n"
                                   f"{stderr[-4000:]}")
        names, outs = list(copies), {}
        for k in range(0, len(names), AT_ONCE):
            for name in names[k:k + AT_ONCE]:
                procs[name] = _run("--one", copies[name])
                started.append(procs[name])
            for name in names[k:k + AT_ONCE]:
                outs[name] = procs[name].communicate(timeout=1200)
        record, good = {}, True
        for name, p in procs.items():
            stdout, stderr = outs[name]
            if p.returncode != 0:
                print(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
                good = False
                continue
            res = json.loads(stdout.strip().splitlines()[-1])
            record[name] = res
            drifts = {key: x for key, x in res.items() if key != "check"}
            passed = res["check"] == "passes" and all(
                o["ok"] for x in drifts.values() for o in x.values())
            expected = name == "unchanged"
            good &= passed == expected
            print(f"{name}: {'passes' if passed else 'fails'} "
                  f"({'as expected' if passed == expected else 'WRONG'}); "
                  f"check_varlen {res['check']}")
            for key, x in drifts.items():
                print(f"  {key}: " + ", ".join(
                    f"{n} excess {o['excess']:+.3e} "
                    f"({'ok' if o['ok'] else 'over'}; kernel "
                    f"{o['kernel']:+.3e}, plain {o['plain']:+.3e})"
                    for n, o in x.items()))
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "varlen_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one()
    elif sys.argv[1:2] == ["--dry"]:   # the edits apply (no card needed)
        text = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                                 "flash_varlen.cu")).read()
        for n, e in MUTANTS.items():
            mutated(text, e, n)
        print(f"{len(MUTANTS)} copies: every edit applies once")
    else:
        main()
