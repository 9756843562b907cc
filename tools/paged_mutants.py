"""Shows that chip_smoke.py's paged checks fail a wrong split walk or
commit.

    python3 tools/paged_mutants.py [NAME ...]

Copies paddle_tpu_torch/ into a temporary directory once per mutant, writes
one deliberate fault into the copy's csrc/paged_attention.cu (or
csrc/split_common.cuh), in the split walk of rows 3 and 2
(paged_split_kernel), of rows 5 and 4 (the same kernel over int8 pools,
the ``quant_*`` mutants), of the verify read of rows 6 and 7
(paged_verify_split_kernel) or of the commit of rows 8 and 9
(paged_commit_kernel, the ``commit_*`` mutants), and runs chip_smoke's
paged checks on the
copy's kernels in a process of its own (all copies build at once, then run
one at a time): ``check_paged_update`` (row 3 at the kernel's split within
PAGED_ATOL, at rows of 2-4 blocks within PAGED_SCHEDULE_FROB, the same
bits over three calls, the pools bitwise the plain version's),
``check_paged_read`` (row 2 likewise, a length-0 row exactly 0),
``check_verify`` and ``check_quant`` (rows 6 and 7 at the kernel's split
under ``verify_held``: the flash rule, lse, the padding row exact over
NaN-poisoned outputs, the same bits over three calls, the schedule's frob
at rows of 2-4 blocks; rows 5 and 4 at the kernel's split likewise, row
5's pools bitwise with the new bytes and scales landed, row 4's length-0
row exactly 0 over a NaN-poisoned output) and ``check_commit`` (rows 8
and 9 bitwise the plain versions but block 0, block 0 untouched, the same
bits twice, every live column written, over commit lengths 0, 1, T and
mixed and block sizes 16 to 1024; a ``commit_*`` mutant's copy runs this
check only). The unchanged copy must pass and every faulty one must fail. NAMEs pick mutants (the unchanged copy
always runs). Needs one CUDA device and nvcc; prints each copy's verdict
and the checks' messages, writes chiprun_out/paged_mutants.json and exits
non-zero unless every verdict is as expected.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ACC = "      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][0] * alpha[r] + pv[r];\n"
_WRITE_IF = "  if (WRITE && split == nlive - 1) {\n"
_WRITE_BODY = """    T* kw = static_cast<T*>(a.k_pool);
    T* vw = static_cast<T*>(a.v_pool);
    const T* new_k = static_cast<const T*>(a.new_k);
    const T* new_v = static_cast<const T*>(a.new_v);
    const int blk = trow[last / bs - j0];
    const size_t base = (((size_t)layer * np + blk) * kvd + head_off) * bs + last % bs;
    const size_t src = (size_t)b * kvd + head_off;
    for (int d = tid; d < hd; d += nt) {
      kw[base + (size_t)d * bs] = new_k[src + d];
      vw[base + (size_t)d * bs] = new_v[src + d];
    }
"""
_SCALE_WRITE = """    if (QUANT && tid == 0) {
      a.k_scale[scale_off(blk) + last % bs] = a.new_ks[(size_t)b * nkv + g];
      a.v_scale[scale_off(blk) + last % bs] = a.new_vs[(size_t)b * nkv + g];
    }
"""
_FINAL = "  // 5. one live split writes its result"
_P_ROUND = "        p_s[r * bs + tid] = from_f<T>(p);\n"
_PUBLISH = "    if (tid == 0) publish_max<R>(gsync, mypart, split, smx);\n"
_LOOK_BACK = "    look_back<R>(gsync, gpart, pstride, split, nt, m);\n"
_COMBINE_HEAD = "  if (!last_split(gsync, nlive, &last_s)) return;\n"
_VERIFY_CALL = ("    combine_splits<R, false>(gpart, pstride, nlive, hd, nt, vr, "
                "part_s, gsync);\n")
_COMBINE_VERIFY = "  if constexpr (VERIFY)\n" + _VERIFY_CALL
_COMBINE_DECODE = ("  else\n    combine_splits<R>(gpart, pstride, nlive, hd, nt, a.out + q_off, "
                   "part_s, gsync);\n")
# The splits record the order in which they finish (the flag of rank c
# takes 2 + the split that finished c-th; a flag is raised by atomicMax so
# that a late publish cannot lower it, and the look-back only tests it for
# 0), and the last split combines the partial states in that order, into
# the decode output (finalised) or, VERIFY, the verify outputs.
_ARRIVAL_PUBLISH = """    if (tid == 0) {
      for (int r = 0; r < R; ++r) mypart[r] = smx[r];
      __threadfence();
      atomicMax(gsync + 2 + split, 1);
    }
"""


def _arrival_combine(verify):
    store = ("""    const int o = vr.row(r);
    if (o < 0) continue;
    a.out[(size_t)o * hd + i % hd] = as;
    if (i % hd == 0) {
      a.m_out[o] = mm;
      a.l_out[o] = ls;
    }
""" if verify else "    a.out[q_off + i] = as / fmaxf(ls, 1e-30f);\n")
    return """  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int c = atomicAdd(gsync + 1, 1);
    atomicMax(gsync + 2 + c, 2 + split);
    last_s = c == nlive - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  int* ord = reinterpret_cast<int*>(part_s) + 2 * R * nlive;  // after the (m, l)
  for (int t = tid; t < nlive; t += nt) {
    int v;
    while ((v = ld_acquire(gsync + 2 + t)) < 2) __nanosleep(32);
    ord[t] = v - 2;
  }
  __syncthreads();
  for (int x = tid; x < nlive * 2 * R; x += nt)
    part_s[x] = __ldcg(gpart + (size_t)ord[x / (2 * R)] * pstride + R + x % (2 * R));
  __syncthreads();
  for (int i = tid; i < R * hd; i += nt) {
    const int r = i / hd;
    float mm = -INFINITY;
    for (int t = 0; t < nlive; ++t) mm = fmaxf(mm, part_s[t * 2 * R + r]);
    float ls = 0.f, as = 0.f;
    for (int t = 0; t < nlive; ++t) {
      const float w = exp2f(part_s[t * 2 * R + r] - mm);
      ls += part_s[t * 2 * R + R + r] * w;
      as += __ldcg(gpart + (size_t)ord[t] * pstride + 3 * R + i) * w;
    }
""" + store + """  }
  for (int t = tid; t < nlive; t += nt) gsync[2 + t] = 0;
  if (tid == 0) gsync[0] = gsync[1] = 0;
"""


_VERIFY_PV = ("                for (int x = 0; x < VEC; ++x) acc[r][e] += pf[x] * "
              "vf[e][x];\n")
_SCALE_SRC = ("        bulk_load(ks_s + (size_t)jj * bs, a.k_scale + scale_off(trow[jj]), "
              "4 * bs, br);\n")
_DEAD_VERIFY = "        if (o < 0 || tid >= hd) continue;\n"
_DEAD_DECODE = "      for (int i = tid; i < R * hd; i += nt) a.out[q_off + i] = 0.f;\n"
_COMBINE_STORE = "      out.acc[(size_t)o * hd + tid] = as[r];\n"
_COMMIT_LIVE = "    if (t >= min(a.commit_len[b], a.t_fed)) continue;\n"

# name -> [(text, replacement)] in csrc/paged_attention.cu, or [(file,
# text, replacement)] elsewhere in csrc/; each text occurs once
MUTANTS = {
    "unchanged": [],
    # each block's P rounded against that block's own max (then scaled to
    # the running max in f32), not against one walk's running max
    "p_rounded_against_own_max": [
        (_P_ROUND, _P_ROUND.replace(
            "from_f<T>(p)", "from_f<T>(VERIFY ? p : exp2f(sc - bm_s[jj * R + r]))")),
        (_ACC, _ACC.replace("+ pv[r];", "+ pv[r] * exp2f(bm_s[jj * R + r] - m[r]);")),
    ],
    # no look-back: every split's recurrence starts from -inf, its own max
    "look_back_skipped": [
        (_LOOK_BACK, "    if (VERIFY) " + _LOOK_BACK.lstrip()),
    ],
    # the partial states combined in the order the splits finish
    "combine_in_arrival_order": [
        (_PUBLISH, _ARRIVAL_PUBLISH),
        (_COMBINE_HEAD + _COMBINE_VERIFY + _COMBINE_DECODE,
         "  if constexpr (VERIFY) {\n" + _COMBINE_HEAD + _VERIFY_CALL
         + "  } else {\n" + _arrival_combine(False) + "  }\n"),
    ],
    # the new column written by the split before its owner (a row of one
    # split never gets it)
    "column_by_the_wrong_split": [
        (_WRITE_IF, _WRITE_IF.replace("nlive - 1", "nlive - 2")),
    ],
    # the owner writes the column only after it read its blocks
    "column_written_after_the_read": [
        (_WRITE_IF, _WRITE_IF.replace("nlive - 1", "nlive - 1 && false")),
        (_FINAL, "  if (WRITE && split == nlive - 1) {\n" + _WRITE_BODY
         + "  }\n" + _FINAL),
    ],
    # the last split's last block read from the table slot past the row's
    # last block
    "block_past_the_last_read": [
        ("(size_t)trow[jj]) * kvd",
         "(size_t)trow[jj + (split == nlive - 1 && jj == nb - 1)]) * kvd"),
    ],
    # the verify read (rows 6, 7): P rounded against the split's own max
    # (one block a split), scaled back to the running max in f32
    "verify_p_rounded_against_own_max": [
        (_P_ROUND, _P_ROUND.replace(
            "from_f<T>(p)", "from_f<T>(VERIFY ? exp2f(sc - bm_s[jj * R + r]) : p)")),
        (_VERIFY_PV, _VERIFY_PV.replace(
            "vf[e][x];",
            "vf[e][x] * (QUANT ? 1.f : exp2f(bm_s[jj * R + r] - m[r]));")),
    ],
    # the verify read without the look-back
    "verify_look_back_skipped": [
        (_LOOK_BACK, "    if (!VERIFY) " + _LOOK_BACK.lstrip()),
    ],
    # the verify read's partial states combined in the order the splits
    # finish
    "verify_combine_in_arrival_order": [
        (_PUBLISH, _ARRIVAL_PUBLISH),
        (_COMBINE_HEAD + _COMBINE_VERIFY,
         "  if constexpr (VERIFY) {\n" + _arrival_combine(True) + "  } else {\n"
         + _COMBINE_HEAD + "  if constexpr (false)\n    ;\n"),
        (_COMBINE_DECODE, _COMBINE_DECODE + "  }\n"),
    ],
    # the verify combine finalising: acc / l where the unfinalised acc is
    # due (rows of more than one live split)
    "verify_combine_finalising": [
        ("split_common.cuh", _COMBINE_STORE,
         _COMBINE_STORE.replace("= as[r];", "= as[r] / fmaxf(ls[r], 1e-30f);")),
    ],
    # a padding row (qstart 0) of the verify read left unwritten
    "verify_padding_row_unwritten": [
        (_DEAD_VERIFY, "        if (true) continue;\n"),
    ],
    # an int8 block's K scales taken from the next split's first block
    "verify_int8_scale_from_the_wrong_split": [
        (_SCALE_SRC, _SCALE_SRC.replace(
            "scale_off(trow[jj])", "scale_off(trow[jj + (split + 1 < nlive) * bps])")),
    ],
    # rows 5 and 4 (the int8 decode): the new column's K and V scale
    # written by its owner only after its copies read the block
    "quant_scales_written_after_the_copies": [
        (_SCALE_WRITE, _SCALE_WRITE.replace("tid == 0) {", "tid == 0 && false) {")),
        (_FINAL, "  if (WRITE && split == nlive - 1) {\n"
         "    const int blk = trow[last / bs - j0];\n" + _SCALE_WRITE + "  }\n" + _FINAL),
    ],
    # an int8 block's K scales taken from the next split's first block
    "quant_scale_from_the_wrong_split": [
        (_SCALE_SRC, _SCALE_SRC.replace(
            "scale_off(trow[jj])",
            "scale_off(trow[jj + (!VERIFY && split + 1 < nlive) * bps])")),
    ],
    # the int8 decode's partial states combined in the order the splits
    # finish
    "quant_combine_in_arrival_order": [
        (_COMBINE_HEAD + _COMBINE_VERIFY + _COMBINE_DECODE,
         "  if constexpr (VERIFY || !QUANT) {\n" + _COMBINE_HEAD + _COMBINE_VERIFY
         + _COMBINE_DECODE + "  } else {\n" + _arrival_combine(False) + "  }\n"),
    ],
    # the owner of row 5's new column skips its write (bytes and scales)
    "quant_owner_write_skipped": [
        (_WRITE_IF, _WRITE_IF.replace("nlive - 1", "nlive - 1 && !QUANT")),
    ],
    # a length-0 row of row 4 left unwritten
    "quant_length_0_row_unwritten": [
        (_DEAD_DECODE, _DEAD_DECODE.replace("i < R * hd;", "i < R * hd && !QUANT;")),
    ],
    # the commit (rows 8, 9): a dead column (the one past commit_len)
    # written into the row's live block
    "commit_dead_column_written": [
        (_COMMIT_LIVE, _COMMIT_LIVE.replace("a.commit_len[b],", "a.commit_len[b] + 1,")),
    ],
    # the window's split at a block edge one column late: a block's first
    # column lands in the block before it
    "commit_block_edge_split_off_by_one": [
        ("min(max(pos / a.bs, 0), a.max_nb - 1)", "min(max((pos - 1) / a.bs, 0), a.max_nb - 1)"),
    ],
    # row 9: a kv-head's scales taken from the neighbouring kv-head
    "commit_scale_from_the_neighbouring_head": [
        ("* a.t_fed + t) * a.nkv + g;", "* a.t_fed + t) * a.nkv + (g + 1) % a.nkv;"),
    ],
    # each row's last live token not written
    "commit_last_live_token_dropped": [
        (_COMMIT_LIVE, _COMMIT_LIVE.replace("a.t_fed)) continue;", "a.t_fed) - 1) continue;")),
    ],
    # block 0 written: a live column whose table slot is the null block
    # (a padding row's) lands there
    "commit_block_0_written": [
        ("    if (blk == 0) continue;\n", ""),
    ],
}


def run_one(name):
    """In a copy's process: chip_smoke's paged checks (a commit mutant's
    copy: the commit's only), as one JSON line."""
    import traceback

    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    assert not pa.__file__.startswith(ROOT), pa.__file__
    _build.build_all(["paged_attention"])
    dev = torch.device("cuda", 0)
    out = {}
    checks = (("check_paged_update", chip_smoke.check_paged_update),
              ("check_paged_read", chip_smoke.check_paged_read),
              ("check_verify", chip_smoke.check_verify),
              ("check_quant", chip_smoke.check_quant),
              ("check_commit", chip_smoke.check_commit))
    if name.startswith("commit_"):
        checks = checks[-1:]
    for cname, fn in checks:
        try:
            fn(dev, {})
            out[cname] = "passes"
        except AssertionError:
            out[cname] = "fails: " + traceback.format_exc(limit=1)[-600:]
    print(json.dumps(out))


def build_one():
    sys.path.append(ROOT)
    from paddle_tpu_torch import _build
    _build.build_all(["paged_attention"])
    print(json.dumps({"built": True}))


def _run(mode, copy, name=""):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                             name],
                            cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _last_json(name, p, timeout):
    stdout, stderr = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def main(names):
    unknown = set(names) - set(MUTANTS)
    if unknown:
        sys.exit(f"unknown mutants {sorted(unknown)}; known: {list(MUTANTS)}")
    chosen = {n: e for n, e in MUTANTS.items()
              if n == "unchanged" or not names or n in names}
    tmp = tempfile.mkdtemp(prefix="paged_mutants_")
    copies, procs, record, good = {}, [], {}, True
    try:
        for name, edits in chosen.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            for edit in edits:
                fname, old, new = (("paged_attention.cu",) + edit)[-3:]
                path = os.path.join(pkg, "csrc", fname)
                src = open(path).read()
                assert src.count(old) == 1, (name, old)
                with open(path, "w") as f:
                    f.write(src.replace(old, new))
        procs = [(name, _run("--build", copies[name])) for name in chosen]
        for name, p in procs:
            _last_json(name, p, 900)
        for name in chosen:
            p = _run("--one", copies[name], name)
            procs.append((name, p))
            res = _last_json(name, p, 900)
            record[name] = res
            passed = all(v == "passes" for v in res.values())
            expected = name == "unchanged"
            good &= passed == expected
            print(f"{name}: checks {'pass' if passed else 'fail'} "
                  f"({'as expected' if passed == expected else 'WRONG'})")
            for check, verdict in res.items():
                print(f"  {check}: {verdict.strip()}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    elif sys.argv[1:2] == ["--build"]:
        build_one()
    else:
        main(sys.argv[1:])
