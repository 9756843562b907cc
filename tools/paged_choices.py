"""Times the design choices of the split walk (csrc/paged_attention.cu,
split_walk: rows 3 and 2, and 5 and 4 over int8 pools, paged_split_kernel;
rows 6 and 7, paged_verify_split_kernel) against each other on one card.

    python3 tools/paged_choices.py [FORM ...]

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, edited as its entry in FORMS says (a source edit of the kernel, or
the wrapper's SPLIT_TOKENS or VERIFY_HEIGHTS): the shipped form, and the
forms it was chosen over (FORMs pick some; the shipped form always runs):

  split_2_blocks, split_4_blocks  runs of 2 and 4 pool blocks a split
                                  (SPLIT_TOKENS 256, 512, a ring of two
                                  blocks) against one (rows 2-7);
  register_loads                  every K and V vector loaded from device
                                  memory into registers by the thread that
                                  uses it (the parent's walk's loads), no
                                  bulk copy and no ring, against one 1-D
                                  bulk copy per slice into shared memory;
  no_l2_warm                      no L2 prefetch of a split's blocks while
                                  its ticket is taken;
  k_and_v_together                a split of one block with K and V in
                                  flight together (two ring slots) against
                                  one slot, V's copy issued once K is read;
  half_pieces_two_slots           16 KB pieces through two slots against
                                  one 32 KB slot;

of the int8 decode (rows 5 and 4):

  quant_l2_warm                   the L2 warm-up of rows 3 and 2 against
                                  none;
  quant_look_back                 the look-back over int8 pools (P never
                                  rounded) against each split's recurrence
                                  from its own max;
  quant_copy_after_barrier        the first copies issued after the CTA's
                                  barrier, as rows 3 and 2 do, against
                                  before it (row 5's owner of the new
                                  column after its write);
  quant_pv_per_row                one V row's share a thread, summed over
                                  its lanes block by block (rows 3 and 2's
                                  P.V), against P.V in place over 2 V rows
                                  a thread as the verify read sums it;
  quant_pv_in_place_dr_4          in place over 4 V rows a thread (as the
                                  int8 verify read) against 2;

and of the verify read (rows 6 and 7):

  verify_pow2_heights             chunks of 2, 4 or 8 rows (llama_7b's 5
                                  rows padded to 8, as the parent's walk)
                                  against heights 2, 4, 5 and 8;
  verify_look_back_int8           int8 pools (P never rounded) with the
                                  look-back against each split's
                                  recurrence from its own max;
  verify_k_and_v_together         K and V of a one-block split in flight
                                  together (two slots) against one slot;
  verify_copy_after_barrier       the first copy issued after the CTA's
                                  barrier, as rows 3 and 2 do, against
                                  before it;
  verify_dr_2, verify_dr_4        P.V over 2 or 4 V rows a thread in
                                  every pool type against 2 (bf16, f32)
                                  and 4 (int8; the int8 decode keeps 2);
  verify_l2_warm                  the L2 warm-up of rows 3 and 2 (a split's
                                  blocks prefetched while its ticket is
                                  taken) against none.

Every copy builds at once, in a process of its own; then each copy runs
alone, in the order of FORMS and again in reverse, so that a drift of the
card over the call shows. A run of a decode form holds rows 3, 2, 5 and
4 to their plain versions (chip_smoke's ``check_paged_update``,
``check_paged_read`` and ``check_quant``), a run of a verify form rows 6
and 7 (``check_verify`` and ``check_quant``; the shipped form takes all
four), 
a run of an int8 decode form rows 5 and 4 (``check_quant``); every run
times rows 3, 2, 5, 4, 6 and 7 at chip_smoke's timing shape (B = 8, NH =
NKV = 32, HD = 128, bf16 or int8 pools, 3,865 context tokens, T = 5 fed
tokens for rows 6 and 7; device ms per call, 100 calls queued ahead,
chip_smoke's ``_time_ms``), rows 3 and 5 at the serve phase's profiled
decode step (the same heads, 8 rows of 1,001 tokens, 16-block tables) and
rows 6 and 7 at the profiled verify step's (8 rows of 600 cached tokens).
ptxas's registers and spills of each form's split kernels at bf16 and
int8, REP 1, and of its verify kernels at 5 rows are printed too. Needs one CUDA device and nvcc;
exits non-zero if a form fails its check; writes
chiprun_out/paged_choices.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RING_RULE = ("    const int nb = bps == 1 ? 1 : 2 * bps * npk < kRing ? 2 * bps * npk "
              ": kRing;")
_PIECE_AT = """  auto piece_at = [&](int i) -> const T* {  // piece i's rows, once landed
    if (i >= freed + nbuf) {  // the ring holds pieces still read: free them first
      __syncthreads();
      refill(i);
    }
    mbar_wait(&bar[i % nbuf], (i / nbuf) & 1);
    return reinterpret_cast<const T*>(ring + (size_t)(i % nbuf) * piece_bytes);
"""
REGISTER_LOADS = [
    (_PIECE_AT, "  auto piece_at = [&](int i) -> const T* {\n"
                "    return piece_src(i);\n"),
    ("    for (; issued < min(done + nbuf, total); ++issued) {",
     "    for (; issued < min(done + nbuf, total) && nbuf > 0; ++issued) {"),
    (_RING_RULE, "    const int nb = 0;"),
]
NO_L2_WARM = [
    ("        bulk_prefetch_l2(k_pool + off, slice);\n"
     "        bulk_prefetch_l2(v_pool + off, slice);\n", ""),
]
K_AND_V_TOGETHER = [(_RING_RULE, _RING_RULE.replace("bps == 1 ? 1", "bps == 1 ? 2"))]
HALF_PIECES = K_AND_V_TOGETHER + [("constexpr int kPieceBytes = 32768;",
                                   "constexpr int kPieceBytes = 16384;")]

_GEOMETRY = "bool split_geometry(int hd, int bs, int bps, int* prow, int* nbuf, size_t* smem) {"
_GEOMETRY_CALL = "  if (!split_geometry<T, R>(a.hd, a.bs, a.bps, &a.prow, &a.nbuf, &smem))"
VERIFY_K_AND_V = [
    (_GEOMETRY, _GEOMETRY.replace("size_t* smem)", "size_t* smem, bool pair = false)")),
    (_RING_RULE, _RING_RULE.replace("bps == 1 ? 1", "bps == 1 ? (pair ? 2 : 1)")),
    (_GEOMETRY_CALL, _GEOMETRY_CALL.replace("&smem)", "&smem, MODE == kVerify)")),
]
_EARLY = "    if (VERIFY || (QUANT && !(WRITE && z == nlive - 1))) {\n"
_LATE = "  if constexpr (!VERIFY) refill(0);"
VERIFY_AFTER_BARRIER = [
    ("    if (VERIFY && nlive > 1) z = take_ticket(gsync);\n", ""),
    ("    if (!VERIFY && nlive > 1) z = take_ticket(gsync);\n",
     "    if (nlive > 1) z = take_ticket(gsync);\n"),
    (_EARLY, _EARLY.replace("VERIFY || ", "")),
    (_LATE, "  refill(0);"),
]

# name -> {"edits": edits of csrc/paged_attention.cu, "tokens": SPLIT_TOKENS,
# "heights": VERIFY_HEIGHTS, "rows": the rows it changes}
FORMS = {
    "shipped": dict(rows="all"),
    "split_2_blocks": dict(tokens=256),
    "split_4_blocks": dict(tokens=512),
    "register_loads": dict(edits=REGISTER_LOADS),
    "no_l2_warm": dict(edits=NO_L2_WARM),
    "k_and_v_together": dict(edits=K_AND_V_TOGETHER),
    "half_pieces_two_slots": dict(edits=HALF_PIECES),
    "verify_pow2_heights": dict(heights=(2, 4, 8), rows="verify"),
    "verify_look_back_int8": dict(edits=[(
        "  if (nlive > 1 && !QUANT) {\n    if (tid == 0) publish_max",
        "  if (nlive > 1) {\n    if (tid == 0) publish_max")],
        rows="verify"),
    "verify_k_and_v_together": dict(edits=VERIFY_K_AND_V, rows="verify"),
    "verify_copy_after_barrier": dict(edits=VERIFY_AFTER_BARRIER,
                                      rows="verify"),
    "verify_dr_2": dict(edits=[("!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
                                "!INPLACE ? 1 : 2;")],
                        rows="verify"),
    "verify_dr_4": dict(edits=[("!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
                                "!INPLACE ? 1 : VERIFY ? 4 : 2;")],
                        rows="verify"),
    "verify_l2_warm": dict(edits=[(
        "    if (!VERIFY && !QUANT && nlive > 1) {\n      const int z0",
        "    if ((VERIFY || !QUANT) && nlive > 1 && chunk == 0) {\n"
        "      const int z0")],
        rows="verify"),
    "quant_l2_warm": dict(edits=[(
        "    if (!VERIFY && !QUANT && nlive > 1) {\n      const int z0",
        "    if (!VERIFY && nlive > 1) {\n      const int z0")],
        rows="quant"),
    "quant_look_back": dict(edits=[(
        "  if (nlive > 1 && !QUANT) {\n    if (tid == 0) publish_max",
        "  if (nlive > 1 && (!QUANT || !VERIFY)) {\n    if (tid == 0) publish_max")],
        rows="quant"),
    "quant_copy_after_barrier": dict(edits=[(
        _EARLY, _EARLY.replace(" || (QUANT && !(WRITE && z == nlive - 1))", ""))],
        rows="quant"),
    "quant_pv_per_row": dict(edits=[(
        "  constexpr bool INPLACE = VERIFY || QUANT;",
        "  constexpr bool INPLACE = VERIFY;")], rows="quant"),
    "quant_pv_in_place_dr_4": dict(edits=[(
        "!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
        "!INPLACE ? 1 : QUANT ? 4 : 2;")], rows="quant"),
}


def _chip_smoke():
    sys.path.append(ROOT)
    import chip_smoke
    return chip_smoke


def build_one():
    """In a copy's process: build, print ptxas's lines as JSON."""
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch import _build
    _build.build_all(["paged_attention"])
    lines = [ln for ln in chip_smoke.ptxas_lines(
        _build.BUILD_LOGS.get("paged_attention", ""))
        if ln.startswith(("paged_split_kernelI13__nv_bfloat16Li1E",
                          "paged_split_kernelIaLi1E",
                          "paged_verify_split_kernelI13__nv_bfloat16Li5E",
                          "paged_verify_split_kernelIaLi5E"))]
    print(json.dumps(lines))


def run_one(name):
    """In a copy's process: check and time, as one JSON line."""
    import traceback

    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.ops import paged_attention as pa
    assert not pa.__file__.startswith(ROOT), pa.__file__
    form = FORMS[name]
    if form.get("tokens"):
        pa.SPLIT_TOKENS = form["tokens"]
    if form.get("heights"):
        pa.VERIFY_HEIGHTS = form["heights"]
    dev = torch.device("cuda", 0)
    rows = form.get("rows", "decode")
    checks = []
    if rows in ("all", "decode"):
        checks += [("check_paged_update", cs.check_paged_update),
                   ("check_paged_read", cs.check_paged_read)]
    if rows in ("all", "verify"):
        checks += [("check_verify", cs.check_verify)]
    checks += [("check_quant", cs.check_quant)]
    check = {}
    for cname, fn in checks:
        try:
            fn(dev, {})
            check[cname] = "passes"
        except AssertionError:
            check[cname] = "fails: " + traceback.format_exc(limit=1)[-600:]
    a = cs._paged_inputs(32, 32, cs.PAGED_POSITIONS, cs.SEED + 32, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    rd = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["positions"] + 1,
          a["layer"])
    ms = {"paged_attend_update (row 3)":
          cs._time_ms(lambda: pa.paged_attend_update(*upd), 100)[0],
          "paged_attention (row 2)":
          cs._time_ms(lambda: pa.paged_attention(*rd), 100)[0]}
    a = cs._paged_inputs(32, 32, cs.PAGED_STEP_POSITIONS, cs.SEED + 33, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    ms["paged_attend_update (row 3), even rows"] = cs._time_ms(
        lambda: pa.paged_attend_update(*upd), 100)[0]
    splits = pa.kernel_splits(a["tables"].shape[1], 128)
    del a, upd, rd
    for key, positions, width, seed in (
            ("", cs.PAGED_POSITIONS, None, 71),
            (", even rows", cs.PAGED_STEP_POSITIONS, 16, 75)):
        a = cs._quant_inputs(32, 32, positions, cs.SEED + seed, dev,
                             torch.bfloat16, max_nb=width)
        pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        new = [a[k][-1, :, 0].contiguous()
               for k in ("new_k", "new_v", "new_ks", "new_vs")]
        upd = (a["q"], *new, *pools, a["tables"], a["rows"], a["layer"])
        rd = (a["q"], *pools, a["tables"], a["rows"] + 1, a["layer"])
        ms[f"paged_attend_update_quant (row 5){key}"] = cs._time_ms(
            lambda: pa.paged_attend_update_quant(*upd), 100)[0]
        ms[f"paged_attention_quant (row 4){key}"] = cs._time_ms(
            lambda: pa.paged_attention_quant(*rd), 100)[0]
        del a, pools, new, upd, rd
    T = cs.SPEC_K + 1
    qstart = [p + 1 for p in cs.PAGED_POSITIONS]
    for key, rows_q, width, seed in (
            ("", qstart, None, 0),
            (", even rows", cs.VERIFY_STEP_QSTART, cs.VERIFY_STEP_MAX_NB, 2)):
        a = cs._verify_inputs(32, 32, rows_q, T, cs.SEED + 61 + seed, dev,
                              max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                a["layer"])
        ms[f"paged_attention_verify (row 6){key}"] = cs._time_ms(
            lambda: pa.paged_attention_verify(*call), 100)[0]
        a = cs._quant_inputs(32, 32, rows_q, cs.SEED + 72 + seed, dev,
                             torch.bfloat16, T=T, max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        ms[f"paged_attention_verify_quant (row 7){key}"] = cs._time_ms(
            lambda: pa.paged_attention_verify_quant(*call), 100)[0]
        del a, call
    print(json.dumps({"ok": all(v == "passes" for v in check.values()),
                      "splits": splits, "ms": ms, "check": check}))


def _run(args, copy):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _last_json(name, p, timeout):
    stdout, stderr = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def main(names):
    unknown = set(names) - set(FORMS)
    if unknown:
        sys.exit(f"unknown forms {sorted(unknown)}; known: {list(FORMS)}")
    forms = {n: f for n, f in FORMS.items()
             if n == "shipped" or not names or n in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    tmp = tempfile.mkdtemp(prefix="paged_choices_")
    copies, procs = {}, []
    record = {"nvidia_smi": smi, "ptxas": {}, "runs": []}
    good = True
    try:
        for name, form in forms.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "paged_attention.cu")
            src = open(cu).read()
            for old, new in form.get("edits", []):
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(cu, "w") as f:
                f.write(src)
        procs = [(name, _run(["--build"], copies[name])) for name in forms]
        for name, p in procs:
            record["ptxas"][name] = _last_json(name, p, 900)
            for line in record["ptxas"][name]:
                print(f"{name} ptxas {line}")
        for name in list(forms) + list(reversed(forms)):
            p = _run(["--one", name], copies[name])
            procs.append((name, p))
            run = dict(form=name, **_last_json(name, p, 900))
            record["runs"].append(run)
            good &= run["ok"]
            print(json.dumps({k: run[k] for k in ("form", "ok", "splits",
                                                  "ms")}))
            if not run["ok"]:
                print(f"{name} FAILED its check: {run['check']}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_choices.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main(sys.argv[1:])
