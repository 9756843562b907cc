"""Times the design choices of the split decode walk of rows 3 and 2
(csrc/paged_attention.cu, paged_split_kernel) against each other on one
card.

    python3 tools/paged_choices.py [FORM ...]

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, edited as its entry in FORMS says (a source edit of the kernel, or
the wrapper's SPLIT_TOKENS): the shipped form, and the forms it was
chosen over (FORMs pick some; the shipped form always runs):

  split_2_blocks, split_4_blocks  runs of 2 and 4 pool blocks a split
                                  (SPLIT_TOKENS 256, 512, a ring of two
                                  blocks) against one;
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
                                  one 32 KB slot.

Every copy builds at once, in a process of its own; then each copy runs
alone, in the order of FORMS and again in reverse, so that a drift of the
card over the call shows. A run holds rows 3 and 2 to their plain
versions (chip_smoke's ``check_paged_update`` and ``check_paged_read``)
and times them at chip_smoke's timing shape (B = 8, NH = NKV = 32, HD =
128, bf16, 3,865 context tokens; device ms per call, 100 calls queued
ahead, chip_smoke's ``_time_ms``), and row 3 at the serve phase's
profiled decode step (the same heads, 8 rows of 1,001 tokens). ptxas's registers and spills of each
form's split kernels at bf16 and REP 1 are printed too. Needs one CUDA
device and nvcc; exits non-zero if a form fails its check; writes
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

# name -> (edits of csrc/paged_attention.cu, SPLIT_TOKENS or None)
FORMS = {
    "shipped": ([], None),
    "split_2_blocks": ([], 256),
    "split_4_blocks": ([], 512),
    "register_loads": (REGISTER_LOADS, None),
    "no_l2_warm": (NO_L2_WARM, None),
    "k_and_v_together": (K_AND_V_TOGETHER, None),
    "half_pieces_two_slots": (HALF_PIECES, None),
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
        if ln.startswith("paged_split_kernelI13__nv_bfloat16Li1E")]
    print(json.dumps(lines))


def run_one(split_tokens):
    """In a copy's process: check and time, as one JSON line."""
    import traceback

    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.ops import paged_attention as pa
    assert not pa.__file__.startswith(ROOT), pa.__file__
    if split_tokens:
        pa.SPLIT_TOKENS = split_tokens
    dev = torch.device("cuda", 0)
    check = {}
    for name, fn in (("check_paged_update", cs.check_paged_update),
                     ("check_paged_read", cs.check_paged_read)):
        try:
            fn(dev, {})
            check[name] = "passes"
        except AssertionError:
            check[name] = "fails: " + traceback.format_exc(limit=1)[-600:]
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
        for name, (edits, _) in forms.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "paged_attention.cu")
            src = open(cu).read()
            for old, new in edits:
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
            tokens = forms[name][1]
            p = _run(["--one", str(tokens or 0)], copies[name])
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
        run_one(int(sys.argv[2]))
    else:
        main(sys.argv[1:])
