"""Times the design choices of the bf16 grouped-matmul forward and dX
(rows 24 and 25, csrc/grouped_matmul.cu) against each other on one card.

    python3 tools/gmm_choices.py

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, edited as its entry in FORMS says: the shipped form, and the
forms it was chosen over (one work item a CTA against persistent CTAs,
and 4-byte pair stores against the output staged through shared memory;
a 256-column block, the third choice, lost too and was removed with its
code, so it is no longer a form here). Every copy
builds at once, in a process of its own; then each copy runs alone, in
the order of FORMS and again in reverse, so that a drift of the card over
the call shows. A run checks the forward and dX against their plain
versions (chip_smoke's ``gmm_case``: the ERNIE slice at both MOE_SHAPES
and the bf16 small layouts at K = 256, N = 192 and 256, and at K = 384,
N = 256), times them (device ms per call, 50 calls queued ahead,
chip_smoke's ``_time_ms``) on the ERNIE slice at both MOE_SHAPES, and
reads their drift along an f64 product (chip_smoke's ``gmm_drifts``).
ptxas's registers and spills of each form's kernels are printed too.
Needs one CUDA device and nvcc; exits non-zero if a form fails its
check; writes chiprun_out/gmm_choices.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (old, new) replacements in csrc/grouped_matmul.cu, each met once
# a grid of one CTA a work item
ONE_ITEM = ("kernel<<<min(items, sms),", "kernel<<<items,")
# each thread stores its accumulator's bf16 pairs (4 bytes) straight to
# device memory, as the dW kernel does; no staging rows
PAIR_STORE = [
    ("OFF_BAR = OFF_OUT + 2 * 64 * OUT_LD;", "OFF_BAR = OFF_OUT;"),
    ("    mm_store(acc, lv, sm + C::OFF_OUT + wg * 64 * C::OUT_LD, "
     "o + (size_t)64 * wg * no, no, nw);\n",
     "    const int rw = 64 * wg + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);\n"
     "#pragma unroll\n"
     "    for (int j = 0; j < 16; ++j) {\n"
     "      if (8 * j >= nw) break;\n"
     "      bf16* p = o + (size_t)rw * no + 8 * j + 2 * (tid & 3);\n"
     "      st_pair(p, lv ? acc[4 * j] : 0.f, lv ? acc[4 * j + 1] : 0.f);\n"
     "      st_pair(p + (size_t)8 * no, lv ? acc[4 * j + 2] : 0.f,\n"
     "              lv ? acc[4 * j + 3] : 0.f);\n"
     "    }\n"),
]
FORMS = {
    "shipped": [],
    "one_item_a_cta": [ONE_ITEM],
    "pair_store": PAIR_STORE,
    "one_item_a_cta_pair_store": [ONE_ITEM] + PAIR_STORE,
}


def _chip_smoke():
    sys.path.append(ROOT)
    import chip_smoke
    return chip_smoke


def build_one():
    """In a copy's process: build, print ptxas's lines as JSON."""
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch import _build
    _build.build_all(["grouped_matmul"])
    lines = [ln for ln in chip_smoke.ptxas_lines(
        _build.BUILD_LOGS.get("grouped_matmul", ""))
        if ln.startswith(("gmm_fwd_wg", "gmm_dx_wg"))]
    print(json.dumps(lines))


def run_one():
    """In a copy's process: check, time, drift, as one JSON line."""
    import torch
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert not tg.__file__.startswith(ROOT), tg.__file__
    dev = torch.device("cuda", 0)
    counts, n_rows, sched = chip_smoke._slice_schedule(dev)
    cases = [(counts, n_rows, sched, k, n) for k, n in chip_smoke.MOE_SHAPES]
    for _, cl in chip_smoke.GMM_SMALL:
        c = torch.tensor(cl, dtype=torch.int32, device=dev)
        rows = int(tg._round_up(c, 128).sum()) + 2 * 128
        sc = tg.tile_schedule(c, rows // 128, 128)[:2]
        cases += [(c, rows, sc, k, n) for k, n in ((256, 192), (256, 256),
                                                    (384, 256))]
    check = []
    for i, (c, rows, sc, k, n) in enumerate(cases):
        try:
            res = chip_smoke.gmm_case(tg, c, rows, sc, torch.bfloat16, k, n,
                                      chip_smoke.SEED + i, dev)
            ok = all(res[x][0] for x in ("gmm_fwd", "gmm_dx"))
        except AssertionError as e:     # a dead tile not zero
            ok, res = False, str(e)
        check.append({"case": f"{c.tolist()} K={k} N={n}", "ok": ok,
                      "res": res})
    ms = {}
    e = counts.shape[0]
    for k, n in chip_smoke.MOE_SHAPES:
        lhs, rhs, dout = chip_smoke._gmm_operands(dev, torch.bfloat16,
                                                  n_rows, e, k, n, 0)
        ms[f"gmm_fwd[K={k},N={n}]"] = chip_smoke._time_ms(
            lambda: tg.gmm_fwd(lhs, rhs, sched), 50)[0]
        ms[f"gmm_dx[K={k},N={n}]"] = chip_smoke._time_ms(
            lambda: tg.gmm_dx(dout, rhs, sched), 50)[0]
        del lhs, rhs, dout
    drift = {key: {"kernel": dk, "plain": dp,
                   "ok": chip_smoke.dw_drift_ok(dk, dp)}
             for key, (dk, dp) in chip_smoke.gmm_drifts(tg, dev).items()}
    print(json.dumps({"ok": all(c["ok"] for c in check), "ms": ms,
                      "drift": drift, "check": check}))


def _run(mode, copy):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode],
                            cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _last_json(name, p, timeout):
    stdout, stderr = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    tmp = tempfile.mkdtemp(prefix="gmm_choices_")
    copies, procs = {}, []
    record = {"nvidia_smi": smi, "ptxas": {}, "runs": []}
    good = True
    try:
        for name, edits in FORMS.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
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
        procs = [(name, _run("--build", copies[name])) for name in FORMS]
        for name, p in procs:
            record["ptxas"][name] = _last_json(name, p, 900)
            for line in record["ptxas"][name]:
                print(f"{name} ptxas {line}")
        for name in list(FORMS) + list(reversed(FORMS)):
            p = _run("--one", copies[name])
            procs.append((name, p))
            run = dict(form=name, **_last_json(name, p, 900))
            record["runs"].append(run)
            good &= run["ok"] and all(d["ok"] for d in run["drift"].values())
            print(json.dumps({k: run[k] for k in ("form", "ok", "ms",
                                                  "drift")}))
            if not run["ok"]:
                print(f"{name} FAILED its check: "
                      f"{[c for c in run['check'] if not c['ok']]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gmm_choices.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one()
    else:
        main()
