"""Shows that chip_smoke.py's RMSNorm check fails a wrong kernel.

    python3 tools/rms_mutants.py [NAME ...]

Copies paddle_tpu_torch/ into a temporary directory once per mutant, writes
one deliberate fault into the copy's csrc/rms_norm.cu (row 1), and runs
chip_smoke's ``check_rms`` on the copy's kernel in a process of its own
(all copies build at once, then run one at a time): rows 1 to 8,192 of
widths 1024 to 5120 in bf16 (RMS_TOL and, rel frob, RMS_SCHEDULE_FROB)
and f32 (RMS_TOL_F32), an odd eps, a row of zeros, the output memory
poisoned with NaN, the same bits twice. The unchanged copy must pass and
every faulty one must fail. NAMEs pick mutants (the unchanged copy always
runs). Needs one CUDA device and nvcc; prints each copy's verdict and the
check's message, writes chiprun_out/rms_mutants.json and exits non-zero
unless every verdict is as expected.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_OUT = "oe[j] = from_f<T>(to_f(e[j]) * inv * to_f(we[j]));"
_INV = "const float inv = rsqrtf(total / (float)h + eps);"

# name -> [(text, replacement)] in csrc/rms_norm.cu; each text occurs once
MUTANTS = {
    "unchanged": [],
    # x * inv rounded to the output type before w multiplies it (HF's
    # order, not the TPU kernel's)
    "w_after_the_cast": [
        (_OUT, "oe[j] = from_f<T>(to_f(from_f<T>(to_f(e[j]) * inv)) * to_f(we[j]));"),
    ],
    # the mean of squares taken over H - 1
    "mean_over_h_minus_1": [
        (_INV, _INV.replace("(float)h", "(float)(h - 1)")),
    ],
    # eps left out of the rsqrt
    "eps_dropped": [
        (_INV, _INV.replace(" + eps", "")),
    ],
    # the row's last 16-byte vector neither summed nor written
    "last_vector_skipped": [
        ("const int nvec = h / VEC, tid", "const int nvec = h / VEC - 1, tid"),
    ],
}


def run_one():
    """In a copy's process: chip_smoke's RMSNorm check, as one JSON line."""
    import traceback

    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import rms_norm as rn
    assert not rn.__file__.startswith(ROOT), rn.__file__
    _build.build_all(["rms_norm"])
    dev = torch.device("cuda", 0)
    try:
        chip_smoke.check_rms(dev, {})
        out = {"check_rms": "passes"}
    except AssertionError:
        out = {"check_rms": "fails: " + traceback.format_exc(limit=1)[-600:]}
    print(json.dumps(out))


def build_one():
    sys.path.append(ROOT)
    from paddle_tpu_torch import _build
    _build.build_all(["rms_norm"])
    print(json.dumps({"built": True}))


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


def main(names):
    unknown = set(names) - set(MUTANTS)
    if unknown:
        sys.exit(f"unknown mutants {sorted(unknown)}; known: {list(MUTANTS)}")
    chosen = {n: e for n, e in MUTANTS.items()
              if n == "unchanged" or not names or n in names}
    tmp = tempfile.mkdtemp(prefix="rms_mutants_")
    copies, procs, record, good = {}, [], {}, True
    try:
        for name, edits in chosen.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            path = os.path.join(pkg, "csrc", "rms_norm.cu")
            src = open(path).read()
            for old, new in edits:
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(path, "w") as f:
                f.write(src)
        procs = [(name, _run("--build", copies[name])) for name in chosen]
        for name, p in procs:
            _last_json(name, p, 900)
        for name in chosen:
            p = _run("--one", copies[name])
            procs.append((name, p))
            res = _last_json(name, p, 900)
            record[name] = res
            passed = all(v == "passes" for v in res.values())
            expected = name == "unchanged"
            good &= passed == expected
            print(f"{name}: check {'passes' if passed else 'fails'} "
                  f"({'as expected' if passed == expected else 'WRONG'})")
            for check, verdict in res.items():
                print(f"  {check}: {verdict.strip()}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rms_mutants.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one()
    elif sys.argv[1:2] == ["--build"]:
        build_one()
    else:
        main(sys.argv[1:])
