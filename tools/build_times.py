"""Time the kernel build of two trees on one machine, each from a clean
build directory, and compare their ptxas reports.

    python3 tools/build_times.py BEFORE AFTER

BEFORE and AFTER are checkouts of the repository (e.g. a ``git archive``
of the parent unpacked under the git-ignored ``archive_check/``, and
``.``). Each tree is built in a process of its own, which imports that
tree's ``paddle_tpu_torch._build`` and points its ``BUILD_DIR`` at a
fresh temporary directory, one tree after the other so that the two never
share the cores. In a tree every source of chip_smoke's build phase is
built by a thread of its own, all started together as ``build_all``
starts them, so each thread's wall seconds are that source's own; a tree
whose ``_build`` records ``BUILD_SECONDS`` (its parts and link) adds
them. Prints one JSON line per tree (the build's wall seconds, each
source's, the parts', the card from nvidia-smi) and one line comparing
the ptxas register and spill reports (``chip_smoke.ptxas_lines``)
kernel by kernel; exits non-zero if a kernel's report differs or the
AFTER tree compiles a kernel the BEFORE tree does not. Needs nvcc and
nvidia-smi (the card's machine); writes chiprun_out/build_times.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["rms_norm", "paged_attention", "flash_attention",
           "grouped_matmul", "decode_attention", "flash_varlen"]


def build_tree() -> dict:
    """In the tree's process (cwd the tree): build every source from a
    clean directory, one thread a source."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from paddle_tpu_torch import _build
    assert _build.__file__.startswith(os.getcwd()), _build.__file__
    out = {"tree": os.getcwd(), "sources_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = Path(tmp)
        errors = []

        def one(name):
            t0 = time.perf_counter()
            try:
                _build.build_all([name])
            except Exception as e:     # reported below, the run fails
                errors.append(f"{name}: {e}")
            out["sources_s"][name] = time.perf_counter() - t0
        threads = [threading.Thread(target=one, args=(n,)) for n in SOURCES]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["build_s"] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
    out["nvcc_s"] = dict(getattr(_build, "BUILD_SECONDS", {}))
    out["ptxas"] = {n: sorted(chip_smoke.ptxas_lines(_build.BUILD_LOGS[n]))
                    for n in SOURCES}
    return out


def compare_ptxas(before, after) -> dict:
    """The two reports by kernel (each line's "kernel: " prefix): the
    kernels whose lines differ, and those compiled in one tree only."""
    def by_kernel(lines):
        out = {}
        for line in lines:
            out.setdefault(line.split(": ", 1)[0], []).append(line)
        return out
    b, a = by_kernel(before), by_kernel(after)
    return {"kernels": len(a),
            "differ": sorted(k for k in set(a) & set(b) if a[k] != b[k]),
            "only_before": sorted(set(b) - set(a)),
            "only_after": sorted(set(a) - set(b))}


def main():
    if sys.argv[1:] == ["--tree"]:
        print(json.dumps(build_tree()))
        return
    before, after = (os.path.abspath(p) for p in sys.argv[1:3])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    res = {"card": card}
    for tag, tree in (("before", before), ("after", after)):
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree"], cwd=tree, capture_output=True,
                             text=True, timeout=1200)
        if got.returncode:
            sys.exit(f"{tag} ({tree}) failed:\n{got.stderr[-4000:]}")
        res[tag] = json.loads(got.stdout.strip().splitlines()[-1])
        print(json.dumps({tag: {k: v for k, v in res[tag].items()
                                if k != "ptxas"}, "card": card}))
    cmp = {n: compare_ptxas(res["before"]["ptxas"][n],
                            res["after"]["ptxas"][n]) for n in SOURCES}
    print(json.dumps({"ptxas": cmp}))
    res["ptxas_compared"] = cmp
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "build_times.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    sys.exit(1 if any(c["differ"] or c["only_after"]
                      for c in cmp.values()) else 0)


if __name__ == "__main__":
    main()
