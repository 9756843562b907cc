"""Shows that chip_smoke.py's plain-attention check fails a wrong plain path.

    python3 tools/plain_attention_mutants.py [NAME ...]

Copies paddle_tpu_torch/ (its built kernels included) into a temporary
directory once per mutant, writes one deliberate fault into the copy's
nn/functional/attention.py (``_xla_sdpa``, the attention of
``ParallelConfig(use_flash=False)``), and runs chip_smoke's
``train_policies`` on the copy in a process of its own, one copy at a
time, with only ``full`` and ``full, use_flash=False``: llama_7b's width,
16 layers, B 4, S 2048, bf16. The plain path is held to the flash path
(PLAIN_LOSS_REL, PLAIN_GRAD_REL) and, leaf by leaf beside it, to an f32
reference whose attention is torch's SDPA (PLAIN_GRAD_RATIO), so a
fault in ``_xla_sdpa`` cannot reach the reference. The unchanged copy
must pass and every faulty one must fail. NAMEs pick mutants (the
unchanged copy always runs). Needs one CUDA device with about 60 GB free
and nvcc; prints each copy's per-leaf table and verdict, writes
chiprun_out/plain_attention_mutants.json and exits non-zero unless every
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

_LOGITS = 'logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s\n'
_MASK = "diagonal=sk - sq + 1)"

# name -> [(text, replacement)] in nn/functional/attention.py; each text
# occurs once
MUTANTS = {
    "unchanged": [],
    # the logits scaled twice as much as 1/sqrt(D)
    "logits_scaled_by_2": [(_LOGITS, _LOGITS.replace("* s", "* (2 * s)"))],
    # a quarter too much
    "logits_scaled_by_1.25": [
        (_LOGITS, _LOGITS.replace("* s", "* (1.25 * s)"))],
    # each query also sees the key one past it
    "causal_mask_one_key_late": [(_MASK, _MASK.replace("+ 1", "+ 2"))],
    # no causal mask at all
    "causal_mask_dropped": [("    if is_causal:\n", "    if False:\n")],
}


def run_one():
    """In a copy's process: train_policies on full and the plain path;
    its output, then one JSON line with the verdict."""
    import traceback

    import torch
    sys.path.append(ROOT)
    import chip_smoke
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.nn.functional import attention
    assert not attention.__file__.startswith(ROOT), attention.__file__
    _build.build_all(["rms_norm", "flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.POLICY_RUNS = [("full", None), ("full", False)]
    try:
        chip_smoke.train_policies(torch.device("cuda", 0))
        out = {"train_policies": "passes"}
    except AssertionError:
        out = {"train_policies": "fails: "
               + traceback.format_exc(limit=1)[-600:]}
    print(json.dumps(out))


def main(names):
    unknown = set(names) - set(MUTANTS)
    if unknown:
        sys.exit(f"unknown mutants {sorted(unknown)}; known: {list(MUTANTS)}")
    chosen = {n: e for n, e in MUTANTS.items()
              if n == "unchanged" or not names or n in names}
    tmp = tempfile.mkdtemp(prefix="plain_attention_mutants_")
    record, good, p = {}, True, None
    try:
        for name, edits in chosen.items():
            copy = os.path.join(tmp, name)
            pkg = os.path.join(copy, "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("__pycache__"))
            path = os.path.join(pkg, "nn", "functional", "attention.py")
            src = open(path).read()
            for old, new in edits:
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(path, "w") as f:
                f.write(src)
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--one"],
                cwd=copy, env=dict(os.environ, PYTHONPATH=copy), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            stdout, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"{name}: exit {p.returncode}\n"
                                   f"{stderr[-4000:]}")
            lines = stdout.strip().splitlines()
            res = json.loads(lines[-1])
            passed = res["train_policies"] == "passes"
            expected = name == "unchanged"
            good &= passed == expected
            record[name] = dict(res, output=lines[:-1])
            print(f"{name}: check {'passes' if passed else 'fails'} "
                  f"({'as expected' if passed == expected else 'WRONG'})")
            print("\n".join("  " + line for line in lines[:-1]
                            if not line.startswith("==")))
            if not passed:
                print(f"  {res['train_policies'].strip()}")
            shutil.rmtree(copy, ignore_errors=True)
    finally:
        if p is not None and p.poll() is None:
            p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "plain_attention_mutants.json"), "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one()
    else:
        main(sys.argv[1:])
