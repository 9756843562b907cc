"""Per-CTA phase timeline of the paged split walk on one card.

    python3 tools/paged_timeline.py

Copies paddle_tpu_torch/ into a temporary directory, edits the copy's
csrc/paged_attention.cu so that thread 0 of every CTA of the split walk
(split_walk: rows 3 and 2, and 5 and 4 over int8 pools,
paged_split_kernel; rows 6 and 7, paged_verify_split_kernel) stamps the
card's global timer (%globaltimer, ns) at the end of each phase into a
device buffer, and runs one launch of rows 6 and 7 at chip_smoke's timing
shape (B = 8, NH = NKV = 32, HD = 128, T = 5, 3,865 cached tokens) and row
6 at the profiled verify step's even rows (8 x 600), and rows 3 and 5 at
their timing shape and at the serve step's even rows (8 x 1,001, 16-block
tables), each after three warm-up launches. For each launch it
prints, over the live CTAs, the 10th, 50th and 90th percentile in us of
the phases

  ticket        start to the CTA's first barrier (the ticket, the L2
                warm-up of the decode rows, q, the verify read's first
                copy)
  K+scores      the K copies landed and every score of the split summed
  lookback      the split's max published and the earlier ones read
  softmax+V+PV  P, the V copies and P.V
  write+sync    the partial state written and the done count taken
  combine       the last split's ordered combine
  lifetime      start to end

and the span of the launch, the dead CTAs' lifetime and the mean number of
live CTAs resident on an SM (their summed lifetimes over the span and 132
SMs). The stamps add a few global stores per CTA. Needs one CUDA device
and nvcc; writes chiprun_out/paged_timeline.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 10  # stamps a CTA: 0 start ... 6 combine end, 7 split, 8 dead

EDITS = [
    ("enum : int { kUpdate = 0, kRead = 1, kVerify = 2 };",
     "enum : int { kUpdate = 0, kRead = 1, kVerify = 2 };\n"
     "__device__ unsigned long long* g_tr;\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"),
    ("  const int nlive = (nblk + bps - 1) / bps;\n",
     "  const int nlive = (nblk + bps - 1) / bps;\n"
     "  const unsigned long long tr0 = gtimer();\n"
     "  unsigned long long* trp = g_tr + (((size_t)blockIdx.z * gridDim.y + blockIdx.y)"
     " * gridDim.x + blockIdx.x) * 10;\n"),
    ("  if ((int)blockIdx.z >= max(nlive, 1)) return;  // no live token in this split\n",
     "  if ((int)blockIdx.z >= max(nlive, 1)) {\n"
     "    if (threadIdx.x == 0) { trp[0] = tr0; trp[8] = 1; trp[5] = gtimer(); }\n"
     "    return;\n  }\n"),
    ("  set_split(split_s);\n",
     "  set_split(split_s);\n"
     "  if (tid == 0) { trp[0] = tr0; trp[1] = gtimer(); trp[7] = split; }\n"),
    ("  __syncthreads();  // bm_s is complete\n",
     "  __syncthreads();  // bm_s is complete\n  if (tid == 0) trp[2] = gtimer();\n"),
    ("  // 4. the online softmax over the split's blocks from that max: P\n",
     "  if (tid == 0) trp[3] = gtimer();\n"
     "  // 4. the online softmax over the split's blocks from that max: P\n"),
    ("  // 5. one live split writes its result",
     "  if (tid == 0) trp[4] = gtimer();\n  // 5. one live split writes its result"),
    ("    }\n    return;\n  }\n  if (tid == 0) {\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      mypart[R + r] = m[r];",
     "    }\n    if (tid == 0) trp[5] = gtimer();\n    return;\n  }\n  if (tid == 0) {\n"
     "#pragma unroll\n    for (int r = 0; r < R; ++r) {\n      mypart[R + r] = m[r];"),
    ("  if (!last_split(gsync, nlive, &last_s)) return;\n",
     "  const bool is_last = last_split(gsync, nlive, &last_s);\n"
     "  if (tid == 0) trp[5] = gtimer();\n  if (!is_last) return;\n"),
    ("  if constexpr (VERIFY)\n    combine_splits<R, false>",
     "  if constexpr (VERIFY) {\n    combine_splits<R, false>"),
    ("  else\n    combine_splits<R>(gpart, pstride, nlive, hd, nt, a.out + q_off, part_s, gsync);\n",
     "  } else {\n"
     "    combine_splits<R>(gpart, pstride, nlive, hd, nt, a.out + q_off, part_s, gsync);\n"
     "  }\n  if (tid == 0) trp[6] = gtimer();\n"),
]
HOST = ('\nextern "C" int paged_timeline_buffer(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_tr, &p, sizeof(p));\n}\n')
PHASES = {"ticket": (0, 1), "K+scores": (1, 2), "lookback": (2, 3),
          "softmax+V+PV": (3, 4), "write+sync": (4, 5)}


def _percentiles(x):
    return [round(float(np.percentile(x, q)) / 1e3, 3) for q in (10, 50, 90)]


def summarise(stamps, name):
    """The phases of one launch's CTAs (stamps [CTAs, SLOTS] ns)."""
    t = stamps[stamps[:, 0] > 0].astype(np.int64)
    dead = t[:, 8] == 1
    live = t[~dead]
    end = np.maximum(live[:, 5], live[:, 6])
    t0 = t[:, 0].min()
    span = (max(t[:, 5].max(), t[:, 6].max()) - t0) / 1e3
    out = {"name": name, "span_us": span, "live": int(len(live)),
           "dead": int(dead.sum())}
    for phase, (a, b) in PHASES.items():
        out[phase] = _percentiles(live[:, b] - live[:, a])
    last = live[live[:, 6] > 0]
    out["combine"] = _percentiles(last[:, 6] - last[:, 5])
    out["lifetime"] = _percentiles(end - live[:, 0])
    if dead.any():
        out["dead_lifetime"] = _percentiles(t[dead, 5] - t[dead, 0])
    out["mean_live_ctas_per_sm"] = round(
        float((end - live[:, 0]).sum()) / 1e3 / span / 132, 2)
    print(json.dumps(out))
    return out


def run():
    """In the copy's process: build, stamp one launch of each case."""
    import torch
    sys.path.append(ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    assert not pa.__file__.startswith(ROOT), pa.__file__
    # the stamps' device buffer and its host entry go in one translation
    # unit: build the edited copy whole, not in parts
    _build.PARTS.pop("paged_attention", None)
    _build.build_all(["paged_attention"])
    set_buffer = _build.kernel("paged_attention", "paged_timeline_buffer",
                               [ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    buf = torch.zeros(SLOTS << 18, dtype=torch.int64, device=dev)
    assert set_buffer(buf.data_ptr()) == 0
    T, qstart = cs.SPEC_K + 1, [p + 1 for p in cs.PAGED_POSITIONS]
    a6 = cs._verify_inputs(32, 32, qstart, T, cs.SEED + 61, dev)
    e6 = cs._verify_inputs(32, 32, cs.VERIFY_STEP_QSTART, T, cs.SEED + 63,
                           dev, max_nb=cs.VERIFY_STEP_MAX_NB)
    a7 = cs._quant_inputs(32, 32, qstart, cs.SEED + 72, dev, torch.bfloat16,
                          T=T)
    a3 = cs._paged_inputs(32, 32, cs.PAGED_POSITIONS, cs.SEED + 32, dev)
    e3 = cs._paged_inputs(32, 32, cs.PAGED_STEP_POSITIONS, cs.SEED + 33, dev)
    verify = lambda a: (lambda: pa.paged_attention_verify(
        a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
        a["layer"]))
    update = lambda a: (lambda: pa.paged_attend_update(
        a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
        a["tables"], a["positions"], a["layer"]))
    a5 = cs._quant_inputs(32, 32, cs.PAGED_POSITIONS, cs.SEED + 71, dev,
                          torch.bfloat16)
    e5 = cs._quant_inputs(32, 32, cs.PAGED_STEP_POSITIONS, cs.SEED + 75, dev,
                          torch.bfloat16, max_nb=16)
    update_quant = lambda a: (lambda: pa.paged_attend_update_quant(
        a["q"], *(a[k][-1, :, 0].contiguous()
                  for k in ("new_k", "new_v", "new_ks", "new_vs")),
        a["k_pool"], a["v_pool"], a["k_scale"], a["v_scale"], a["tables"],
        a["rows"], a["layer"]))
    cases = [("row 6, table shape", verify(a6)),
             ("row 6, even rows (8 x 600)", verify(e6)),
             ("row 7, table shape", lambda: pa.paged_attention_verify_quant(
                 a7["q"], a7["k_pool"], a7["v_pool"], a7["k_scale"],
                 a7["v_scale"], a7["tables"], a7["rows"], a7["layer"])),
             ("row 3, table shape", update(a3)),
             ("row 3, even rows (8 x 1,001)", update(e3)),
             ("row 5, table shape", update_quant(a5)),
             ("row 5, even rows (8 x 1,001)", update_quant(e5))]
    out = []
    for name, fn in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        buf.zero_()
        fn()
        torch.cuda.synchronize()
        out.append(summarise(buf.cpu().numpy().reshape(-1, SLOTS), name))
    return out


def main():
    tmp = tempfile.mkdtemp(prefix="paged_timeline_")
    try:
        pkg = os.path.join(tmp, "paddle_tpu_torch")
        shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        cu = os.path.join(pkg, "csrc", "paged_attention.cu")
        src = open(cu).read()
        for old, new in EDITS:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
        with open(cu, "w") as f:
            f.write(src + HOST)
        sys.path.insert(0, tmp)
        record = run()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_timeline.json"),
              "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
