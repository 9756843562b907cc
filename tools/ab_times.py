"""Times kernels of two trees side by side on one card.

    python3 tools/ab_times.py BEFORE AFTER             # rows 24, 25, 26
    python3 tools/ab_times.py --varlen BEFORE AFTER    # rows 20-23
    python3 tools/ab_times.py --paged BEFORE AFTER     # rows 2-7, 10
    python3 tools/ab_times.py --split BEFORE AFTER     # rows 16-18
    python3 tools/ab_times.py --serve-int8 BEFORE AFTER  # the int8 steps
    python3 tools/ab_times.py --rms BEFORE AFTER       # row 1, decode step
    python3 tools/ab_times.py --commit BEFORE AFTER    # rows 8, 9, verify
    python3 tools/ab_times.py --prefill BEFORE AFTER   # the prefill chunk

BEFORE and AFTER are directories that each hold a ``paddle_tpu_torch/``
package, for example a ``git archive`` of the parent commit unpacked
into a git-ignored directory, and ``.``. Each tree runs in a process of
its own (its kernels build there), in the order BEFORE, AFTER, AFTER,
BEFORE, so that a drift of the card over the call shows. Times are
device ms per call with the calls queued ahead (chip_smoke.py's
``_time_ms``), in bf16, on one ERNIE MoE layer's schedule (16,384 routed
rows of 32 experts, chip_smoke's ``_slice_schedule``) at (K, N) =
(1024, 512) and (512, 1024):

  gmm_fwd (row 24), gmm_dx (row 25)
  gmm_dw (row 26)   a control where both trees hold the same kernel

Each run also gives the forward's and dX's drift along a product summed
in f64, kernel and plain version (chip_smoke's ``gmm_drifts``, taken from
this checkout's chip_smoke.py whatever the tree).

With --varlen, the packed varlen kernels at chip_smoke's varlen shapes
(32 heads x 128, bf16, causal self-attention, ``varlen_times``' inputs):

  varlen_fwd (row 20), varlen_bwd (row 21)          at both packs
  varlen_bwd_dkv (row 22), varlen_bwd_dq (row 23)   at the long pack

and the drift of rows 20-23 along a product summed in f64 (chip_smoke's
``varlen_drifts``, four heads of the long pack), and a digest of the
outputs of the deterministic ones (rows 20, 22, 23; row 21's dK and dV).

With --paged, the paged kernels at chip_smoke's timing shapes (B = 8, NH
= NKV = 32, HD = 128, bf16, 3,865 context tokens; device ms with
``queued``, and the profiler's kernel time): rows 5 and 4 (int8 pools),
also at the serve phase's profiled decode step (8 rows of 1,001 tokens,
16-block tables), and as controls rows 6 and 7 (T = 5 fed tokens; bf16
and int8 pools), also at the profiled verify step's rows (8 rows of 600
cached tokens), rows 3 and 2 (row 3 also at the decode step's rows) and
the slab decode row 10 (generate's shape, pos 1023); with a digest of
every output, and the verdict whether rows 2, 3, 6, 7 and 10 keep their
bits.

With --serve-int8, chip_smoke's ``profile_steps`` on the serve-int8
phase's engine (llama_7b, seeded random weights, int8 pools): one decode
step (8 rows at 1,000 cached tokens) and one 256-token prefill chunk,
device ms by kernel class and host wall ms (a tree whose int8 decode runs
the block walk ``paged_decode_quant_kernel`` has its time counted as rows
5 and 4).

With --split, the dense split backward at chip_smoke's train (B 4, S
2048) and train-long (B 1, S 16384) shapes (32 heads x 128, causal,
bf16): rows 17 (dK/dV) and 18 (dQ), and row 16 (the fused backward) as a
control; digests of row 17's and row 16's dK and dV and of row 18's dQ,
and the verdict whether rows 16 and 17 keep their bits.

With --rms, row 1 at [8, 4096], [256, 4096] and [8192, 4096] bf16 beside
the launch floor (an empty kernel, ``torch.cuda._sleep(0)``, timed the
same way), and chip_smoke's ``profile_steps`` on a bf16 llama_7b engine
(seeded random weights): the decode step's and the prefill chunk's
rms_norm class (65 launches a decode step), device ms and wall ms.

With --commit, rows 8 (bf16 pools) and 9 (int8) at chip_smoke's commit
timing inputs (L = 32, B = 8, T = 5, KVD = 4096) with every column
accepted and with one (the serve-spec step's commit lengths), device ms
and the profiler's kernel time, a digest of every block but the null
block 0 after one commit (the verdict whether both trees write the same
bits there), and chip_smoke's ``profile_verify`` on bf16 and int8
llama_7b engines: the verify step's commit class, device ms and wall ms.

With --prefill, the serving engine's plain prefill chunk
(``llama_paged_prefill_chunk``) on llama_7b (seeded random weights, 32
layers) over an 8-block table at 768 cached tokens, bf16 and int8 pools,
with a full chunk (256 of 256 tokens live) and a prompt's last, partial
chunk (100 live): device ms with ``queued``, and chip_smoke's
``_profile_one`` (device ms by kernel class, host wall ms); with a digest
of the logits and the row's last two blocks (the verdict whether both
trees give the same bits there; null block 0, where padding tokens
land, is left out).

Needs one CUDA device and nvcc; prints one JSON line per run, the card's
name and power limit first, and writes chiprun_out/ab_times.json (or
ab_times_varlen.json, ab_times_paged.json, ab_times_split.json,
ab_times_serve_int8.json, ab_times_rms.json, ab_times_commit.json,
ab_times_prefill.json).
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke(tree):
    """This checkout's chip_smoke.py over ``tree``'s package."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _digest(*tensors):
    """sha256 of the tensors' bytes, in order (the first 16 hex digits)."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        torch.cuda.synchronize()
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_one(tree):
    """In a tree's process: every time and drift, as one JSON line."""
    import torch
    chip_smoke = _chip_smoke(tree)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import grouped_matmul as tg
    assert tg.__file__.startswith(tree), tg.__file__
    _build.build_all(["grouped_matmul"])
    dev = torch.device("cuda", 0)
    out = {}
    counts, n_rows, sched = chip_smoke._slice_schedule(dev)
    e = counts.shape[0]
    for k, n in chip_smoke.MOE_SHAPES:
        lhs, rhs, dout = chip_smoke._gmm_operands(dev, torch.bfloat16,
                                                  n_rows, e, k, n, 0)
        key = f"[K={k},N={n}]"
        for name, fn in (
                ("gmm_fwd", lambda: tg.gmm_fwd(lhs, rhs, sched)),
                ("gmm_dx", lambda: tg.gmm_dx(dout, rhs, sched)),
                ("gmm_dw", lambda: tg.gmm_dw(lhs, dout, sched,
                                             num_experts=e))):
            out[name + key] = chip_smoke._time_ms(fn, 50)[0]
        del lhs, rhs, dout
    drifts = {key: {"kernel": dk, "plain": dp}
              for key, (dk, dp) in chip_smoke.gmm_drifts(tg, dev).items()}
    print(json.dumps({"tree": tree, "ms": out, "drift": drifts}))


def run_one_varlen(tree):
    """In a tree's process: the varlen times and drifts, as one JSON line."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_varlen as fv
    assert fv.__file__.startswith(tree), fv.__file__
    _build.build_all(["flash_varlen"])
    dev = torch.device("cuda", 0)
    h, d, scale = cs.VARLEN_H, cs.VARLEN_D, cs.VARLEN_D ** -0.5
    out, drifts, digests = {}, None, {}
    for pack, lens in (("short", cs.VARLEN_SHORT), ("long", cs.VARLEN_LONG)):
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, h,
                                        d, cs.SEED + 60)
        cu = cs._cu_dev(lens, dev)
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        o, lse = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        delta = (doh.float() * o.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        calls = {"varlen_fwd": lambda: fv.varlen_fwd(qh, kh, vh, cu, cu,
                                                     True, scale),
                 "varlen_bwd": lambda: fv.varlen_bwd(*args)}
        if pack == "long":
            calls.update(varlen_bwd_dkv=lambda: fv.varlen_bwd_dkv(*args),
                         varlen_bwd_dq=lambda: fv.varlen_bwd_dq(*args))
        for name, fn in calls.items():
            out[f"{name}[{pack} pack]"] = cs._time_ms(fn, 20)[0]
        digests[f"varlen_fwd[{pack} pack]"] = _digest(o, lse)
        digests[f"varlen_bwd dk, dv[{pack} pack]"] = _digest(
            *fv.varlen_bwd(*args)[1:])
        if pack == "long":
            digests["varlen_bwd_dkv[long pack]"] = _digest(
                *fv.varlen_bwd_dkv(*args))
            digests["varlen_bwd_dq[long pack]"] = _digest(
                fv.varlen_bwd_dq(*args))
            drifts = {n: {kk: x[kk] for kk in ("kernel", "plain", "excess")}
                      for n, x in cs.varlen_drifts(fv, q, k, v, do,
                                                   lens).items()}
        del q, k, v, do, o, args
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": out, "drift": drifts,
                      "digests": digests}))


def run_one_paged(tree):
    """In a tree's process: rows 2-7 and 10, times and digests."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import paged_attention as pa
    assert pa.__file__.startswith(tree), pa.__file__
    _build.build_all(["paged_attention", "decode_attention"])
    dev = torch.device("cuda", 0)
    out, digests = {}, {}

    def timed(key, fn, result, kernel=None):
        dev_ms, _, queued = cs._time_ms(fn, 100)
        out[key] = {"ms": dev_ms, "queued": queued}
        if kernel is not None:
            out[key]["profiler_ms"] = cs._profiled_ms(fn, kernel)
        digests[key] = _digest(*result)

    a = cs._paged_inputs(32, 32, cs.PAGED_POSITIONS, cs.SEED + 32, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    rd = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["positions"] + 1,
          a["layer"])
    timed("paged_attend_update (row 3)", lambda: pa.paged_attend_update(*upd),
         [pa.paged_attend_update(*upd)], "paged_")
    timed("paged_attention (row 2)", lambda: pa.paged_attention(*rd),
         [pa.paged_attention(*rd)], "paged_")
    a = cs._paged_inputs(32, 32, cs.PAGED_STEP_POSITIONS, cs.SEED + 33, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    timed("paged_attend_update (row 3), even rows",
          lambda: pa.paged_attend_update(*upd),
          [pa.paged_attend_update(*upd)], "paged_")
    del a, upd, rd
    for key, positions, width, seed in (
            ("", cs.PAGED_POSITIONS, None, 71),
            (", even rows", cs.PAGED_STEP_POSITIONS, 16, 75)):
        a = cs._quant_inputs(32, 32, positions, cs.SEED + seed, dev,
                             torch.bfloat16, max_nb=width)
        pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        new = [a[k][-1, :, 0].contiguous() for k in ("new_k", "new_v",
                                                       "new_ks", "new_vs")]
        upd = (a["q"], *new, *pools, a["tables"], a["rows"], a["layer"])
        rd = (a["q"], *pools, a["tables"], a["rows"] + 1, a["layer"])
        timed(f"paged_attend_update_quant (row 5){key}",
              lambda: pa.paged_attend_update_quant(*upd),
              [pa.paged_attend_update_quant(*upd)], "paged_")
        timed(f"paged_attention_quant (row 4){key}",
              lambda: pa.paged_attention_quant(*rd),
              [pa.paged_attention_quant(*rd)], "paged_")
        del a, pools, new, upd, rd
    qstart = [p + 1 for p in cs.PAGED_POSITIONS]
    T = cs.SPEC_K + 1
    for key, rows, width, seed in (
            ("", qstart, None, 0),
            (", even rows", cs.VERIFY_STEP_QSTART, cs.VERIFY_STEP_MAX_NB, 2)):
        a = cs._verify_inputs(32, 32, rows, T, cs.SEED + 61 + seed, dev,
                              max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                a["layer"])
        timed(f"paged_attention_verify (row 6){key}",
              lambda: pa.paged_attention_verify(*call),
              pa.paged_attention_verify(*call), "paged_verify")
        a = cs._quant_inputs(32, 32, rows, cs.SEED + 72 + seed, dev,
                             torch.bfloat16, T=T, max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        timed(f"paged_attention_verify_quant (row 7){key}",
              lambda: pa.paged_attention_verify_quant(*call),
              pa.paged_attention_verify_quant(*call), "paged_verify")
        del a, call
    q, nk, nv, kc, vc = cs._slab_inputs(dev, torch.bfloat16, cs.GEN_B, 32, 4,
                                        64, cs.SLAB_T, cs.SEED)
    timed("decode_attend_update_slab (row 10)",
         lambda: da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, 1023),
         [da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, 1023)])
    print(json.dumps({"tree": tree, "ms": out, "digests": digests}))


def run_one_serve_int8(tree):
    """In a tree's process: the serve-int8 decode step and prefill chunk
    by kernel class."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    from paddle_tpu_torch.ops import paged_attention as pa
    assert pa.__file__.startswith(tree), pa.__file__
    classify = cs._kernel_class

    def kernel_class(name):     # the block walk of trees before the split
        if "paged_decode_quant_kernel" in name:
            return ("paged_attend_update_quant" if ", true>" in name
                    else "paged_attention_quant")
        return classify(name)
    cs._kernel_class = kernel_class
    dev = torch.device("cuda", 0)
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=cs.SEED, device=dev)
    eng = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
        max_seq_len=2048, kv_dtype="int8"), device=dev)
    out = cs.profile_steps(eng, cfg, dev)
    print(json.dumps({"tree": tree, "steps": out}))


def run_one_rms(tree):
    """In a tree's process: row 1's times beside the launch floor and the
    bf16 decode step's classes."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import rms_norm as rn
    assert rn.__file__.startswith(tree), rn.__file__
    _build.build_all(["rms_norm", "paged_attention"])
    dev = torch.device("cuda", 0)
    out = {"launch floor": {"ms": cs._time_ms(lambda: torch.cuda._sleep(0),
                                              200)[0]}}
    for n in (8, 256, cs.TRAIN_B * cs.TRAIN_S):
        x = torch.randn((n, 4096), device=dev, dtype=torch.bfloat16)
        w = torch.ones((4096,), device=dev, dtype=torch.bfloat16)
        out[f"rms_norm [{n},4096]"] = {
            "ms": cs._time_ms(lambda: rn.fused_rms_norm(x, w, 1e-5), 200)[0],
            "profiler_ms": cs._profiled_ms(
                lambda: rn.fused_rms_norm(x, w, 1e-5), "rms_norm")}
        del x, w
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=cs.SEED, device=dev)
    eng = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
        max_seq_len=2048), device=dev)
    steps = {k: {"rms_norm_ms": r["by_class_ms"].get("rms_norm"),
                 "device_ms": r["device_ms"], "wall_ms": r["wall_ms"],
                 "by_class_ms": r["by_class_ms"]}
             for k, r in cs.profile_steps(eng, cfg, dev).items()}
    print(json.dumps({"tree": tree, "ms": out, "steps": steps}))


def run_one_commit(tree):
    """In a tree's process: rows 8 and 9 at both commit lengths, digests
    of their live blocks, and the verify step's classes in bf16 and
    int8."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    assert pa.__file__.startswith(tree), pa.__file__
    _build.build_all(["rms_norm", "paged_attention"])
    dev = torch.device("cuda", 0)
    out, digests = {}, {}
    for quant in (False, True):
        kern, _, a, new, pools, qs = cs.commit_timing_inputs(dev, quant)
        row = "row 9" if quant else "row 8"
        for n_live in (cs.SPEC_K + 1, 1):
            clen = torch.full((qs.shape[0],), n_live, dtype=torch.int32,
                              device=dev)
            key = f"{kern.__name__} ({row}), commit_len={n_live}"
            fresh = [p.clone() for p in pools]
            kern(*new, *fresh, a["tables"], qs, clen)
            digests[key] = _digest(*(p[:, 1:] for p in fresh))
            del fresh
            args = (*new, *pools, a["tables"], qs, clen)
            out[key] = {"ms": cs._time_ms(lambda: kern(*args), 200)[0],
                        "profiler_ms": cs._profiled_ms(lambda: kern(*args),
                                                       "paged_commit")}
        del a, new, pools
        torch.cuda.empty_cache()
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=cs.SEED, device=dev)
    steps = {}
    for kv in ("auto", "int8"):
        eng = InferenceEngine(params, cfg, ServeConfig(
            block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
            max_seq_len=2048, kv_dtype=kv), device=dev)
        r = cs.profile_verify(eng, cfg, dev)
        steps[f"verify_step kv_dtype={kv}"] = {
            "commit_ms": sum(v for k, v in r["by_class_ms"].items()
                             if k.startswith("paged_verify_commit")),
            "device_ms": r["device_ms"], "wall_ms": r["wall_ms"],
            "by_class_ms": r["by_class_ms"]}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": out, "digests": digests,
                      "steps": steps}))


def run_one_prefill(tree):
    """In a tree's process: the prefill chunk, full and partial, over bf16
    and int8 pools; times, classes and digests."""
    import gc
    import numpy as np
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.inference.kv_cache import pad_table
    from paddle_tpu_torch.models import llama as tl
    assert tl.__file__.startswith(tree), tl.__file__
    _build.build_all(["rms_norm", "paged_attention"])
    dev = torch.device("cuda", 0)
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=cs.SEED, device=dev)
    ids = torch.from_numpy(np.random.RandomState(cs.SEED).randint(
        1, cfg.vocab_size, size=(4, 256)).astype(np.int32)).to(dev)
    out, digests = {}, {}
    for kv in ("auto", "int8"):
        eng = InferenceEngine(params, cfg, ServeConfig(
            block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
            max_seq_len=2048, kv_dtype=kv), device=dev)
        blocks = eng.pool.alloc(8)
        table = torch.from_numpy(pad_table(blocks, eng.serve.max_nb)).to(dev)
        sc = None if eng.k_scale is None else (eng.k_scale, eng.v_scale)

        def chunk(i, n_live):
            return tl.llama_paged_prefill_chunk(
                eng.params, eng.k_pool, eng.v_pool, table, 256 * i, ids[i],
                n_live, cfg, kv_scales=sc)[0]
        for i in range(3):                  # the 768 cached tokens
            chunk(i, 256)
        pools = [eng.k_pool, eng.v_pool] + ([] if sc is None else list(sc))
        for n_live in (256, 100):
            key = f"prefill_chunk kv_dtype={kv} n_live={n_live}"
            logits = chunk(3, n_live)
            digests[key] = _digest(logits, *(p[:, blocks[6:]]
                                             for p in pools))
            ms, _, queued = cs._time_ms(lambda: chunk(3, n_live), 10)
            prof = cs._profile_one(key, lambda: chunk(3, n_live).cpu())
            out[key] = {"ms": ms, "queued": queued,
                        "device_ms": prof["device_ms"],
                        "wall_ms": prof["wall_ms"],
                        "by_class_ms": prof["by_class_ms"]}
        eng.pool.free(blocks)
        del eng, pools, sc
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": out, "digests": digests}))


def run_one_split(tree):
    """In a tree's process: rows 16-18, times and digests."""
    import torch
    cs = _chip_smoke(tree)
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    assert fa.__file__.startswith(tree), fa.__file__
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda", 0)
    out, digests = {}, {}
    for b, s in ((cs.TRAIN_B, cs.TRAIN_S), (1, cs.LONG_S)):
        qs, k, v, do, o, lse = cs._split_inputs(b * 32, s, s, 128,
                                                torch.bfloat16,
                                                cs.SEED + 120, dev)
        delta = (do.float() * o.float()).sum(-1)
        args = (qs, k, v, do, lse, delta, True, 128 ** -0.5)
        key = f"[B={b},NH=32,S={s},D=128,causal]"
        iters = 20 if s <= 4096 else 5
        for name, fn, res in (
                ("flash_bwd_dkv (row 17)", lambda: fa.flash_bwd_dkv(*args),
                 lambda: fa.flash_bwd_dkv(*args)),
                ("flash_bwd_dq (row 18)", lambda: fa.flash_bwd_dq(*args),
                 lambda: [fa.flash_bwd_dq(*args)]),
                ("flash_bwd (row 16; dk, dv)", lambda: fa.flash_bwd(*args),
                 lambda: fa.flash_bwd(*args)[1:])):
            out[name + key] = cs._time_ms(fn, iters)[0]
            digests[name + key] = _digest(*res())
        del qs, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": out, "digests": digests}))


# the outputs that both trees must give with the same bits
KEPT = {"--one-paged": ("row 2", "row 3", "row 6", "row 7", "row 10"),
        "--one-split": ("row 16", "row 17"),
        "--one-commit": ("row 8", "row 9"),
        "--one-prefill": ("prefill_chunk",),
        "--one-varlen": ("varlen_fwd", "varlen_bwd_dkv", "varlen_bwd_dq",
                         "varlen_bwd dk")}


MODES = {"--varlen": "varlen", "--paged": "paged", "--split": "split",
         "--serve-int8": "serve_int8", "--rms": "rms", "--commit": "commit",
         "--prefill": "prefill"}


def main():
    mode = MODES.get(sys.argv[1]) if len(sys.argv) > 1 else None
    if mode:
        del sys.argv[1]
    one = f"--one-{mode}" if mode else "--one"
    before, after = (os.path.realpath(p) for p in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    runs = []
    for tree in (before, after, after, before):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), one,
                            tree], capture_output=True, text=True)
        if p.returncode != 0:
            sys.exit(f"{tree}: exit {p.returncode}\n{p.stderr[-4000:]}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    record = {"nvidia_smi": smi, "runs": runs}
    if one in KEPT:
        kept = {key: runs[0]["digests"][key] == runs[1]["digests"][key]
                for key in runs[0]["digests"]
                if any(k in key for k in KEPT[one])}
        record["same_bits"] = kept
        print(f"the same bits in both trees: {kept}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = f"ab_times_{mode}.json" if mode else "ab_times.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    ONES = {"--one": run_one, "--one-varlen": run_one_varlen,
            "--one-paged": run_one_paged, "--one-split": run_one_split,
            "--one-serve_int8": run_one_serve_int8,
            "--one-rms": run_one_rms, "--one-commit": run_one_commit,
            "--one-prefill": run_one_prefill}
    if sys.argv[1:2] and sys.argv[1] in ONES:
        ONES[sys.argv[1]](sys.argv[2])
    else:
        main()
