"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. probe   - versions, the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel source of the serving and training
               paths, all at once, for sm_90a;
  3. check   - each kernel against its plain PyTorch version at the
               serving and training paths' shapes, in bf16 (and one f32
               flash case), with the tolerance stated; then a tiny fp32
               Llama served on the card through the kernels must give the
               same greedy streams as the same engine on the CPU through
               the plain versions, and three tiny fp32 train steps on the
               card must give the CPU's losses;
  4. serve   - InferenceEngine on llama_7b (bf16, full width and depth,
               seeded random weights): 16 requests, prompts of 128-1024
               tokens, 64 new tokens each, Poisson arrivals; prints
               tokens/s, TTFT, TPOT, the mean decode step and each
               kernel's launches, all counted from this phase alone;
               then torch.profiler splits one decode step and one prefill
               chunk into kernel classes beside their wall time;
  5. train   - build_train_step on llama_7b's width cut to 16 layers
               (bf16, B=4, S=2048, full remat, AdamW with f32 moments,
               seeded random weights and ids): one warm-up and three timed
               steps; prints step ms, tokens/s, MFU, every loss, peak
               memory and each kernel's launches counted from this phase
               alone; then torch.profiler splits one step into matmul,
               flash, RMSNorm, optimizer and other device time beside
               its wall time;
  6. times   - each kernel timed with CUDA events beside its bound, its
               plain version and one PyTorch library call (a yardstick
               the port never calls);
  7. a JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Needs one CUDA device; writes its numbers to chiprun_out/chip_smoke.json.
Imports nothing of JAX and nothing of paddle_tpu.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
SEED = 0
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 4, 2048, 3


def phase(name):
    print(f"\n== {name} ==", flush=True)


def probe():
    phase("probe")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"devices {torch.cuda.device_count()}  "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 matmuls in full precision: the tiny-model stream and train
    # checks compare card and CPU arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    from paddle_tpu_torch import _build
    phase("build")
    t0 = time.perf_counter()
    paths = _build.build_all(["rms_norm", "paged_attention",
                              "flash_attention"])
    secs = time.perf_counter() - t0
    for p in paths:
        print(f"built {os.path.relpath(p, ROOT)}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"build seconds {secs:.2f}")
    return secs


def _paged_inputs(nh, nkv, positions, seed, dev, hd=128, bs=128, max_nb=16,
                  layers=2):
    """A decode batch over fragmented random tables: every row's blocks
    are distinct random pool blocks (never the null block)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(positions)
    kvd = nkv * hd
    need = [p // bs + 1 for p in positions]
    np_blocks = 1 + sum(need)
    perm = (torch.randperm(np_blocks - 1, generator=g, device=dev) + 1).tolist()
    tables = torch.zeros((b, max_nb), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    bf = torch.bfloat16
    from paddle_tpu_torch.ops.paged_attention import LOG2E
    q = (torch.randn((b, nh, hd), generator=g, device=dev).float()
         * (LOG2E / math.sqrt(hd))).to(bf)
    new_k = torch.randn((b, kvd), generator=g, device=dev, dtype=bf)
    new_v = torch.randn((b, kvd), generator=g, device=dev, dtype=bf)
    shape = (layers, np_blocks, kvd, bs)
    k_pool = torch.randn(shape, generator=g, device=dev, dtype=bf)
    v_pool = torch.randn(shape, generator=g, device=dev, dtype=bf)
    return dict(q=q, new_k=new_k, new_v=new_v, k_pool=k_pool, v_pool=v_pool,
                tables=tables.to(dev),
                positions=torch.tensor(positions, dtype=torch.int32,
                                       device=dev), layer=layers - 1)


RMS_TOL = dict(rtol=2.0 ** -7, atol=1e-5)   # one bf16 rounding step
PAGED_ATOL = 2e-3   # f32 sums in another order; P rounded to bf16 can
                    # land one step apart where it sits on a boundary
PAGED_POSITIONS = [0, 1, 127, 128, 300, 777, 1024, 1500]   # 128, 1024 open
                                                           # a fresh block


def check_kernels(dev):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    phase("check kernels against their plain versions (bf16)")
    errs = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    # rows: a decode step, a prefill chunk, a train step (B x S)
    for n in (8, 256, TRAIN_B * TRAIN_S):
        x = torch.randn((n, 4096), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w = (1 + 0.1 * torch.randn((4096,), generator=g, device=dev)
             ).to(torch.bfloat16)
        got = rn.fused_rms_norm(x, w, 1e-5)
        ref = rn.rms_norm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got, ref, **RMS_TOL)
        print(f"rms_norm [{n},4096] max_abs_err {err:.3e} "
              f"(tol rtol 2^-7, atol 1e-5)")
        errs.setdefault("rms_norm", 0.0)
        errs["rms_norm"] = max(errs["rms_norm"], err)

    for nh, nkv in ((32, 32), (32, 8)):
        a = _paged_inputs(nh, nkv, PAGED_POSITIONS, SEED + nkv, dev)
        kp2, vp2 = a["k_pool"].clone(), a["v_pool"].clone()
        args = (a["q"], a["new_k"], a["new_v"])
        got = pa.paged_attend_update(*args, a["k_pool"], a["v_pool"],
                                     a["tables"], a["positions"], a["layer"])
        ref = pa.paged_attend_update_plain(*args, kp2, vp2, a["tables"],
                                           a["positions"], a["layer"])
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        assert torch.isfinite(got).all(), "paged_attend_update: non-finite"
        assert err <= PAGED_ATOL, f"paged_attend_update err {err}"
        # the pools, new columns included, are bitwise the plain version's
        assert torch.equal(a["k_pool"], kp2) and torch.equal(a["v_pool"], vp2)
        pos = a["positions"].long()
        blk = a["tables"][torch.arange(len(pos), device=dev), pos // 128]
        col = a["k_pool"][a["layer"], blk.long(), :, pos % 128]
        assert torch.equal(col, a["new_k"]), "new k column not written"
        print(f"paged_attend_update NH={nh} NKV={nkv} HD=128 bs=128 B=8 "
              f"positions {PAGED_POSITIONS}: max_abs_err {err:.3e} "
              f"(tol {PAGED_ATOL}), pools bitwise equal")
        errs["paged_attend_update"] = max(
            errs.get("paged_attend_update", 0.0), err)
    return errs


# flash kernels against their plain versions, on every element
#   |got - ref| <= rel * (|ref| + max |ref| of its row + rms(ref)),
# a row being a query row (o, dq) or a key row (dk, dv), and on the whole
# tensor ||got - ref|| / ||ref|| <= frob. The row max holds each row to
# its own scale (late causal rows are small); the rms floor covers rows
# that are zero but for rounding noise (dq of query 0, whose dS cancels).
# f32: sums in another order (dQ by atomics): rel = frob = 1e-5 forward,
# 1e-4 backward. bf16: P and dS are rounded at the same points in both,
# yet a result may land one bf16 step apart: rel 2^-6; frob 2^-10 lies
# between a summation order's ~1e-4 and the ~2e-3 of a P or dS left
# unrounded. (BH, S, D, causal, dtype): S = 2048, D = 128, causal at
# BH = 128 is the train phase's shape.
FLASH_TOL = {torch.float32: ((1e-5, 1e-5), (1e-4, 1e-4)),
             torch.bfloat16: ((2 ** -6, 2 ** -10), (2 ** -6, 2 ** -10))}
FLASH_CASES = [(8, 200, 128, True, torch.bfloat16),
               (8, 200, 128, False, torch.bfloat16),
               (128, 2048, 128, True, torch.bfloat16),
               (8, 2048, 128, False, torch.bfloat16),
               (8, 200, 64, True, torch.float32)]


def _flash_inputs(bh, s, d, dtype, seed, dev):
    from paddle_tpu_torch.ops.flash_attention import LOG2E
    g = torch.Generator(device=dev).manual_seed(seed)
    qs = (torch.randn((bh, s, d), generator=g, device=dev)
          * (LOG2E / math.sqrt(d))).to(dtype)
    return [qs] + [torch.randn((bh, s, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3)]


def flash_close(got, ref, rel, frob):
    """``got`` against ``ref`` [..., D] under the rule above: (ok, worst
    excess over the elementwise limit (<= 0 passes), relative Frobenius
    error, max abs error)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    limit = rel * (r.abs() + r.abs().amax(-1, keepdim=True)
                   + r.square().mean().sqrt())
    excess = (diff - limit).max().item()
    fro = (diff.norm() / r.norm()).item()
    ok = bool(torch.isfinite(g).all()) and excess <= 0 and fro <= frob
    return ok, excess, fro, diff.max().item()


def flash_case(fa, bh, s, d, causal, dtype, seed, dev):
    """One case of both kernels against their plain versions: {output:
    flash_close(...)} for o, dq, dk, dv, and the lse's max abs error."""
    qs, k, v, do = _flash_inputs(bh, s, d, dtype, seed, dev)
    (rel_f, frob_f), (rel_b, frob_b) = FLASH_TOL[dtype]
    o, lse = fa.flash_fwd(qs, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = fa.flash_bwd(qs, k, v, do, lse_ref, delta, causal, 1 / math.sqrt(d))
    want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, delta, causal,
                              1 / math.sqrt(d))
    torch.cuda.synchronize()
    res = {"o": flash_close(o, o_ref, rel_f, frob_f)}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        res[name] = flash_close(a, b, rel_b, frob_b)
    return res, (lse - lse_ref).abs().max().item()


def check_flash(dev, errs):
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("check flash kernels against their plain versions")
    for i, (bh, s, d, causal, dtype) in enumerate(FLASH_CASES):
        res, err_lse = flash_case(fa, bh, s, d, causal, dtype, SEED + i, dev)
        (rel_f, frob_f), (rel_b, frob_b) = FLASH_TOL[dtype]
        print(f"flash BH={bh} S={s} D={d} causal={causal} {str(dtype)[6:]} "
              f"(tol rel {rel_f:g}/{rel_b:g} of |ref| + row max + rms, "
              f"frob {frob_f:g}/{frob_b:g} fwd/bwd; lse 1e-4): lse "
              f"max_abs_err {err_lse:.2e}")
        for name, (ok, excess, fro, err) in res.items():
            print(f"  {name}: max_abs_err {err:.3e}  worst excess over the "
                  f"limit {excess:.3e}  rel frob {fro:.3e}  "
                  f"{'ok' if ok else 'FAILED'}")
        assert all(r[0] for r in res.values()), f"flash disagrees: {res}"
        assert err_lse <= 1e-4, f"flash_fwd lse err {err_lse}"
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), res["o"][3])
        errs["flash_bwd"] = max(errs.get("flash_bwd", 0.0),
                                *(res[n][3] for n in ("dq", "dk", "dv")))
        torch.cuda.empty_cache()


TRAIN_LOSS_RTOL = 1e-5   # f32 on both; sums in another order


def check_tiny_train(dev):
    """Three tiny fp32 train steps through the kernels on the card give
    the losses of the same steps through the plain versions on the CPU,
    and the card run advances both flash counters."""
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("check a tiny fp32 Llama train: card kernels vs CPU plain")
    cfg = tl.llama_tiny(vocab=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, seq=256)
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, size=(2, 201)).astype(np.int32)
    ids, labels = x[:, :-1], x[:, 1:]
    params0 = tl.init_llama_params(cfg, seed=1, device="cpu")
    out = []
    for d in ("cpu", dev):
        step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(),
                                         device=d)
        # copies: the step updates params in place
        params = {k: ({kk: vv.to(d, copy=True) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(d, copy=True))
                  for k, v in params0.items()}
        opt = tl._adamw_init(params)
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        out.append((losses, fa.flash_fwd.launches, fa.flash_bwd.launches))
    (cpu, f0, b0), (card, f1, b1) = out
    L = cfg.num_hidden_layers
    assert (f0, b0) == (0, 0) and (f1, b1) == (3 * 2 * L, 3 * L), out
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL)
    print(f"losses card {card} cpu {cpu} (rtol {TRAIN_LOSS_RTOL}); "
          f"launches flash_fwd {f1} flash_bwd {b1}")


def check_tiny_streams(dev):
    """A tiny fp32 Llama served through the kernels on the card gives the
    same greedy streams and events as the same engine through the plain
    versions on the CPU (the trace of the port's CPU parity tests)."""
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_tiny)
    phase("check a tiny fp32 Llama: card kernels vs CPU plain, greedy streams")
    cfg = llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                     seq=512)
    params = init_llama_params(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (7, 130, 300)]
    serve = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=64, max_seq_len=512)
    out = []
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        eng = InferenceEngine(p, cfg, ServeConfig(**serve),
                              record_events=True, device=d)
        eng.run([Request(pr, max_new_tokens=8, arrival=float(i))
                 for i, pr in enumerate(prompts)], deterministic=True)
        out.append(({s.req.request_id: s.tokens for s in eng.finished},
                    eng.events, eng.pool.used_blocks))
    assert out[0] == out[1], "card and CPU streams differ"
    print(f"streams identical for {len(prompts)} requests, "
          f"{len(out[0][1])} events, pool leak-free")


def serve_7b(dev):
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_7b)
    phase("serve llama_7b (bf16, 32 layers, random weights)")
    cfg = llama_7b()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"weights made on the card in {time.perf_counter() - t0:.2f} s, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params")
    serve = ServeConfig(block_size=128, num_blocks=129, max_batch=8,
                        prefill_chunk=256, max_seq_len=2048)
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, 1025, size=16)
    arrivals = np.cumsum(rng.exponential(0.25, size=16)) - 0.25
    reqs = [Request(rng.randint(1, cfg.vocab_size, size=int(n)).tolist(),
                    max_new_tokens=64, arrival=float(max(a, 0.0)))
            for n, a in zip(lens, arrivals)]
    # warm-up on a small pool: cuBLAS handles, allocator, kernel loads
    warm = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=9, max_batch=2, prefill_chunk=256,
        max_seq_len=1024), device=dev)
    warm.run([Request(list(range(1, 200)), max_new_tokens=3)])
    del warm
    torch.cuda.empty_cache()
    eng = InferenceEngine(params, cfg, serve, device=dev)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    stats = eng.run(reqs)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
    L = cfg.num_hidden_layers
    print(f"requests {stats['requests']}  generated {stats['generated_tokens']}"
          f"  iterations {stats['iterations']}  decode steps {steps}  "
          f"prefill chunks {chunks}  preemptions {stats['preemptions']}")
    print(f"tokens/s {stats['tokens_per_sec']}")
    print(f"TTFT p50 {stats['ttft_p50_s']} s  p99 {stats['ttft_p99_s']} s")
    print(f"TPOT p50 {stats['tpot_p50_s']} s  p99 {stats['tpot_p99_s']} s")
    print(f"decode step mean {stats['decode_step_ms_mean']} ms  "
          f"prefill chunk mean {stats['prefill_chunk_ms_mean']} ms")
    print(f"launches {launches}  (paged = {L} x {steps} decode steps; "
          f"rms = {2 * L + 1} x ({steps} + {chunks}))  peak mem {peak:.2f} GiB")
    assert stats["requests"] == 16 and stats["unfinished"] == 0
    assert all(len(s.generated) == 64 for s in eng.finished)
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    assert launches["paged_attend_update"] == L * steps > 0
    assert launches["rms_norm"] == (2 * L + 1) * (steps + chunks)
    assert launches["flash_fwd"] == launches["flash_bwd"] == 0
    stats["launches"] = launches
    stats["peak_mem_gib"] = peak
    stats["profile"] = profile_steps(eng, cfg, dev)
    del eng, params
    torch.cuda.empty_cache()
    return stats


def _zero_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    rn.fused_rms_norm.launches = 0
    pa.paged_attend_update.launches = 0
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0


def _counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    return {"rms_norm": rn.fused_rms_norm.launches,
            "paged_attend_update": pa.paged_attend_update.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches}


def train_7b(dev):
    """build_train_step at llama_7b's width, 16 of its 32 layers: 6.74 B
    params x 12 bytes (bf16 param and grad, f32 m and v) is 80.9 GB of
    state at full depth, over the card's 80 GB; at 16 layers it is 3.50 B
    x 12 = 42.0 GB."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    phase(f"train llama_7b width, {TRAIN_LAYERS} layers (bf16, B={TRAIN_B}, "
          f"S={TRAIN_S}, full remat, AdamW f32 moments)")
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=TRAIN_LAYERS)
    par = tl.ParallelConfig(remat=True, remat_policy="full")
    t0 = time.perf_counter()
    step, params, opt = tl.build_train_step(cfg, par, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = tl.count_params(cfg)
    print(f"weights and moments made on the card in "
          f"{time.perf_counter() - t0:.2f} s, {n_params / 1e9:.3f} B params")
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
               .astype(np.int32) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for i, x in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, x[:, :-1], x[:, 1:])
        losses.append(float(loss))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{losses[-1]:.6f}  {step_ms[-1]:.1f} ms")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = cfg.num_hidden_layers, len(batches)
    per_step = {k: v / n for k, v in launches.items()}
    assert all(math.isfinite(v) for v in losses), losses
    assert launches["flash_fwd"] == 2 * L * n, launches
    assert launches["flash_bwd"] == L * n, launches
    assert launches["rms_norm"] == ((2 * L + 1) + 2 * L) * n, launches
    timed = step_ms[1:]
    ms = float(np.mean(timed))
    tokens = TRAIN_B * TRAIN_S
    tps = tokens / (ms / 1e3)
    flops_tok = tl.train_flops_per_token(cfg, TRAIN_S)
    mfu = flops_tok * tps / BF16_OPS_PER_S
    print(f"step ms mean {ms:.2f} over {len(timed)} timed steps {timed}")
    print(f"tokens/s {tps:.1f}  MFU {mfu:.4f} (train_flops_per_token "
          f"{flops_tok:.4e} x tokens/s / 989 TFLOP/s)")
    print(f"launches {launches} (per step {per_step}; expected flash_fwd "
          f"2x{L}, flash_bwd {L}, rms_norm ({2 * L + 1})+2x{L})  peak mem "
          f"{peak:.2f} GiB")
    stats = {"layers": L, "batch": TRAIN_B, "seq": TRAIN_S,
             "params": n_params, "losses": losses, "step_ms": step_ms,
             "step_ms_mean": ms, "tokens_per_sec": tps, "mfu": mfu,
             "train_flops_per_token": flops_tok, "launches": launches,
             "peak_mem_gib": peak,
             "reduced": f"num_hidden_layers 32 -> {L} (state at 32 layers "
                        f"is 80.9 GB, over the 80 GB card)"}
    stats["profile"] = profile_train_step(params, opt, batches[0], cfg)
    del step, params, opt
    torch.cuda.empty_cache()
    return stats


def profile_train_step(params, opt, x, cfg):
    """Where one train step (loss and grads, then AdamW) spends device
    time: each half under torch.profiler, kernel time by class, AdamW's
    kernels as one class of their own; beside the wall time of the same
    two halves unprofiled (the profiler slows the host, so busy is device
    time over the unprofiled wall)."""
    from paddle_tpu_torch.models import llama as tl
    from torch.profiler import ProfilerActivity, profile
    phase("profile one train step")
    dev = params["embed"].device
    ids = torch.from_numpy(x[:, :-1]).to(dev)
    labels = torch.from_numpy(x[:, 1:]).to(dev)

    def grads():
        return tl.llama_loss_and_grads(params, ids, labels, cfg,
                                       tl.ParallelConfig())[1]

    wall = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = grads()
    torch.cuda.synchronize()
    wall["loss_and_grads"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tl._adamw_update(params, g, opt, 3e-4)
    torch.cuda.synchronize()
    wall["adamw"] = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        g = grads()
        torch.cuda.synchronize()
    by_class, top = _device_ms_by_class(prof)
    with profile(activities=acts) as prof:
        tl._adamw_update(params, g, opt, 3e-4)
        torch.cuda.synchronize()
    opt_classes, opt_top = _device_ms_by_class(prof)
    by_class["optimizer"] = sum(opt_classes.values())
    del g
    device_ms = sum(by_class.values())
    step_ms = sum(wall.values())
    out = {"wall_ms": wall, "device_ms": device_ms,
           "busy": device_ms / step_ms, "by_class_ms": by_class,
           "top": sorted(top + opt_top, reverse=True)[:12]}
    print(f"train step: wall {step_ms:.1f} ms unprofiled (loss+grads "
          f"{wall['loss_and_grads']:.1f} ms, AdamW {wall['adamw']:.1f} ms), "
          f"device {device_ms:.1f} ms, busy {device_ms / step_ms:.3f}")
    print(f"  by class (ms): {by_class}")
    for ms, n, key in out["top"]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key}")
    return out


def _device_ms_by_class(prof):
    """Kernel time on the card by class (ms) and the largest kernels, from
    the profiler's device-side events only: a host-side range (an aten op,
    an autograd Function) would count its kernels a second time."""
    from torch.autograd import DeviceType
    by_class, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == "Command Buffer Full":
            continue
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + ms
        top.append((ms, e.count, e.key[:90]))
    return by_class, top


def _kernel_class(name):
    if "paged_update_kernel" in name:
        return "paged_attend_update"
    if "rms_norm_kernel" in name:
        return "rms_norm"
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_kernel" in name or "dq_finalize_kernel" in name:
        return "flash_bwd"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_steps(eng, cfg, dev):
    """Where one decode step (8 rows at 1,000 cached tokens) and one
    256-token prefill chunk (at 768 cached) spend device time on the 7B
    engine's weights and pools: kernel time by class from torch.profiler,
    beside the step's host-clock wall time measured without the
    profiler. busy = device time / wall."""
    from paddle_tpu_torch.inference.kv_cache import pad_table
    from paddle_tpu_torch.models.llama import (llama_paged_decode_step,
                                               llama_paged_prefill_chunk)
    from torch.profiler import ProfilerActivity, profile
    phase("profile one decode step and one prefill chunk (llama_7b)")
    rows = [eng.pool.alloc(8) for _ in range(8)]
    tables = torch.from_numpy(np.stack(
        [pad_table(r, eng.serve.max_nb) for r in rows])).to(dev)
    positions = torch.full((8,), 1000, dtype=torch.int32, device=dev)
    ids = torch.ones((8,), dtype=torch.int32, device=dev)
    chunk = torch.ones((256,), dtype=torch.int32, device=dev)
    steps = {
        "decode_step": lambda: llama_paged_decode_step(
            eng.params, eng.k_pool, eng.v_pool, tables, positions, ids,
            cfg)[0].cpu(),
        "prefill_chunk": lambda: llama_paged_prefill_chunk(
            eng.params, eng.k_pool, eng.v_pool, tables[0], 768, chunk, 256,
            cfg)[0].cpu(),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        by_class, top = _device_ms_by_class(prof)
        device_ms = sum(by_class.values())
        wall_ms = float(np.median(walls))
        out[name] = {"wall_ms": wall_ms, "device_ms": device_ms,
                     "busy": device_ms / wall_ms, "by_class_ms": by_class,
                     "top": sorted(top, reverse=True)[:8]}
        print(f"{name}: wall {wall_ms:.3f} ms (median of 5, no profiler), "
              f"device {device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}")
        print(f"  by class (ms): {by_class}")
        for ms, n, key in out[name]["top"]:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key}")
    for r in rows:
        eng.pool.free(r)
    return out


def rms_host_cost(dev, rounds=200):
    """Host ms of the 65 RMSNorm calls of one llama_7b decode step ([8,
    4096] bf16, no grad), three ways: fused_rms_norm as the serving steps
    call it (no gradient tracked, so no autograd Function); the same
    checks and reshapes with the launch inside the Function, as a
    training step runs it; the bare launch. Alternating blocks of 65
    calls, median of ``rounds`` blocks each. The device needs 65 x ~3 us
    per block, less than the host, so the queue never fills and the host
    clock times the calls."""
    from paddle_tpu_torch.ops import rms_norm as rn
    x = torch.randn((8, 4096), device=dev, dtype=torch.bfloat16)
    w = torch.ones((4096,), device=dev, dtype=torch.bfloat16)

    def function():
        if x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError("x")
        return rn._RmsNorm.apply(x.reshape(-1, 4096), w,
                                 1e-5).reshape(x.shape)

    fns = {"no_function": lambda: rn.fused_rms_norm(x, w, 1e-5),
           "function": function,
           "launch": lambda: rn._launch(x, w, 1e-5)}
    blocks = {k: [] for k in fns}
    with torch.no_grad():
        for _ in range(rounds):
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(65):
                    fn()
                blocks[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in blocks.items()}
    print(f"rms_norm host ms per 65 calls (one decode step), median of "
          f"{rounds}: fused_rms_norm (no Function) "
          f"{med['no_function']:.4f}, through the autograd Function "
          f"{med['function']:.4f}, bare kernel launch {med['launch']:.4f}")
    return med


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _time_ms(fn, iters):
    """(device ms per call, host-paced ms per call). For the first, a spin
    kernel holds the stream while the host queues all ``iters`` calls, so
    the events time the device's back-to-back work and not the host's
    launch rate; ``queued`` says the spin outlasted the queueing. The
    second is the same loop without the spin, as a caller sees it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # cycles at a clock of at most 2 GHz: the spin lasts at least this long
    torch.cuda._sleep(int((iters * host_s + 0.02) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return dev_ms, start.elapsed_time(end) / iters, queued


def _timed(fn, iters):
    dev_ms, call_ms, queued = _time_ms(fn, iters)
    return {"ms": dev_ms, "call_ms": call_ms, "queued": queued}


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def times(dev):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    phase("times (CUDA events; ms = device time per call)")
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    # rows: a decode step, a prefill chunk, a train step (B x S)
    for n in (8, 256, TRAIN_B * TRAIN_S):
        x = torch.randn((n, 4096), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w = torch.ones((4096,), device=dev, dtype=torch.bfloat16)
        kernel = _timed(lambda: rn.fused_rms_norm(x, w, 1e-5), 200)
        # RMSNorm's arithmetic is f32 outside the tensor cores
        r = dict(kernel,
                 plain_ms=_timed(lambda: rn.rms_norm_plain(x, w, 1e-5), 100)
                 ["ms"],
                 library_ms=_timed(lambda: torch.nn.functional.rms_norm(
                     x, (4096,), w, 1e-5), 100)["ms"],
                 **_bound(2 * n * 4096 * 2 + 4096 * 2, 4 * n * 4096,
                          F32_OPS_PER_S))
        out[f"rms_norm[{n},4096]"] = r
        print(f"rms_norm [{n},4096]: {r}")
    out["rms_norm_host_ms_per_decode_step"] = rms_host_cost(dev)

    a = _paged_inputs(32, 32, PAGED_POSITIONS, SEED + 32, dev)
    b, nh, hd = a["q"].shape
    kvd, bs = a["k_pool"].shape[2], a["k_pool"].shape[3]
    ctx = sum(p + 1 for p in PAGED_POSITIONS)
    nbytes = (b * nh * hd * 2 + 2 * b * kvd * 2            # q, new k/v
              + 2 * ctx * kvd * 2                          # K and V read
              + 2 * b * kvd * 2                            # columns written
              + b * nh * hd * 4                            # attn out f32
              + a["tables"].numel() * 4 + b * 4)
    call = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
            a["tables"], a["positions"], a["layer"])
    # SDPA yardstick over the context gathered beforehand (the gather and
    # the column write are outside its time)
    tmax = max(PAGED_POSITIONS) + 1
    nb = -(-tmax // bs)
    rows = a["tables"][:, :nb].long()
    kc = a["k_pool"][a["layer"]][rows].reshape(b, nb, nh, hd, bs) \
        .permute(0, 2, 1, 4, 3).reshape(b, nh, nb * bs, hd)[:, :, :tmax]
    vc = a["v_pool"][a["layer"]][rows].reshape(b, nb, nh, hd, bs) \
        .permute(0, 2, 1, 4, 3).reshape(b, nh, nb * bs, hd)[:, :, :tmax]
    kc, vc = kc.contiguous(), vc.contiguous()
    mask = (torch.arange(tmax, device=dev)[None, :]
            <= a["positions"][:, None])[:, None, None, :]
    qd = a["q"][:, :, None, :]
    r = dict(_timed(lambda: pa.paged_attend_update(*call), 100),
             plain_ms=_timed(lambda: pa.paged_attend_update_plain(*call), 10)
             ["ms"],
             library_ms=_timed(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   qd, kc, vc, attn_mask=mask), 50)["ms"],
             **_bound(nbytes, 4 * nh * hd * ctx, BF16_OPS_PER_S),
             bytes=nbytes, context_tokens=ctx)
    out["paged_attend_update[B=8,NH=NKV=32]"] = r
    print(f"paged_attend_update B=8 NH=NKV=32 ctx {ctx} tokens: {r}")
    out.update(flash_times(dev))
    return out


def flash_times(dev):
    """The flash kernels at the train phase's shape: B=4, NH=32, S=2048,
    D=128, causal, bf16. Work counted for the live (query, key) pairs,
    S (S + 1) / 2 per head: the forward does 2 products (Q K^T, P V), the
    backward 5 (S, dP, dV, dK, dQ), 2 D operations per pair each. Bytes:
    each input read once, each output written once. Library yardsticks:
    SDPA's causal forward; for the backward, SDPA forward + backward minus
    its forward (both timed here)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    b, nh, s, d = TRAIN_B, 32, TRAIN_S, 128
    bh, scale = b * nh, 1 / math.sqrt(d)
    qs, k, v, do = _flash_inputs(bh, s, d, torch.bfloat16, SEED, dev)
    o, lse = fa.flash_fwd(qs, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    pairs = bh * s * (s + 1) // 2
    el = bh * s * d
    q4, k4, v4, do4 = (t.reshape(b, nh, s, d) for t in (qs, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def sdpa_fwd_bwd():
        o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o4, (qg, kg, vg), do4)

    lib_fwd = _timed(sdpa_fwd, 20)["ms"]
    lib_both = _timed(sdpa_fwd_bwd, 20)["ms"]
    out = {}
    r = dict(_timed(lambda: fa.flash_fwd(qs, k, v, True), 20),
             plain_ms=_timed(lambda: fa.flash_fwd_plain(qs, k, v, True),
                             2)["ms"],
             library_ms=lib_fwd,
             **_bound(4 * el * 2 + bh * s * 4, 2 * 2 * d * pairs,
                      BF16_OPS_PER_S))
    out["flash_fwd[B=4,NH=32,S=2048,D=128,causal]"] = r
    print(f"flash_fwd B=4 NH=32 S=2048 D=128 causal bf16: {r}")
    r = dict(_timed(lambda: fa.flash_bwd(qs, k, v, do, lse, delta, True,
                                         scale), 20),
             plain_ms=_timed(lambda: fa.flash_bwd_plain(
                 qs, k, v, do, lse, delta, True, scale), 2)["ms"],
             library_ms=lib_both - lib_fwd,
             library_fwd_bwd_ms=lib_both,
             **_bound(7 * el * 2 + 2 * bh * s * 4, 5 * 2 * d * pairs,
                      BF16_OPS_PER_S))
    out["flash_bwd[B=4,NH=32,S=2048,D=128,causal]"] = r
    print(f"flash_bwd B=4 NH=32 S=2048 D=128 causal bf16: {r}")
    return out


def main():
    smi = probe()
    dev = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)
    build_s = build()
    errs = check_kernels(dev)
    check_flash(dev, errs)
    check_tiny_streams(dev)
    check_tiny_train(dev)
    serve = serve_7b(dev)
    train = train_7b(dev)
    tm = times(dev)
    fwd_key = "flash_fwd[B=4,NH=32,S=2048,D=128,causal]"
    bwd_key = "flash_bwd[B=4,NH=32,S=2048,D=128,causal]"
    cols = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "rms_norm", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/rms_norm.cu",
         "replaces": "paddle_tpu/ops/rms_norm.py:34",
         "launches": serve["launches"]["rms_norm"],
         "max_abs_err": errs["rms_norm"],
         **{k: tm["rms_norm[8,4096]"][k] for k in cols}},
        {"name": "paged_attend_update", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:344",
         "launches": serve["launches"]["paged_attend_update"],
         "max_abs_err": errs["paged_attend_update"],
         **{k: tm["paged_attend_update[B=8,NH=NKV=32]"][k] for k in cols}},
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:574",
         "launches": train["launches"]["flash_fwd"],
         "max_abs_err": errs["flash_fwd"],
         **{k: tm[fwd_key][k] for k in cols}},
        {"name": "flash_bwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:1186",
         "launches": train["launches"]["flash_bwd"],
         "max_abs_err": errs["flash_bwd"],
         **{k: tm[bwd_key][k] for k in cols}},
    ]
    record = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "max_abs_err": errs, "serve": serve, "train": train,
              "times": tm}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    phase("result")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
