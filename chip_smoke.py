"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. probe   - versions, the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel source of the serving, training,
               generation and varlen paths, all at once, for sm_90a;
  3. check   - each kernel against its plain PyTorch version at the
               serving and training paths' shapes, in bf16 (and f32 flash
               and grouped-matmul cases on small adversarial layouts),
               with the tolerance stated; then a tiny fp32 Llama served
               on the card through the kernels must give the same greedy
               streams as the same engine on the CPU through the plain
               versions, and three tiny fp32 Llama and three tiny fp32
               ERNIE-MoE train steps on the card must give the CPU's
               losses; the slab decode kernels (attend+update and
               attend-only) at the generate phase's shape and on small f32
               cases with an adversarial score spread; tiny fp32 Llamas at
               head_dim 64 (slab cache) and 128 (head-major cache) must
               give the CPU's greedy and beam streams through generation;
               the varlen kernels (forward, fused backward, split dK/dV
               and dQ) at the short pack in bf16 and on small f32
               layouts (single-token and empty segments, tile edges, a
               padded tail, cross-attention with an empty k segment,
               whose rows must get exactly 0) with a score spread of
               hundreds of log2 units, fused against split, the split dQ
               bitwise over two runs, segment isolation, and GQA 32/4 at
               head_dim 64 against the CPU;
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
  6. ernie   - build_train_step on ernie_moe_fine at full width and depth
               (bf16, B=8, S=512, dropless at ep=1, AdamW with bf16
               moments for the routed experts only, seeded random weights
               and ids): one warm-up and ten timed steps; prints step ms,
               tokens/s, active-parameter MFU, every loss, the routing
               stats, peak memory and each kernel's launches counted from
               this phase alone; then the same profiler split with the
               grouped matmuls as a class of their own;
  7. generate - generate() on TinyLlama-1.1B at full width and depth
               (bf16, 22 layers, head_dim 64, GQA 32/4, seeded random
               weights and prompt ids): greedy and sampling at B=8 with
               1024-token prompts and 128 new tokens, beam search at B=2
               with 4 beams and 32 new tokens; prints prefill ms, decode
               ms per step, tokens/s, peak memory and each kernel's
               launches counted from each run alone; the token loops must
               make no host sync (sync debug mode); then torch.profiler
               splits one decode step into matmul, decode attention,
               RMSNorm and other device time beside its wall time;
  8. varlen  - paddle_tpu_torch.nn.functional.flash_attn_unpadded,
               forward and backward(), at Llama-2-7B's attention width
               (32 heads x 128, bf16, causal self-attention, seeded
               inputs) on two packs: bench.py's 16 sequences (16,000
               tokens; stacked forward and fused backward in JAX's
               choice) and 16 x 4,096 (65,536 tokens; split backward);
               prints forward and backward ms, TFLOP/s, peak memory and
               each kernel's launches counted from each pack alone, and a
               torch.profiler split of one step; the steps must make no
               host sync (sync debug mode);
  9. times   - each kernel timed with CUDA events beside its bound, its
               plain version and one PyTorch library call (a yardstick
               the port never calls); each varlen kernel is also held
               to its plain version at the pack it is timed at (the long
               pack for row 20 and the split pair);
 10. a JSON line {"kernels": [...]}, the total wall seconds, and, last,
     {"ok": true, "device": ...}.

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
# the ERNIE phase: ernie_moe_fine at B x S tokens, top-4 of 32 experts
MOE_B, MOE_S, MOE_STEPS = 8, 512, 10
# the generate phase: B prompts of GEN_S tokens, GEN_NEW new tokens each
# (greedy and sampling); beam search at BEAM_B rows x BEAM_K beams
GEN_B, GEN_S, GEN_NEW = 8, 1024, 128
BEAM_B, BEAM_K, BEAM_NEW = 2, 4, 32


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
                              "flash_attention", "grouped_matmul",
                              "decode_attention", "flash_varlen"])
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
    # (rows, H, eps): llama_7b's decode step, prefill chunk and train step
    # (B x S); ernie_moe_fine's train step, where H = 1024 launches blocks
    # of another width
    # TinyLlama's decode step and prefill (H = 2048)
    for n, h, eps in ((8, 4096, 1e-5), (256, 4096, 1e-5),
                      (TRAIN_B * TRAIN_S, 4096, 1e-5),
                      (MOE_B * MOE_S, 1024, 1e-6), (GEN_B, 2048, 1e-5),
                      (GEN_B * GEN_S, 2048, 1e-5)):
        x = torch.randn((n, h), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w = (1 + 0.1 * torch.randn((h,), generator=g, device=dev)
             ).to(torch.bfloat16)
        got = rn.fused_rms_norm(x, w, eps)
        ref = rn.rms_norm_plain(x, w, eps)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got, ref, **RMS_TOL)
        print(f"rms_norm [{n},{h}] eps {eps:g} max_abs_err {err:.3e} "
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
# BH = 128 is the Llama train phase's shape; S = 512, D = 64 the ERNIE
# phase's (B = 8 x 16 heads); S = 1024, D = 64 at BH = 256 the generate
# phase's prefill (B = 8 x 32 heads, kv heads repeated).
FLASH_TOL = {torch.float32: ((1e-5, 1e-5), (1e-4, 1e-4)),
             torch.bfloat16: ((2 ** -6, 2 ** -10), (2 ** -6, 2 ** -10))}
FLASH_CASES = [(8, 200, 128, True, torch.bfloat16),
               (8, 200, 128, False, torch.bfloat16),
               (128, 2048, 128, True, torch.bfloat16),
               (8, 2048, 128, False, torch.bfloat16),
               (128, 512, 64, True, torch.bfloat16),
               (GEN_B * 32, GEN_S, 64, True, torch.bfloat16),
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


# grouped matmul kernels against their plain versions, flash_close's rule
# (rows along the last axis). f32: sums in another order. bf16: both sum
# in f32 and round once, so a result may land one bf16 step apart: rel
# 2^-7 of (|ref| + row max + rms), frob 2^-10.
GMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -10)}
MOE_SHAPES = [(1024, 512), (512, 1024)]     # (K, N) of e_w1 and e_w2
GMM_SMALL = [("empty expert", [0, 300, 77, 0]),
             ("one expert holds all rows", [700, 0, 0, 0]),
             ("counts off the tile", [1, 127, 129, 255])]


def _slice_schedule(dev, seed=SEED):
    """The schedule of one MoE layer of the ERNIE phase: 4096 tokens
    routed top-4 over 32 experts by random f32 logits, through the
    port's dropless routing -> (counts, n_rows, sched)."""
    from paddle_tpu_torch.ops import grouped_matmul as tg
    from paddle_tpu_torch.parallel import moe as tmoe
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((MOE_B * MOE_S, 32), generator=g, device=dev)
    _, _, _, counts, n_rows = tmoe.ragged_route(logits, 4, 128)
    sched = tg.tile_schedule(counts, n_rows // 128, 128)[:2]
    return counts, n_rows, sched


def _gmm_operands(dev, dtype, n_rows, e, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lhs = torch.randn((n_rows, k), generator=g, device=dev).to(dtype)
    rhs = (torch.randn((e, k, n), generator=g, device=dev)
           / math.sqrt(k)).to(dtype)
    dout = torch.randn((n_rows, n), generator=g, device=dev).to(dtype)
    return lhs, rhs, dout


def gmm_case(tg, counts, n_rows, sched, dtype, k, n, seed, dev):
    """fwd, dX and dW against their plain versions; dead tiles and empty
    experts must be exactly zero. Returns {kernel: flash_close(...)}."""
    e = counts.shape[0]
    lhs, rhs, dout = _gmm_operands(dev, dtype, n_rows, e, k, n, seed)
    rel, frob = GMM_TOL[dtype]
    got = {"gmm_fwd": tg.gmm_fwd(lhs, rhs, sched),
           "gmm_dx": tg.gmm_dx(dout, rhs, sched),
           "gmm_dw": tg.gmm_dw(lhs, dout, sched, num_experts=e)}
    want = {"gmm_fwd": tg.gmm_fwd_plain(lhs, rhs, sched),
            "gmm_dx": tg.gmm_dx_plain(dout, rhs, sched),
            "gmm_dw": tg.gmm_dw_plain(lhs, dout, sched, num_experts=e)}
    torch.cuda.synchronize()
    live = int(tg._round_up(counts, 128).sum())
    assert (got["gmm_fwd"][live:] == 0).all(), "gmm_fwd: dead tile not 0"
    assert (got["gmm_dx"][live:] == 0).all(), "gmm_dx: dead tile not 0"
    empty = (counts == 0).nonzero().flatten().tolist()
    assert all((got["gmm_dw"][x] == 0).all() for x in empty), \
        "gmm_dw: empty expert not 0"
    return {name: flash_close(got[name], want[name], rel, frob)
            for name in got}


def check_gmm(dev, errs):
    from paddle_tpu_torch.ops import grouped_matmul as tg
    phase("check grouped-matmul kernels against their plain versions")
    counts, n_rows, sched = _slice_schedule(dev)
    cases = [(f"ERNIE slice (K, N) = ({k}, {n}), {n_rows} rows, 32 "
              f"experts", counts, n_rows, sched, torch.bfloat16, k, n)
             for k, n in MOE_SHAPES]
    for name, cl in GMM_SMALL:
        c = torch.tensor(cl, dtype=torch.int32, device=dev)
        rows = int(tg._round_up(c, 128).sum()) + 2 * 128
        sc = tg.tile_schedule(c, rows // 128, 128)[:2]
        cases += [(f"{name} {cl}", c, rows, sc, torch.float32, k, n)
                  for k, n in ((128, 64), (256, 192))]
    for i, (name, c, rows, sc, dtype, k, n) in enumerate(cases):
        res = gmm_case(tg, c, rows, sc, dtype, k, n, SEED + i, dev)
        rel, frob = GMM_TOL[dtype]
        print(f"gmm {name} K={k} N={n} {str(dtype)[6:]} (tol rel {rel:g} "
              f"of |ref| + row max + rms, frob {frob:g}; dead tiles and "
              f"empty experts exactly 0)")
        for kern, (ok, excess, fro, err) in res.items():
            print(f"  {kern}: max_abs_err {err:.3e}  worst excess over the "
                  f"limit {excess:.3e}  rel frob {fro:.3e}  "
                  f"{'ok' if ok else 'FAILED'}")
            errs[kern] = max(errs.get(kern, 0.0), err)
        assert all(r[0] for r in res.values()), f"gmm disagrees: {res}"
    torch.cuda.empty_cache()


def _tiny_ernie_config():
    from paddle_tpu_torch.models import ernie_moe as tm
    return tm.ErnieMoEConfig(vocab_size=256, hidden_size=128,
                             intermediate_size=128, num_hidden_layers=4,
                             num_attention_heads=2, num_experts=8,
                             moe_topk=2, num_shared_experts=1,
                             max_position_embeddings=128,
                             dtype=torch.float32, dispatch_mode="ragged_a2a")


MOE_FLAGS = dict(dispatch_mode="ragged_a2a", multi_precision=False,
                 with_stats=True, active_only_moments=True)


def _to_device(tree, d):
    if isinstance(tree, dict):
        return {k: _to_device(v, d) for k, v in tree.items()}
    return tree.to(d, copy=True)


def check_tiny_ernie(dev):
    """Three tiny fp32 ERNIE-MoE train steps (the slice's flags) through
    the kernels on the card give the CPU's losses and routed rows, and
    each gmm counter advances twice per MoE layer and step."""
    from paddle_tpu_torch.models import ernie_moe as tm
    phase("check a tiny fp32 ERNIE-MoE train: card kernels vs CPU plain")
    cfg = _tiny_ernie_config()
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, size=(2, 97)).astype(np.int32)
    params0 = tm.init_params(cfg, seed=1, device="cpu")
    out = []
    for d in ("cpu", dev):
        step, _, _ = tm.build_train_step(cfg, device=d, **MOE_FLAGS)
        params = _to_device(params0, d)
        opt = tm._adamw_init(params, multi_precision=False)
        _zero_counts()
        losses, rows = [], []
        for _ in range(3):
            params, opt, loss, st = step(params, opt, x[:, :-1], x[:, 1:])
            losses.append(float(loss))
            rows.append(st["moe_expert_rows"].cpu().tolist())
        out.append((losses, rows, _counts()))
    (cpu, rows0, c0), (card, rows1, c1) = out
    n = 3 * 2 * cfg.num_hidden_layers // 2
    assert all(c0[k] == 0 for k in ("gmm_fwd", "gmm_dx", "gmm_dw")), c0
    assert all(c1[k] == n for k in ("gmm_fwd", "gmm_dx", "gmm_dw")), c1
    assert rows0 == rows1, (rows0, rows1)
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL)
    print(f"losses card {card} cpu {cpu} (rtol {TRAIN_LOSS_RTOL}); routed "
          f"rows identical; launches gmm_fwd {c1['gmm_fwd']} gmm_dx "
          f"{c1['gmm_dx']} gmm_dw {c1['gmm_dw']} flash_fwd "
          f"{c1['flash_fwd']} flash_bwd {c1['flash_bwd']}")


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


# slab decode kernels against their plain versions, flash_close's rule
# (rows along HD). f32: sums in another order. bf16: P is rounded before
# P.V in both, yet a result may land one bf16 step apart: rel 2^-6, frob
# 2^-10, as for flash. The generate phase's cache: T = round_up(1024 +
# 128, 128) = 1152; pos 127/128 straddle a tile edge, 1151 is T - 1.
SLAB_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -10)}
SLAB_T = 1152
SLAB_POSITIONS = [0, 127, 128, 1023, 1151]
SPREAD_SCALE = 150.0    # tile 1's keys scaled: its scores lead by > 130


def _slab_inputs(dev, dtype, b, nh, nkv, hd, T, seed, spread=None):
    """q pre-scaled [B, NH, HD], new k/v [B, KVD], caches [2, B, KVD, T];
    with ``spread`` the keys of columns 128..255 are scaled by it."""
    from paddle_tpu_torch.ops.decode_attention import LOG2E
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = nkv * hd

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q = (torch.randn((b, nh, hd), generator=g, device=dev)
         * (LOG2E / math.sqrt(hd))).to(dtype)
    kc, vc = randn(2, b, kvd, T), randn(2, b, kvd, T)
    if spread:
        kc[:, :, :, 128:256] *= spread
    return q, randn(b, kvd), randn(b, kvd), kc, vc


def slab_case(da, dtype, b, nh, nkv, hd, T, positions, seed, dev,
              spread=None):
    """Both slab kernels against their plain versions at each position of
    layer 1: the attention under flash_close (merged over positions), the
    caches bitwise (column pos holds new k/v, no other column changed).
    Returns ({kernel: (ok, excess, frob, max err)}, the largest lead of
    tile 1's score max over tile 0's, in log2 units)."""
    q, nk, nv, kc, vc = _slab_inputs(dev, dtype, b, nh, nkv, hd, T, seed,
                                     spread)
    s = torch.einsum("bgrd,bgdt->bgrt",
                     q.float().reshape(b, nkv, nh // nkv, hd),
                     kc[1].float().reshape(b, nkv, hd, T)[..., :256])
    lead = (s[..., 128:].amax(-1) - s[..., :128].amax(-1)).max().item()
    rel, frob = SLAB_TOL[dtype]
    res = {}
    for pos in positions:
        k0, v0 = kc.clone(), vc.clone()
        got_ro = da.decode_attention_slab(q, kc, vc, 1, pos)
        ref_ro = da.decode_attention_plain(q, k0, v0, 1, pos)
        kp, vp = kc.clone(), vc.clone()
        got = da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, pos)
        ref = da.decode_attend_update_plain(q, nk, nv, kp, vp, 1, pos)
        torch.cuda.synchronize()
        assert torch.equal(kc, kp) and torch.equal(vc, vp), \
            f"slab caches differ from the plain version's at pos {pos}"
        k0[1, :, :, pos], v0[1, :, :, pos] = nk, nv
        assert torch.equal(kc, k0) and torch.equal(vc, v0), \
            f"column {pos} not written, or another column changed"
        for name, a, r in (("decode_attend_update_slab", got, ref),
                           ("decode_attention_slab", got_ro, ref_ro)):
            c = flash_close(a, r, rel, frob)
            p = res.get(name, (True, -math.inf, 0.0, 0.0))
            res[name] = (p[0] and c[0], max(p[1], c[1]), max(p[2], c[2]),
                         max(p[3], c[3]))
    return res, lead


def check_decode(dev, errs):
    from paddle_tpu_torch.ops import decode_attention as da
    phase("check slab decode kernels against their plain versions")
    cases = [(f"generate shape B={GEN_B} NH=32 NKV=4 HD=64 T={SLAB_T}",
              torch.bfloat16, GEN_B, 32, 4, 64, SLAB_T, SLAB_POSITIONS, None)]
    cases += [(f"adversarial spread, rep {r}, B=2 NKV=2 HD=32 T=256",
               torch.float32, 2, 2 * r, 2, 32, 256, [0, 127, 128, 200, 255],
               SPREAD_SCALE) for r in (1, 2, 4)]
    for i, (name, dtype, b, nh, nkv, hd, T, positions, spread) in \
            enumerate(cases):
        res, lead = slab_case(da, dtype, b, nh, nkv, hd, T, positions,
                              SEED + i, dev, spread)
        rel, frob = SLAB_TOL[dtype]
        print(f"slab {name} {str(dtype)[6:]} positions {positions} (tol "
              f"rel {rel:g} of |ref| + row max + rms, frob {frob:g}; caches "
              f"bitwise): tile 1 leads tile 0 by up to {lead:.1f} log2 "
              f"units")
        for kern, (ok, excess, fro, err) in res.items():
            print(f"  {kern}: max_abs_err {err:.3e}  worst excess over the "
                  f"limit {excess:.3e}  rel frob {fro:.3e}  "
                  f"{'ok' if ok else 'FAILED'}")
            errs[kern] = max(errs.get(kern, 0.0), err)
        assert all(r[0] for r in res.values()), f"slab kernels disagree: {res}"
        assert spread is None or lead > 130, f"spread only {lead}"
    torch.cuda.empty_cache()


def check_tiny_generate(dev):
    """Tiny fp32 Llamas through greedy and beam search (eos, length
    penalty) on the card give the CPU's token streams, beam scores within
    1e-5: head_dim 64 through the slab kernel, head_dim 128 through the
    head-major einsums."""
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.ops import decode_attention as da
    phase("check tiny fp32 Llamas: generation on the card vs the CPU")
    prompt = np.random.RandomState(SEED).randint(0, 96, (2, 126)).astype(
        np.int32)
    for hidden in (128, 256):                       # head_dim 64 and 128
        cfg = tl.llama_tiny(vocab=96, hidden=hidden, layers=2, heads=2,
                            kv_heads=1, seq=512)
        params = tl.init_llama_params(cfg, seed=2, device="cpu")
        out = []
        for d in ("cpu", dev):
            p = _to_device(params, d)
            da.decode_attend_update_slab.launches = 0
            greedy = tl.greedy_generate(p, prompt, cfg, 6, device=d)
            seqs, scores = tl.beam_search_generate(
                p, prompt, cfg, 5, num_beams=3, eos_token_id=3,
                length_penalty=0.6, device=d)
            out.append((greedy, seqs, scores,
                        da.decode_attend_update_slab.launches))
        (g0, s0, sc0, n0), (g1, s1, sc1, n1) = out
        np.testing.assert_array_equal(g1, g0)
        np.testing.assert_array_equal(s1, s0)
        np.testing.assert_allclose(sc1, sc0, atol=1e-5, rtol=0)
        want = 2 * (5 + 4) if cfg.head_dim < 128 else 0
        assert (n0, n1) == (0, want), (n0, n1)
        print(f"head_dim {cfg.head_dim}: greedy {g1.tolist()} and beams "
              f"identical, scores max diff {np.abs(sc1 - sc0).max():.2e} "
              f"(tol 1e-5); slab kernel launches {n1}")


# varlen kernels against their plain versions under flash_close, with the
# flash limits: bf16 rel 2^-6, frob 2^-10; f32 1e-5 forward, 1e-4
# backward; lse 1e-4 absolute. The short pack is bench.py's 16 lengths
# (16,000 tokens), the long pack 16 x 4,096 (65,536); both at Llama-2-7B's
# attention width, 32 heads x 128, bf16, causal self-attention.
VARLEN_SHORT = [2048, 512, 1024, 3072, 256, 896, 1536, 2048,
                128, 512, 768, 1024, 640, 384, 512, 640]
VARLEN_LONG = [4096] * 16
VARLEN_H, VARLEN_D = 32, 128
VARLEN_TOL = FLASH_TOL
# f32 layouts of tests/test_varlen_bwd_parity.py (lens_q, lens_k or None
# for self-attention), the last two cross-attention
VARLEN_F32 = [([1] * 9, None), ([128, 256, 128], None), ([100, 61], None),
              ([64, 0, 100, 0, 31], None), ([1, 128, 3, 257, 1], None),
              ([40, 8, 30], [64, 0, 32]), ([50, 20, 90], [30, 70, 90])]


def _cu_dev(lens, dev):
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32, device=dev)


def _varlen_inputs(dev, dtype, lens_q, lens_k, h, d, seed, spread=None):
    """Packed [T, H, D] q, k, v, do made on the card from a seed drawn
    with numpy; keys 64..127 scaled by ``spread`` (scores there lead by
    hundreds of log2 units)."""
    g = torch.Generator(device=dev).manual_seed(
        int(np.random.RandomState(seed).randint(2 ** 31)))
    tq, tk = sum(lens_q), sum(lens_q if lens_k is None else lens_k)

    def randn(t):
        return torch.randn((t, h, d), generator=g, device=dev).to(dtype)

    q, k, v, do = randn(tq), randn(tk), randn(tk), randn(tq)
    if spread:
        k[64:128] *= spread
    return q, k, v, do


def _spread_lead(q, k):
    """The largest lead, in log2 units, of a query's best score over keys
    64..127 over its best over keys 0..63 (None below 65 keys)."""
    if k.shape[0] <= 64:
        return None
    s = torch.einsum("qhd,khd->hqk", q.float(), k[:128].float()) \
        * (q.shape[-1] ** -0.5 * 1.4426950408889634)
    return (s[..., 64:].amax(-1) - s[..., :64].amax(-1)).max().item()


def varlen_case(fv, q, k, v, do, cu_q, cu_k, causal, dtype):
    """Every varlen kernel against its plain version on packed [T, H, D]
    inputs (read in place through [H, T, D] views): {output:
    flash_close(...)}, the lse's max abs error, and the outputs."""
    (rel_f, frob_f), (rel_b, frob_b) = VARLEN_TOL[dtype]
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
    o, lse = fv.varlen_fwd(qh, kh, vh, cu_q, cu_k, causal, scale)
    o_ref, lse_ref = fv.varlen_fwd_plain(qh, kh, vh, cu_q, cu_k, causal,
                                         scale)
    delta = (doh.float() * o_ref.float()).sum(-1).contiguous()
    args = (qh, kh, vh, doh, lse_ref, delta, cu_q, cu_k, causal, scale)
    got = {"fused": fv.varlen_bwd(*args),
           "split": (fv.varlen_bwd_dq(*args), *fv.varlen_bwd_dkv(*args))}
    want = fv.varlen_bwd_plain(*args)
    torch.cuda.synchronize()
    res = {"o": flash_close(o, o_ref, rel_f, frob_f)}
    for path, grads in got.items():
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            res[f"{path} {name}"] = flash_close(a, b, rel_b, frob_b)
    return res, (lse - lse_ref).abs().max().item(), (o, lse, got)


def _varlen_err(errs, res):
    errs["varlen_fwd"] = max(errs.get("varlen_fwd", 0.0), res["o"][3])
    for kern, keys in (("varlen_bwd", ("fused dq", "fused dk", "fused dv")),
                       ("varlen_bwd_dq", ("split dq",)),
                       ("varlen_bwd_dkv", ("split dk", "split dv"))):
        errs[kern] = max(errs.get(kern, 0.0), *(res[n][3] for n in keys))


def check_varlen(dev, errs):
    from paddle_tpu_torch.ops import flash_varlen as fv
    phase("check varlen kernels against their plain versions")
    cases = [(f"short pack H={VARLEN_H} D={VARLEN_D}", torch.bfloat16,
              VARLEN_SHORT, None, VARLEN_H, VARLEN_D, None)]
    cases += [(f"layout {lq}/{lk}", torch.float32, lq, lk, 2, d, SPREAD_SCALE)
              for (lq, lk), d in zip(VARLEN_F32, (64, 128) * 4)]
    for i, (name, dtype, lq, lk, h, d, spread) in enumerate(cases):
        q, k, v, do = _varlen_inputs(dev, dtype, lq, lk, h, d, SEED + i,
                                     spread)
        cu_q = _cu_dev(lq, dev)
        cu_k = cu_q if lk is None else _cu_dev(lk, dev)
        for causal in ((True,) if lk is None and h > 2 else (True, False)):
            res, err_lse, (o, lse, got) = varlen_case(
                fv, q, k, v, do, cu_q, cu_k, causal, dtype)
            lead = _spread_lead(q, k) if spread else None
            lead = "" if lead is None else (
                f", keys 64..127 lead keys 0..63 by up to {lead:.1f} log2 "
                f"units")
            print(f"varlen {name} causal={causal} {str(dtype)[6:]} H={h} "
                  f"D={d}: lse max_abs_err {err_lse:.2e}{lead}")
            for out, (ok, excess, fro, err) in res.items():
                print(f"  {out}: max_abs_err {err:.3e}  worst excess "
                      f"{excess:.3e}  rel frob {fro:.3e}  "
                      f"{'ok' if ok else 'FAILED'}")
            assert all(r[0] for r in res.values()), f"varlen disagrees: {res}"
            assert err_lse <= 1e-4, f"varlen lse err {err_lse}"
            _varlen_err(errs, res)
            if lk is not None and 0 in lk:
                s0 = lk.index(0)
                r0, r1 = sum(lq[:s0]), sum(lq[:s0 + 1])
                for x in (o, got["fused"][0], got["split"][0]):
                    assert (x[:, r0:r1] == 0).all(), "empty k segment: not 0"
                print(f"  rows {r0}..{r1 - 1} (empty k segment): o, fused "
                      f"and split dq exactly 0")
        torch.cuda.empty_cache()
    check_varlen_paths(fv, dev, errs)


def check_varlen_paths(fv, dev, errs):
    """Fused against split at the short pack (bf16 limits), the split dQ
    bitwise over two runs, segment isolation, and GQA at TinyLlama's width
    through the autograd entry against the CPU's plain versions."""
    q, k, v, do = _varlen_inputs(dev, torch.bfloat16, VARLEN_SHORT, None,
                                 VARLEN_H, VARLEN_D, SEED + 40)
    cu = _cu_dev(VARLEN_SHORT, dev)
    scale = VARLEN_D ** -0.5
    rel, frob = VARLEN_TOL[torch.bfloat16][1]

    def grads(k, v):
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        o, lse = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        delta = (doh.float() * o.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        return o, fv.varlen_bwd(*args), fv.varlen_bwd_dq(*args), \
            fv.varlen_bwd_dkv(*args)

    o, fused, dq, dkv = grads(k, v)
    dq2 = grads(k, v)[2]
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2), "split dQ differs between two runs"
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), fused, (dq,) + dkv):
        ok, excess, fro, err = flash_close(a, b, rel, frob)
        worst = max(worst, fro)
        assert ok, f"fused and split {name} disagree: {excess} {fro}"
    print(f"varlen short pack: fused vs split dq, dk, dv within rel {rel:g}"
          f"/frob {frob:g} (worst rel frob {worst:.3e}); split dq bitwise "
          f"equal over two runs")
    seg = slice(sum(VARLEN_SHORT[:3]), sum(VARLEN_SHORT[:4]))  # 3,072
    k2, v2 = k.clone(), v.clone()
    k2[seg] = -3 * k2[seg]
    v2[seg] = v2[seg] + 1
    o2, fused2, dq_2, dkv2 = grads(k2, v2)
    torch.cuda.synchronize()
    keep = torch.ones(sum(VARLEN_SHORT), dtype=torch.bool, device=dev)
    keep[seg] = False
    for a, b in zip((o, fused[1], fused[2], dq) + dkv,
                    (o2, fused2[1], fused2[2], dq_2) + dkv2):
        assert torch.equal(a[:, keep], b[:, keep]), "segments interact"
    assert flash_close(fused2[0][:, keep], fused[0][:, keep], rel, frob)[0]
    assert not torch.equal(o[:, seg], o2[:, seg])
    print("varlen isolation: segment 3's k and v changed; every other "
          "segment's o, dq (split), dk and dv bitwise the same, fused dq "
          "within the bf16 limits (atomics)")
    del q, k, v, do, k2, v2, fused, fused2, dkv, dkv2
    torch.cuda.empty_cache()

    # GQA, TinyLlama's attention width: 32 q heads over 4 kv heads, D 64
    lens = [300, 1, 64, 500, 135]
    rng = np.random.RandomState(SEED + 41)
    host = [torch.from_numpy(rng.randn(sum(lens), h, 64).astype(np.float32))
            for h in (32, 4, 4)]
    dout = torch.from_numpy(rng.randn(sum(lens), 32, 64).astype(np.float32))
    outs = []
    for d in ("cpu", dev):
        x = [a.to(d, copy=True).requires_grad_() for a in host]
        c = _cu_dev(lens, d)
        o = fv.flash_varlen_attention(*x, c, c, 0.125, True)
        o.backward(dout.to(d))
        outs.append([o.detach().cpu()] + [a.grad.cpu() for a in x])
    for name, a, b, (r, f) in zip(("o", "dq", "dk", "dv"), outs[1], outs[0],
                                  ((1e-5, 1e-5),) + ((1e-4, 1e-4),) * 3):
        ok, excess, fro, err = flash_close(a, b, r, f)
        print(f"varlen GQA 32/4 D=64 f32 {name}: card kernels vs CPU plain "
              f"max_abs_err {err:.3e}  rel frob {fro:.3e}  "
              f"{'ok' if ok else 'FAILED'}")
        assert ok, f"GQA {name} disagrees"


VARLEN_ITERS = {"short": 5, "long": 3}
VARLEN_KERNELS = ("varlen_fwd", "varlen_bwd", "varlen_bwd_dkv",
                  "varlen_bwd_dq")


def _host_syncs(fn):
    """Runs fn() under torch.cuda's sync debug mode, which warns on every
    call that waits for the card; returns those warnings."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def varlen_phase(dev):
    """flash_attn_unpadded, forward and backward(), at Llama-2-7B's
    attention width (32 heads x 128, bf16, causal self-attention: one cu
    object for q and k), on the short and the long pack. Per pack: one
    warm-up step, one step under sync debug mode (no host sync allowed),
    then timed steps: forward ms and backward ms from CUDA events, TFLOP/s
    (forward 4 H D sum(L^2) / 2, bench.py's count; backward 2.5 times
    that), peak memory, each kernel's launches counted from this pack's
    run alone, and a torch.profiler split of one more step."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_varlen as fv
    phase(f"varlen: flash_attn_unpadded fwd+bwd, {VARLEN_H} heads x "
          f"{VARLEN_D}, bf16, causal, short and long packs")
    out = {"packs": {}}
    for name, lens in (("short", VARLEN_SHORT), ("long", VARLEN_LONG)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        q, k, v, do = _varlen_inputs(dev, torch.bfloat16, lens, None,
                                     VARLEN_H, VARLEN_D, SEED + 50)
        xs = [x.requires_grad_() for x in (q, k, v)]
        cu = _cu_dev(lens, dev)
        longest, total = max(lens), sum(lens)

        def fwd():
            return F.flash_attn_unpadded(*xs, cu, cu, longest, longest,
                                         causal=True)[0]

        def step():
            for x in xs:
                x.grad = None
            fwd().backward(do)

        step()
        torch.cuda.synchronize()
        syncs = _host_syncs(step)
        assert not syncs, syncs
        iters = VARLEN_ITERS[name]
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(iters)]
        for e0, e1, e2 in ev:
            for x in xs:
                x.grad = None
            e0.record()
            o = fwd()
            e1.record()
            o.backward(do)
            e2.record()
        torch.cuda.synchronize()
        fwd_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in ev) / iters
        bwd_ms = sum(e1.elapsed_time(e2) for _, e1, e2 in ev) / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert o.shape == (total, VARLEN_H, VARLEN_D) \
            and o.dtype == torch.bfloat16
        assert all(bool(torch.isfinite(t).all())
                   for t in [o] + [x.grad for x in xs])
        prof = profile_varlen(step)
        launches = _counts()
        runs = iters + 3        # warm-up, sync check, timed, profiled
        stacked, fused = fv.plan_path(total, total, len(lens), VARLEN_H,
                                      VARLEN_D, torch.bfloat16, True)
        want = {"varlen_fwd": runs, "varlen_bwd": runs if fused else 0,
                "varlen_bwd_dkv": 0 if fused else runs,
                "varlen_bwd_dq": 0 if fused else runs}
        assert all(launches[kk] == n for kk, n in want.items()), launches
        assert all(n == 0 for kk, n in launches.items() if kk not in want), \
            launches
        flops = 4 * VARLEN_H * VARLEN_D * sum(L * L for L in lens) / 2
        r = {"lens": lens, "tokens": total, "max_seqlen": longest,
             "stacked_row_19": stacked, "fused_backward": fused,
             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
             "fwd_tflops": flops / fwd_ms / 1e9,
             "bwd_tflops": 2.5 * flops / bwd_ms / 1e9,
             "peak_mem_gib": peak, "host_syncs": len(syncs),
             "launches": launches, "profile": prof}
        out["packs"][name] = r
        print(f"{name} pack: {len(lens)} sequences, {total} tokens, longest "
              f"{longest}; path: {'stacked (row 19)' if stacked else 'row 20'}"
              f" forward, {'fused (row 21)' if fused else 'split (rows 22, 23)'}"
              f" backward")
        print(f"  forward {fwd_ms:.3f} ms ({r['fwd_tflops']:.1f} TFLOP/s), "
              f"backward {bwd_ms:.3f} ms ({r['bwd_tflops']:.1f} TFLOP/s), "
              f"peak mem {peak:.2f} GiB, host syncs {len(syncs)}")
        print(f"  launches {launches} ({runs} fwd+bwd runs)")
        del q, k, v, do, xs, o
    out["launches"] = {kk: sum(r["launches"][kk] for r in
                               out["packs"].values()) for kk in VARLEN_KERNELS}
    torch.cuda.empty_cache()
    return out


def profile_varlen(step):
    """One fwd+bwd under torch.profiler: device ms of the varlen kernels
    against everything else (the delta reduction, the dQ cast, copies).
    A small kernel and a synchronize come first inside the window: the
    tracer can miss the first launches after it starts."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        step()
        torch.cuda.synchronize()
    by_class, top = _device_ms_by_class(prof)
    by_class.pop("warm-up", None)
    top = [x for x in top if "spin_kernel" not in x[2]]
    device_ms = sum(by_class.values())
    print(f"  profile of one fwd+bwd: device {device_ms:.3f} ms, by class "
          f"(ms) {by_class}")
    for ms, n, key in sorted(top, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms  x{n:<3d} {key}")
    return {"device_ms": device_ms, "by_class_ms": by_class,
            "top": sorted(top, reverse=True)[:8]}


def _library_varlen(q, k, v, do, cu, longest, scale):
    """One PyTorch call for the same packed attention, the yardstick the
    port never calls: aten's _flash_attention_forward / _backward with
    cum_seq (the same packed layout); where torch refuses them, SDPA over
    a block-diagonal causal boolean mask (None above 2^15 tokens, where
    the mask alone is too large). Returns (what was timed, forward,
    backward, the refusal met, if any)."""
    errors = []
    A = torch.ops.aten
    try:
        res = A._flash_attention_forward(q, k, v, cu, cu, longest, longest,
                                         0.0, True, False, scale=scale)
        o, lse, rng, unused = res[0], res[1], res[2], res[3]

        def fwd():
            return A._flash_attention_forward(q, k, v, cu, cu, longest,
                                              longest, 0.0, True, False,
                                              scale=scale)

        def bwd():
            return A._flash_attention_backward(do, q, k, v, o, lse, cu, cu,
                                               longest, longest, 0.0, True,
                                               rng, unused, scale=scale)
        bwd()
        torch.cuda.synchronize()
        return "aten._flash_attention_forward/_backward (cum_seq)", fwd, \
            bwd, errors
    except RuntimeError as e:   # a refused call: recorded, then SDPA
        errors.append(f"aten._flash_attention_*: {type(e).__name__}: "
                      f"{str(e)[:300]}")
    t = q.shape[0]
    if t > 1 << 15:
        return None, None, None, errors
    seg = torch.searchsorted(cu.long(), torch.arange(t, device=q.device),
                             right=True)
    idx = torch.arange(t, device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (idx[:, None] >= idx[None, :])
    q4, k4, v4, do4 = (x.transpose(0, 1)[None] for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    F = torch.nn.functional

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              scale=scale)

    def both():
        o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                            scale=scale)
        return torch.autograd.grad(o4, (qg, kg, vg), do4)
    return "SDPA over a block-diagonal causal mask (bwd: fwd+bwd - fwd)", \
        fwd, both, errors


def _varlen_held(kern, pack, fn, plain, names):
    """fn() against plain() output by output (bf16 limits; an f32 lse to
    1e-4 absolute); asserts, and returns the errors."""
    (rel_f, frob_f), (rel_b, frob_b) = VARLEN_TOL[torch.bfloat16]
    got, want = fn(), plain()
    got, want = (got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))
    torch.cuda.synchronize()
    res = {}
    for out, a, b in zip(names, got, want):
        if out == "lse":
            err = (a - b).abs().max().item()
            res[out] = (err <= 1e-4, err - 1e-4, None, err)
        else:
            rel, frob = (rel_f, frob_f) if out == "o" else (rel_b, frob_b)
            res[out] = flash_close(a, b, rel, frob)
    print(f"{kern} at the {pack} pack against its plain version: " + ", ".join(
        f"{out} max_abs_err {r[3]:.3e} {'ok' if r[0] else 'FAILED'}"
        for out, r in res.items()))
    assert all(r[0] for r in res.values()), f"{kern} {pack} disagrees: {res}"
    return {"max_abs_err": max(r[3] for n, r in res.items() if n != "lse"),
            "outputs": {n: {"max_abs_err": r[3], "rel_frob": r[2]}
                        for n, r in res.items()}}


def varlen_times(dev, errs):
    """Rows 20-23 at the varlen phase's shapes (32 heads x 128, bf16,
    causal): the forward and the fused backward at the short pack (their
    main-path shape), the forward and the split pair at the long pack.
    Each timed kernel's outputs are held to its plain version's on the
    same inputs under the bf16 limits (o, dq, dk, dv; lse within 1e-4),
    and the errors join ``errs``. Work counted for the live pairs,
    sum L (L + 1) / 2 a head: the forward does 2 products (QK^T, PV), the fused backward 5, the split dK/dV 4
    (S, dV, dP, dK) and dQ 3 (S, dP, dQ), 2 D operations per pair each.
    Bytes: each input read once (q, k, v, dO, lse, delta as the kernel
    takes them), each output written once."""
    from paddle_tpu_torch.ops import flash_varlen as fv
    h, d, scale = VARLEN_H, VARLEN_D, VARLEN_D ** -0.5
    out = {}
    for name, lens in (("short", VARLEN_SHORT), ("long", VARLEN_LONG)):
        q, k, v, do = _varlen_inputs(dev, torch.bfloat16, lens, None, h, d,
                                     SEED + 60)
        cu = _cu_dev(lens, dev)
        t, longest = sum(lens), max(lens)
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        o, lse = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        delta = (doh.float() * o.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        pairs = h * sum(L * (L + 1) // 2 for L in lens)
        el = t * h * d * 2              # one [T, H, D] bf16 tensor, bytes
        st = t * h * 4                  # one [H, T] f32 row statistic
        desc, lib_fwd, lib_bwd, refused = _library_varlen(q, k, v, do, cu,
                                                          longest, scale)
        lf = _timed(lib_fwd, 10)["ms"] if lib_fwd else None
        lb = _timed(lib_bwd, 10)["ms"] if lib_bwd else None
        if lb is not None and desc.startswith("SDPA"):
            lb -= lf
        calls = [("varlen_fwd", lambda: fv.varlen_fwd(qh, kh, vh, cu, cu,
                                                      True, scale),
                  lambda: fv.varlen_fwd_plain(qh, kh, vh, cu, cu, True,
                                              scale),
                  4 * el + st, 2, lf, ("o", "lse"))]
        if name == "short":
            calls.append(("varlen_bwd", lambda: fv.varlen_bwd(*args),
                          lambda: fv.varlen_bwd_plain(*args),
                          7 * el + 2 * st, 5, lb, ("dq", "dk", "dv")))
        else:
            calls += [("varlen_bwd_dkv", lambda: fv.varlen_bwd_dkv(*args),
                       lambda: fv.varlen_bwd_dkv_plain(*args),
                       6 * el + 2 * st, 4, lb, ("dk", "dv")),
                      ("varlen_bwd_dq", lambda: fv.varlen_bwd_dq(*args),
                       lambda: fv.varlen_bwd_dq_plain(*args),
                       5 * el + 2 * st, 3, lb, ("dq",))]
        for kern, fn, plain, nbytes, products, lib, names in calls:
            check = _varlen_held(kern, name, fn, plain, names)
            errs[kern] = max(errs.get(kern, 0.0), check["max_abs_err"])
            r = dict(_timed(fn, 10), plain_ms=_timed(plain, 1)["ms"],
                     check=check,
                     library_ms=lib, library=desc,
                     library_refusals=refused,
                     **_bound(nbytes, products * 2 * d * pairs,
                              BF16_OPS_PER_S),
                     bytes=nbytes, operations=products * 2 * d * pairs,
                     live_pairs=pairs)
            key = f"{kern}[{name} pack,T={t},H={h},D={d},causal]"
            out[key] = r
            print(f"{key} bf16: {r}")
        del q, k, v, do, o, args
        torch.cuda.empty_cache()
    return out


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
    assert launches["gmm_fwd"] == launches["gmm_dx"] == \
        launches["gmm_dw"] == 0
    stats["launches"] = launches
    stats["peak_mem_gib"] = peak
    stats["profile"] = profile_steps(eng, cfg, dev)
    del eng, params
    torch.cuda.empty_cache()
    return stats


def _zero_counts():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import grouped_matmul as tg
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    for name in VARLEN_KERNELS:
        getattr(fv, name).launches = 0
    rn.fused_rms_norm.launches = 0
    pa.paged_attend_update.launches = 0
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    tg.gmm_fwd.launches = tg.gmm_dx.launches = tg.gmm_dw.launches = 0
    da.decode_attend_update_slab.launches = 0
    da.decode_attention_slab.launches = 0


def _counts():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import grouped_matmul as tg
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    return {**{name: getattr(fv, name).launches for name in VARLEN_KERNELS},
            "rms_norm": rn.fused_rms_norm.launches,
            "paged_attend_update": pa.paged_attend_update.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "gmm_fwd": tg.gmm_fwd.launches,
            "gmm_dx": tg.gmm_dx.launches,
            "gmm_dw": tg.gmm_dw.launches,
            "decode_attend_update_slab": da.decode_attend_update_slab.launches,
            "decode_attention_slab": da.decode_attention_slab.launches}


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


def train_ernie(dev):
    """build_train_step on ernie_moe_fine at full width and depth (bf16,
    B=8, S=512), the dropless path with bench.py's moe flags: one warm-up
    and MOE_STEPS timed steps."""
    from paddle_tpu_torch.models import ernie_moe as tm
    phase(f"train ernie_moe_fine (bf16, 8 layers, 32 experts top-4, "
          f"B={MOE_B}, S={MOE_S}, dropless, no recompute, AdamW bf16 "
          f"moments, active-only)")
    cfg = tm.ernie_moe_fine()
    t0 = time.perf_counter()
    step, params, opt = tm.build_train_step(cfg, lr=1e-4, seed=SEED,
                                            device=dev, **MOE_FLAGS)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights and moments made on the card in "
          f"{time.perf_counter() - t0:.2f} s, {n_params / 1e6:.2f} M "
          f"params, {tm.active_params(cfg) / 1e6:.2f} M active per token")
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(MOE_B, MOE_S + 1))
               .astype(np.int32) for _ in range(MOE_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms, stats = [], [], []
    for i, x in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss, st = step(params, opt, x[:, :-1], x[:, 1:])
        losses.append(float(loss))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        stats.append({k: v.tolist() for k, v in st.items()})
        print(f"step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{losses[-1]:.6f}  lm_loss {stats[-1]['lm_loss']:.6f}  "
              f"{step_ms[-1]:.1f} ms")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n, L = len(batches), cfg.num_hidden_layers
    n_moe = L // 2
    per_step = {k: v / n for k, v in launches.items()}
    assert all(math.isfinite(v) for v in losses), losses
    for k in ("gmm_fwd", "gmm_dx", "gmm_dw"):
        assert launches[k] == 2 * n_moe * n, launches
    assert launches["flash_fwd"] == launches["flash_bwd"] == L * n, launches
    assert launches["rms_norm"] == (2 * L + 1) * n, launches
    assert launches["paged_attend_update"] == 0, launches
    assert all(s["moe_dropped_tokens"] == 0 for s in stats)
    assert all(s["moe_routed_tokens"] == MOE_B * MOE_S * cfg.moe_topk
               * n_moe for s in stats)
    timed = step_ms[1:]
    ms = float(np.mean(timed))
    tps = MOE_B * MOE_S / (ms / 1e3)
    flops_tok = tm.train_flops_per_token(cfg, MOE_S)
    mfu = flops_tok * tps / BF16_OPS_PER_S
    print(f"step ms mean {ms:.2f} over {len(timed)} timed steps "
          f"{[round(t, 2) for t in timed]}")
    print(f"tokens/s {tps:.1f}  active MFU {mfu:.4f} (6 x {tm.active_params(cfg)}"
          f" active params + 12 L H S = {flops_tok:.4e} flops/token x "
          f"tokens/s / 989 TFLOP/s)")
    last = stats[-1]
    print(f"routing stats of the last step (summed over {n_moe} MoE layers;"
          f" imbalance averaged): "
          f"{ {k: v for k, v in last.items() if k != 'moe_expert_rows'} }")
    print(f"  moe_expert_rows {last['moe_expert_rows']}")
    print(f"launches {launches} (per step {per_step}; expected gmm_fwd, "
          f"gmm_dx, gmm_dw 2x{n_moe}, flash_fwd and flash_bwd {L}, rms_norm "
          f"{2 * L + 1})  peak mem {peak:.2f} GiB")
    out = {"config": "ernie_moe_fine", "layers": L, "batch": MOE_B,
           "seq": MOE_S, "params": n_params,
           "active_params": tm.active_params(cfg), "losses": losses,
           "routing_stats": stats, "step_ms": step_ms, "step_ms_mean": ms,
           "tokens_per_sec": tps, "active_mfu": mfu,
           "train_flops_per_token": flops_tok, "launches": launches,
           "peak_mem_gib": peak, "recompute": False}
    out["profile"] = profile_ernie_step(params, opt, batches[0], cfg)
    del step, params, opt
    torch.cuda.empty_cache()
    return out


def tinyllama_1_1b():
    """TinyLlama-1.1B, a Llama-2-architecture model at head_dim 64, from
    its published config (huggingface.co/TinyLlama/
    TinyLlama-1.1B-intermediate-step-1431k-3T, config.json): hidden 2048,
    intermediate 5632, 22 layers, 32 heads over 4 kv heads, vocab 32000,
    2048 positions, rms eps 1e-5, rope theta 10000, untied head."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=22,
                       num_attention_heads=32, num_key_value_heads=4,
                       max_position_embeddings=2048, rms_norm_eps=1e-5,
                       rope_theta=10000.0, tie_word_embeddings=False,
                       dtype=torch.bfloat16)


class _PrefillClock:
    """Wraps ``models.llama.llama_prefill`` for the generate phase: the
    host time of each prefill, synchronised at both ends, and whether its
    logits are finite (``_prefill_for_generate`` looks the name up at
    call time)."""

    def __init__(self, tl):
        self.tl, self.spans, self.finite = tl, [], []

    def __enter__(self):
        self.orig = orig = self.tl.llama_prefill

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.spans.append((t0, time.perf_counter()))
            self.finite.append(bool(torch.isfinite(logits).all()))
            return logits, cache

        self.tl.llama_prefill = timed
        return self

    def __exit__(self, *exc):
        self.tl.llama_prefill = self.orig


def generate_tinyllama(dev):
    """generate() on TinyLlama-1.1B at full width and depth: greedy and
    sampling (B=8, 1024-token prompts, 128 new tokens), beam search (B=2,
    4 beams, 32 new tokens), after a short warm-up of each. Prefill ms:
    host clock around the prefill, synchronised; decode ms per step: the
    rest of the call, ending in the copy of the tokens to the host, over
    the decode steps."""
    from paddle_tpu_torch.models import llama as tl
    phase(f"generate TinyLlama-1.1B (bf16, 22 layers, head_dim 64, random "
          f"weights): greedy and sampling B={GEN_B}, beam B={BEAM_B}x"
          f"{BEAM_K}")
    cfg = tinyllama_1_1b()
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    params = tl.init_llama_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights made on the card in {time.perf_counter() - t0:.2f} s, "
          f"{n_params / 1e9:.3f} B params, "
          f"{n_params * 2 / 1e9:.2f} GB")
    rng = np.random.RandomState(SEED)
    prompts = rng.randint(1, cfg.vocab_size, size=(GEN_B, GEN_S)).astype(
        np.int32)
    runs = {
        "greedy": (prompts, dict(max_new_tokens=GEN_NEW,
                                 decode_strategy="greedy_search")),
        "sampling": (prompts, dict(max_new_tokens=GEN_NEW,
                                   decode_strategy="sampling",
                                   temperature=0.8, top_k=50, top_p=0.9,
                                   seed=0)),
        "beam_search": (prompts[:BEAM_B],
                        dict(max_new_tokens=BEAM_NEW,
                             decode_strategy="beam_search",
                             num_beams=BEAM_K)),
    }
    # warm-up: cuBLAS handles, the allocator, the kernels' first loads
    for prompt, kw in runs.values():
        tl.generate(params, prompt, cfg, device=dev,
                    **dict(kw, max_new_tokens=3))
    out = {"config": "TinyLlama-1.1B", "params": n_params, "runs": {}}
    with _PrefillClock(tl) as clock:
        for name, (prompt, kw) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            n = len(clock.spans)
            t0 = time.perf_counter()
            toks = tl.generate(params, prompt, cfg, device=dev, **kw)
            t1 = time.perf_counter()
            launches = _counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            assert len(clock.spans) == n + 1 and clock.finite[-1], \
                "one prefill with finite logits"
            p0, p1 = clock.spans[-1]
            new, rows = kw["max_new_tokens"], prompt.shape[0]
            steps = new - 1
            decode_ms = (t1 - p1) * 1e3 / steps
            assert toks.shape == (rows, new) and toks.dtype == np.int32
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
            dec_rows = rows * (BEAM_K if name == "beam_search" else 1)
            assert launches["decode_attend_update_slab"] == L * steps, \
                launches
            assert launches["flash_fwd"] == L, launches
            assert launches["rms_norm"] == (2 * L + 1) * (steps + 1), \
                launches
            assert all(launches[k] == 0 for k in (
                "decode_attention_slab", "paged_attend_update", "flash_bwd",
                "gmm_fwd", "gmm_dx", "gmm_dw")), launches
            r = {"rows": rows, "decode_rows": dec_rows, "prompt": GEN_S,
                 "new_tokens": new, "decode_steps": steps,
                 "wall_ms": (t1 - t0) * 1e3, "prefill_ms": (p1 - p0) * 1e3,
                 "decode_ms_per_step": decode_ms,
                 "tokens_per_sec": rows * new / (t1 - t0),
                 "decode_rows_per_sec": dec_rows / (decode_ms / 1e3),
                 "peak_mem_gib": peak, "launches": launches,
                 "first_tokens": toks[:, :8].tolist()}
            out["runs"][name] = r
            print(f"{name}: {rows} x {new} tokens in {r['wall_ms']:.1f} ms, "
                  f"prefill {r['prefill_ms']:.2f} ms, decode "
                  f"{decode_ms:.3f} ms per step ({steps} steps, {dec_rows} "
                  f"rows), {r['tokens_per_sec']:.1f} tokens/s, peak mem "
                  f"{peak:.2f} GiB")
            print(f"  launches {launches} (decode_attend_update_slab {L} x "
                  f"{steps}, flash_fwd {L}, rms_norm {2 * L + 1} x "
                  f"{steps + 1})")
            print(f"  first tokens of each row {r['first_tokens']}")
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"].values())
                       for k in out["runs"]["greedy"]["launches"]}
    out["profile"] = profile_decode(params, cfg, prompts, dev)
    del params
    torch.cuda.empty_cache()
    return out


def token_loop_syncs(tl, dparams, cfg, cache, logits, tok, dev):
    """The token loops of greedy, sampling and beam search (three steps
    each, from the prefilled cache) under torch.cuda's sync debug mode,
    which warns on every call that waits for the card: none may. Returns
    the count."""
    import warnings
    pos = cache["pos"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    beam_cache = {"k": cache["k"][:, :BEAM_B], "v": cache["v"][:, :BEAM_B],
                  "pos": pos}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tl.generate_scan(dparams, dict(cache), tok, 3, cfg)
            tl.sample_scan(dparams, dict(cache), logits, 3, cfg, gen, 0.8,
                           50, 0.9)
            tl.beam_search_scan(dparams, beam_cache, logits[:BEAM_B], 3, cfg,
                                BEAM_K)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # each sync the mode catches warns "called a synchronizing CUDA
    # operation"; the mode's own notice that it is a prototype does not
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"token loops (greedy, sampling, beam; 3 steps each) under sync "
          f"debug mode: {len(syncs)} host syncs {syncs[:3]}")
    assert not syncs, syncs
    torch.cuda.synchronize()
    return len(syncs)


def profile_decode(params, cfg, prompts, dev):
    """Where one greedy decode step of the generate phase (8 rows at 1,024
    cached tokens, decode-prepared weights) spends device time: kernel
    time by class from torch.profiler, beside the step's host-clock wall
    time without the profiler, ending in the copy of its tokens.
    busy = device time / wall."""
    from paddle_tpu_torch.models import llama as tl
    from torch.profiler import ProfilerActivity, profile
    phase("profile one decode step (TinyLlama-1.1B, B=8, 1,024 cached)")
    dparams = tl.prepare_decode_params(params, cfg)
    cache = tl.init_kv_cache(cfg, GEN_B, SLAB_T, device=dev)
    logits, cache = tl.llama_prefill(dparams, cache,
                                     torch.from_numpy(prompts).to(dev), cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    syncs = token_loop_syncs(tl, dparams, cfg, cache, logits, tok, dev)

    def step():
        lg, _ = tl.llama_decode_step(dparams, dict(cache, pos=GEN_S), tok,
                                     cfg)
        return torch.argmax(lg, dim=-1).cpu()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    by_class, top = _device_ms_by_class(prof)
    device_ms = sum(by_class.values())
    wall_ms = float(np.median(walls))
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy": device_ms / wall_ms, "by_class_ms": by_class,
           "top": sorted(top, reverse=True)[:10],
           "token_loop_host_syncs": syncs}
    print(f"decode step: wall {wall_ms:.3f} ms (median of 5, no profiler), "
          f"device {device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}")
    print(f"  by class (ms): {by_class}")
    for ms, n, key in out["top"]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key}")
    del dparams, cache
    return out


def profile_ernie_step(params, opt, x, cfg):
    """profile_halves on one ERNIE step: loss and grads (routing stats and
    per-layer rows included), then AdamW masked to the routed experts."""
    from paddle_tpu_torch.models import ernie_moe as tm
    phase("profile one ERNIE-MoE train step")
    dev = params["embed"].device
    ids = torch.from_numpy(x[:, :-1]).to(dev)
    labels = torch.from_numpy(x[:, 1:]).to(dev)

    def grads():
        _, (_, rows), g = tm.moe_loss_and_grads(
            params, ids, labels, cfg, True, "ragged_a2a", True)
        return g, tm._expert_row_masks(params, rows)

    def update(gm):
        tm._adamw_update(params, gm[0], opt, 1e-4, masks=gm[1])

    return profile_halves(grads, update)


def profile_train_step(params, opt, x, cfg):
    """profile_halves on one Llama train step."""
    from paddle_tpu_torch.models import llama as tl
    phase("profile one train step")
    dev = params["embed"].device
    ids = torch.from_numpy(x[:, :-1]).to(dev)
    labels = torch.from_numpy(x[:, 1:]).to(dev)

    def grads():
        return tl.llama_loss_and_grads(params, ids, labels, cfg,
                                       tl.ParallelConfig())[1]

    return profile_halves(grads,
                          lambda g: tl._adamw_update(params, g, opt, 3e-4))


def profile_halves(grads, update):
    """Where one train step (``grads()``: loss and grads, then
    ``update(grads)``: AdamW) spends device time: each half under
    torch.profiler, kernel time by class, AdamW's kernels as one class of
    their own; beside the wall time of the same two halves unprofiled
    (the profiler slows the host, so busy is device time over the
    unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    wall = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = grads()
    torch.cuda.synchronize()
    wall["loss_and_grads"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    update(g)
    torch.cuda.synchronize()
    wall["adamw"] = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        g = grads()
        torch.cuda.synchronize()
    by_class, top = _device_ms_by_class(prof)
    with profile(activities=acts) as prof:
        update(g)
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
    if "spin_kernel" in name:        # torch.cuda._sleep
        return "warm-up"
    if "paged_update_kernel" in name:
        return "paged_attend_update"
    if "slab_kernel" in name:
        return "decode_attention"
    if "rms_norm_kernel" in name:
        return "rms_norm"
    if "varlen_fwd_kernel" in name:
        return "varlen_fwd"
    if "varlen_bwd_kernel" in name:
        return "varlen_bwd_dkv" if ", false>" in name else "varlen_bwd"
    if "varlen_dq_kernel" in name:
        return "varlen_bwd_dq"
    if "dq_cast_kernel" in name:      # the fused varlen backward's dQ cast
        return "varlen_bwd"
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_kernel" in name or "dq_finalize_kernel" in name:
        return "flash_bwd"
    if "gmm_fwd_kernel" in name or "gmm_dx_kernel" in name \
            or "gmm_dw_kernel" in name:
        return "gmm"
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


def times(dev, errs):
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
    out.update(gmm_times(dev))
    out.update(slab_times(dev))
    out.update(varlen_times(dev, errs))
    return out


def slab_times(dev):
    """Rows 10 and 11 at the generate phase's decode shape, pos 1023: B=8,
    NH=32 over NKV=4, HD=64, T=1152, bf16. Bytes: q, K and V columns
    0..pos and the f32 output once; the update adds new k/v read and the
    column written. Operations: 2 products of 2 HD per (head, token).
    Library yardstick: SDPA with GQA over the context pre-transposed to
    [B, NKV, pos+1, HD] (the column write outside its time)."""
    from paddle_tpu_torch.ops import decode_attention as da
    F = torch.nn.functional
    b, nh, nkv, hd, pos = GEN_B, 32, 4, 64, 1023
    kvd, ctx = nkv * hd, pos + 1
    q, nk, nv, kc, vc = _slab_inputs(dev, torch.bfloat16, b, nh, nkv, hd,
                                     SLAB_T, SEED)
    read = b * nh * hd * 2 + 2 * b * kvd * ctx * 2 + b * nh * hd * 4
    ops = 4 * b * nh * hd * ctx
    kx, vx = (c[1].reshape(b, nkv, hd, SLAB_T)[..., :ctx].transpose(2, 3)
              .contiguous() for c in (kc, vc))
    q4 = q[:, :, None, :]
    lib = _timed(lambda: F.scaled_dot_product_attention(
        q4, kx, vx, enable_gqa=True), 100)["ms"]
    out = {}
    for name, nbytes, kern, plain in (
            ("decode_attend_update_slab", read + 4 * b * kvd * 2,
             lambda: da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, pos),
             lambda: da.decode_attend_update_plain(q, nk, nv, kc, vc, 1,
                                                   pos)),
            ("decode_attention_slab", read,
             lambda: da.decode_attention_slab(q, kc, vc, 1, pos),
             lambda: da.decode_attention_plain(q, kc, vc, 1, pos))):
        r = dict(_timed(kern, 200), plain_ms=_timed(plain, 10)["ms"],
                 library_ms=lib, **_bound(nbytes, ops, BF16_OPS_PER_S),
                 bytes=nbytes, context_tokens=ctx)
        key = f"{name}[B=8,NH=32,NKV=4,HD=64,pos=1023]"
        out[key] = r
        print(f"{key} bf16: {r}")
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


def _library_gmm(kind, a, b, offsets, counts):
    """One PyTorch call for the same grouped product, the yardstick the
    port never calls: ``torch._grouped_mm`` with the groups' end offsets
    (forward [M, K] x [E, K, N]; dX against rhs transposed; dW grouped
    over the contraction); where it refuses, a loop of one
    ``torch.matmul`` per expert. Returns (what was timed, the callable,
    the refusal met, if any)."""
    ends = offsets[1:].contiguous()
    errors = []
    if hasattr(torch, "_grouped_mm"):
        desc, fn = {
            "fwd": ("torch._grouped_mm(lhs, rhs, offs)",
                    lambda: torch._grouped_mm(a, b, offs=ends)),
            "dx": ("torch._grouped_mm(dout, rhs^T, offs)",
                   lambda: torch._grouped_mm(a, b.transpose(1, 2),
                                             offs=ends)),
            "dw": ("torch._grouped_mm(lhs^T, dout, offs)",
                   lambda: torch._grouped_mm(a.t(), b, offs=ends))}[kind]
        try:
            fn()
            torch.cuda.synchronize()
            return desc, fn, errors
        except RuntimeError as e:   # a refused layout: recorded, then the loop
            errors.append(f"{desc}: {type(e).__name__}: {str(e)[:300]}")
    else:
        errors.append("torch._grouped_mm: not in this torch")
    starts = offsets[:-1].tolist()
    sizes = counts.tolist()
    groups = [(e, o, c) for e, (o, c) in enumerate(zip(starts, sizes)) if c]
    if kind == "fwd":
        def loop():
            return [a[o:o + c] @ b[e] for e, o, c in groups]
    elif kind == "dx":
        def loop():
            return [a[o:o + c] @ b[e].T for e, o, c in groups]
    else:
        def loop():
            return [a[o:o + c].T @ b[o:o + c] for e, o, c in groups]
    return "one torch.matmul per expert", loop, errors


def gmm_times(dev):
    """The three grouped-matmul kernels at the ERNIE phase's shapes: one
    MoE layer's schedule (4096 tokens, top-4 of 32 experts, 128-row
    tiles), bf16, (K, N) of e_w1 and of e_w2. Work counted for this
    run's data: each routed row is read once, the rhs of each expert that
    has rows once, the output written once (all rows for the forward and
    dX, every expert for dW); 2 K N operations per routed row."""
    from paddle_tpu_torch.ops import grouped_matmul as tg
    counts, n_rows, sched = _slice_schedule(dev)
    offsets = tg.tile_schedule(counts, n_rows // 128, 128)[4]
    e = counts.shape[0]
    routed = int(counts.sum())
    active = int((counts > 0).sum())
    sched_bytes = 2 * (n_rows // 128) * 4
    out = {}
    for k, n in MOE_SHAPES:
        lhs, rhs, dout = _gmm_operands(dev, torch.bfloat16, n_rows, e, k, n,
                                       SEED)
        ops = 2 * routed * k * n
        calls = {
            "gmm_fwd": (lambda: tg.gmm_fwd(lhs, rhs, sched),
                        lambda: tg.gmm_fwd_plain(lhs, rhs, sched),
                        ("fwd", lhs, rhs),
                        2 * (routed * k + active * k * n + n_rows * n)),
            "gmm_dx": (lambda: tg.gmm_dx(dout, rhs, sched),
                       lambda: tg.gmm_dx_plain(dout, rhs, sched),
                       ("dx", dout, rhs),
                       2 * (routed * n + active * k * n + n_rows * k)),
            "gmm_dw": (lambda: tg.gmm_dw(lhs, dout, sched, num_experts=e),
                       lambda: tg.gmm_dw_plain(lhs, dout, sched,
                                               num_experts=e),
                       ("dw", lhs, dout),
                       2 * (routed * (k + n) + e * k * n)),
        }
        for name, (kern, plain, lib, nbytes) in calls.items():
            desc, lib_fn, refused = _library_gmm(*lib, offsets, counts)
            r = dict(_timed(kern, 50),
                     plain_ms=_timed(plain, 3)["ms"],
                     library_ms=_timed(lib_fn, 50)["ms"], library=desc,
                     library_refusals=refused,
                     **_bound(nbytes + sched_bytes, ops, BF16_OPS_PER_S),
                     bytes=nbytes + sched_bytes, operations=ops,
                     routed_rows=routed, rows=n_rows)
            key = f"{name}[K={k},N={n}]"
            out[key] = r
            print(f"{key} bf16, {routed} routed of {n_rows} rows: {r}")
        del lhs, rhs, dout
        torch.cuda.empty_cache()
    return out


def main():
    t_start = time.perf_counter()
    smi = probe()
    dev = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)
    build_s = build()
    errs = check_kernels(dev)
    check_flash(dev, errs)
    check_gmm(dev, errs)
    check_tiny_streams(dev)
    check_tiny_train(dev)
    check_tiny_ernie(dev)
    check_decode(dev, errs)
    check_tiny_generate(dev)
    check_varlen(dev, errs)
    serve = serve_7b(dev)
    train = train_7b(dev)
    ernie = train_ernie(dev)
    gen = generate_tinyllama(dev)
    varlen = varlen_phase(dev)
    tm = times(dev, errs)
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
    gmm_sites = {"gmm_fwd": 182, "gmm_dx": 215, "gmm_dw": 260}
    k1, n1 = MOE_SHAPES[0]
    for name, line in gmm_sites.items():
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
             "replaces": f"paddle_tpu/ops/grouped_matmul.py:{line}",
             "launches": ernie["launches"][name],
             "max_abs_err": errs[name],
             **{k: tm[f"{name}[K={k1},N={n1}]"][k] for k in cols}})
    for name, line in (("decode_attend_update_slab", 438),
                       ("decode_attention_slab", 500)):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "paddle_tpu_torch/csrc/decode_attention.cu",
             "replaces": f"paddle_tpu/ops/decode_attention.py:{line}",
             "launches": gen["launches"][name],
             "max_abs_err": errs[name],
             **{k: tm[f"{name}[B=8,NH=32,NKV=4,HD=64,pos=1023]"][k]
                for k in cols}})
    for name, line, pack in (("varlen_fwd", 675, "short"),
                             ("varlen_bwd", 740, "short"),
                             ("varlen_bwd_dkv", 866, "long"),
                             ("varlen_bwd_dq", 935, "long")):
        t = sum(VARLEN_SHORT if pack == "short" else VARLEN_LONG)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_varlen.cu",
             "replaces": f"paddle_tpu/ops/flash_varlen.py:{line}",
             "launches": varlen["launches"][name],
             "max_abs_err": errs[name],
             **{k: tm[f"{name}[{pack} pack,T={t},H={VARLEN_H},"
                      f"D={VARLEN_D},causal]"][k] for k in cols}})
    assert all(kk["launches"] > 0 for kk in kernels[-4:]), kernels
    wall_s = time.perf_counter() - t_start
    record = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "max_abs_err": errs, "serve": serve, "train": train,
              "ernie": ernie, "generate": gen, "varlen": varlen,
              "times": tm,
              "wall_s": wall_s}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    phase("result")
    print(f"chip_smoke wall seconds {wall_s:.1f} (builds included)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
