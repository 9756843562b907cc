"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. probe   - versions, the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel source of the serving, training,
               generation and varlen paths, all at once, for sm_90a, and
               prints the int8 walks' occupancy;
  3. check   - each kernel against its plain PyTorch version at the
               serving and training paths' shapes, in bf16 (and f32 flash
               and grouped-matmul cases on small adversarial layouts),
               with the tolerance stated; RMSNorm (row 1) at rows 1 to
               8,192 of widths 1024 to 5120 in bf16 and f32, an odd eps
               and a row of zeros, bf16 also to its rounding schedule,
               the same bits twice; the speculative verify read
               (row 6 at the kernel's split: bf16 at llama_7b's attention
               shape, f32 GQA with T = 1..8 and a score spread, a padding
               row exact over poisoned outputs, the same bits over three
               calls, the rounding schedule at rows of 2-4 blocks); the
               int8 kernels (rows 5 and 4 at llama_7b's attention shape
               with bf16 q and on f32 GQA cases with a score spread, row
               5's written bytes and scales bitwise; row 7 as row 6); the
               commit (rows 8 and 9 at L = 32 and at block sizes 16 to
               1024 in f32, bf16 and int8, commit lengths 0, 1, T and
               mixed: bitwise but the null block, block 0 untouched, the
               same bits twice); rows 3, 5, 6, 7, 8 and 9 also at a
               rank's shape under mp 2 (NH = NKV = 16, KVD 2048); then a
               tiny fp32
               Llama served on the card through
               the kernels must give the same greedy streams as the same
               engine on the CPU through the plain versions, with
               speculation on too (and equal to the non-speculative
               streams), with bf16 and with int8 KV pools, and three
               tiny fp32 Llama and three tiny fp32
               ERNIE-MoE train steps on the card must give the CPU's
               losses, on the split stack (dropless) and under capacity
               dispatch on two non-split stacks (every layer MoE, and
               five layers at moe_every 2); the slab decode kernels (attend+update and
               attend-only) at the generate phase's shape and on small f32
               cases with an adversarial score spread; tiny fp32 Llamas at
               head_dim 64 (slab cache) and 128 (head-major cache) must
               give the CPU's greedy and beam streams through generation;
               the varlen kernels (forward, fused backward, split dK/dV
               and dQ) at the short pack in bf16, on small bf16
               layouts (segments straddling 128-row tiles, an empty k
               segment, a segment off the 64-key grid, where causal o
               is also held to 2^-12 rel frob of the plain version: its
               rounding schedule) and on small f32
               layouts (single-token and empty segments, tile edges, a
               padded tail, cross-attention with an empty k segment,
               whose rows must get exactly 0) with a score spread of
               hundreds of log2 units, fused against split (the bf16
               fused dK and dV bitwise equal to the split pair's), the
               split outputs and fused dK/dV bitwise over two runs,
               segment isolation, and GQA 32/4 at
               head_dim 64 against the CPU; rows 3 and 2 (the paged
               decode walk, split across CTAs) against their plain
               versions at the kernel's split, the same bits over
               repeated calls, and row 3 at rows of 2-4 blocks also to
               2^-12 rel frob (its rounding schedule); read-only paged
               attention (row 2) at row 3's shape and on f32 GQA cases
               with a length-0 row; the split backward (rows 17, 18) in
               bf16 at the train shape and at Sq != Sk with a kv tail off
               the 128-key stages, and on f32 layouts (a ragged length, Sq
               != Sk causal and not, a score spread), its dK/dV bitwise
               row 16's and its dQ bitwise over two runs, and row 18's dQ
               drift along f64 products at S = 16384 within 2e-6 of the
               plain version's; the block entries
               (a ring of four causal blocks merged by log-sum-exp, the
               per-block backward under global lse/delta) against one
               full call under both backward modes; and the tiny train
               again with PADDLE_TPU_TORCH_FLASH_BWD=split;
  4. serve   - InferenceEngine on llama_7b (bf16, full width and depth,
               seeded random weights): 16 requests, prompts of 128-1024
               tokens, 64 new tokens each, Poisson arrivals; prints
               tokens/s, TTFT, TPOT, the mean decode step and each
               kernel's launches, all counted from this phase alone;
               then torch.profiler splits one decode step and one prefill
               chunk into kernel classes beside their wall time;
  4a. serve-int8 - the same weights and trace with kv_dtype="int8"
               (row 5 in every decode layer): the same numbers, the KV
               pools' bytes against bf16's, how many streams equal the
               serve phase's, and the same profile;
  4c. serve-ops - on the serve phase's weights, each a run of
               InferenceEngine with the kernel counts read from it alone:
               dead columns (NaN-filled pools, int8: NaN scale pools,
               against zero pools: streams bitwise), quarantine (a NaN
               embedding row: the poisoned request fails, 7 others finish
               on its reused blocks), bench.py's prefix-cache trace (off
               and on, wall and deterministic: hits, TTFT, tokens/s, no
               decode write into a shared block), bench.py's overload
               burst (deterministic twice, identical; a wall run at twice
               the drain rate: goodput, shed rate), crash and recover
               (killed at the 3rd decode, recovered from the journal), a
               live weight swap (streams bitwise) and telemetry (the
               metrics snapshot's keys, a trace per request, the
               Prometheus head); before them the kernel checks hold rows
               2-7 over NaN dead columns to their zero-dead outputs;
  4b. serve-spec - InferenceEngine with speculation on llama_7b (bf16,
               32 layers, seeded random weights, o_proj and down_proj
               scaled by 0.05, default 1-layer draft, draft_k 4): first
               one verify step's logits against 5 sequential decode
               steps (bf16, f32, and f32 over int8 pools); then bench.py's
               speculative trace (24 requests of a 512-token shared
               prefix plus a 16-95 token tail, 32 new tokens, Poisson
               12/s), speculation off and on, in deterministic and in
               wall mode, then (serve-spec-int8) speculation on with
               kv_dtype="int8" (rows 7 and 9; the draft keeps bf16 pools
               and row 3); prints accept rate, tokens per iteration,
               tokens/s, TTFT, TPOT, verify and draft step ms, peak
               memory, stream identity, launches per run, and a
               torch.profiler split of one verify step in each KV dtype;
               last, serve-spec + cache: the trace with speculation and
               the prefix cache on (hits, no commit into a shared block,
               tokens/s and accept rate against the cache-off run);
  4d. serve-13b - InferenceEngine on llama_13b at full width and depth
               (bf16, 40 layers, 40 heads, seeded random weights) with the
               serve phase's ServeConfig and its first 8 requests:
               tokens/s, TTFT, decode step ms, peak memory, the launches
               of rows 1 and 3 asserted, every request finished with its
               64 tokens and none quarantined, the pool leak-free;
  4e. serve-tp - InferenceEngine with ServeConfig(mp=2) over 2 ranks
               (spawned processes sharing cuda:0 through gloo): first the
               tiny Llama of check_tiny_spec_streams through rows 1, 3
               and 5-9 at the rank's heads, plain, int8 with the prefix
               cache, and speculative over bf16 and int8 pools, streams
               token-identical to mp 1 on the card; then llama_7b (bf16,
               seeded weights made once and handed to the ranks as CUDA
               handles): one teacher-forced decode step at 32 layers held
               to the mp 1 step's logits within SERVE_TP_LOGIT_REL (rel
               frob), two faulty controls (a rank's o_proj reduce
               dropped, a rank's k_proj holding the other's heads) shown
               to fail it, one decode step's and one prefill chunk's
               collective calls and bytes equal to their reckoning, and
               the serve trace's first 4 requests at 16 layers in wall
               mode, bf16 and int8 with the prefix cache and speculation:
               streams and events equal on both ranks, pool bytes a rank
               half of mp 1's, every request finished, launches asserted;
               tokens/s, TTFT, step ms, peak memory a rank, and each
               request's first divergence from mp 1 (reported);
  5. train   - build_train_step on llama_7b's width cut to 16 layers
               (bf16, B=4, S=2048, full remat, AdamW with f32 moments,
               seeded random weights and ids): one warm-up and three timed
               steps; prints step ms, tokens/s, MFU, every loss, peak
               memory and each kernel's launches counted from this phase
               alone; then torch.profiler splits one step into matmul,
               flash, RMSNorm, optimizer and other device time beside
               its wall time;
  5c. train-policies - the train phase's configuration under each remat
               policy (dots, save_attn, save_mlp, offload_attn) and with
               use_flash=False beside full: loss and gradients on batch 0
               held to full's (the loss bitwise for a policy), one warm-up
               and two timed steps each (step ms, tokens/s, MFU, peak
               memory, the launches of rows 1, 14 and 16 asserted, the
               bytes offload_attn sends to the host), one table;
  5d. chunked-ce - chunked_ce_loss against the dense f32 loss at the train
               shape (B=4, S=2048, H=4096, V=32000, bf16): loss, gradient
               differences, fwd+bwd ms and peak memory of each;
  5e. train-13b - build_train_step on llama_13b's width cut to 12 of 40
               layers (B=4, S=2048, save_mlp): one warm-up and two timed
               steps, launches asserted;
  5a. train-long - build_train_step on the same 16-layer cut at S=16384
               (B=1, rope_theta 1e6: Code Llama's long-context setting),
               one warm-up and two timed steps under
               PADDLE_TPU_TORCH_FLASH_BWD=auto, then under split; each
               step's flash launches asserted; prints step ms, tokens/s,
               MFU, every loss, peak memory, dense_bwd_schedule_stats
               (the JAX path each mode stands for) and a profile split;
  5b. attn-long - bench.py's long_seq_flash_fwd shapes (BH 8 at S=16384
               and 32768, BH 4 at S=131072; D=128, causal, bf16):
               the kernels held to the plain versions on every element,
               then fwd+bwd of sum(o^2) through the differentiable entry
               under auto and split: ms, TFLOP/s, peak memory, launches,
               dense_bwd_schedule_stats, and no host sync in a step;
  6. ernie   - build_train_step on ernie_moe_fine at full width and depth
               (bf16, B=8, S=512, dropless at ep=1, AdamW with bf16
               moments for the routed experts only, seeded random weights
               and ids): one warm-up and ten timed steps; prints step ms,
               tokens/s, active-parameter MFU, every loss, the routing
               stats, peak memory and each kernel's launches counted from
               this phase alone; then the same profiler split with the
               grouped matmuls as a class of their own;
  6a. ernie-capacity - bench.py bench_moe's ERNIE-MoE (vocab 8192, H 1024,
               I 4096, 8 layers, E 8 top-2, capacity_factor 1.25, bf16; B=8,
               S=512) under the capacity slot schedule and under
               bench_moe_dropless's flags: step ms, tokens/s, active MFU,
               drops and capacity use, launches;
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
  8a. resume - build_train_step on llama_7b's width cut to 2 layers
               (bf16, B=4, S=2048, full remat, 6.67 GB of state) under
               PADDLE_TPU_TORCH_FLASH_BWD=split: 6 uninterrupted steps;
               the same seed through CheckpointManager(keep=2,
               interval=2), SIGTERM after step 5 (final synchronous
               save, Preempted(5)); a restore into a state of another
               seed (every leaf's checksum the manifest's, step 6's loss
               bitwise); a fault at ckpt.commit.before_marker on a later
               save (latest() stays on 5, the restore from it bitwise
               again); bench.py bench_preempt_resume's readings (async
               and blocking save overheads, resume_to_parity_ms) with the
               snapshot ms, GB, write, verify and restore seconds and the
               peak host RSS; a tiny fp32 checkpoint from CUDA tensors
               into a CPU template and back, bitwise; launches of rows 1,
               14, 17 and 18 asserted;
  8b. fleet  - bench.py bench_serve_fleet's trace (24 requests, a
               512-token system prompt, 32 new tokens, deterministic) on
               llama_7b (bf16, 32 layers): a lone engine, then a
               FleetRouter of 2 replicas under affinity and random
               dispatch (streams bitwise the lone engine's), a replica
               killed mid-burst with journals on (nothing lost, every
               stream not migrated bitwise, journaled tokens kept), a
               rolling swap from a CheckpointManager root of the same
               weights (2 swaps, no drops, streams bitwise); tokens/s,
               hit rates, swap ms, save seconds; launches of rows 1 and
               3 asserted. Both phases write under tempfile.mkdtemp(),
               check the free disk first and remove their files;
  8c. train-dp - build_train_step at llama_7b's width (bf16, B=4,
               S=2048, full remat, AdamW f32 moments, the train phase's
               seed and batches) over W ranks, spawned processes sharing
               cuda:0 through gloo (which stages CUDA tensors through the
               host: correctness and memory, not collective speed): dp 2,
               sharding 2 at ZeRO stages 1 and 2 (4 layers, 2 steps),
               stage 3 (4 layers, 1 step), dp 2 x sharding 2 at stage
               3 (W=4, 4 layers, 2 steps); tensor parallelism at 4
               layers, 2 steps: mp 2, mp 2 with the fused FFN ring
               (PADDLE_TPU_TORCH_TP_OVERLAP=1 in the ranks, its plan
               counter asserted), dp 2 x mp 2 and mp 2 x sharding 2 at
               stage 3 (W=4); every rank the same loss at every step,
               the dp replicas' params and every rank's norms bitwise
               equal (a checksum a leaf), the losses held to the single process's
               (DP_STEP0_RTOL, DP_LATER_RTOL) and stages 1, 2, 3 to each
               other, each rank's part of every param leaf to the single
               process's params (DP_PARAM_REL, the relative Frobenius
               error of the worst leaf; the parent's references reach the
               ranks as CUDA handles), three faulty single-process
               controls (step 1 skipped, step 1 on half the batch, step 0
               skipped) shown to fail that limit, each rank's launches of
               rows 1, 14 and 16 the train phase's a step, its collective
               bytes a step equal to their reckoning; prints peak memory
               beside the state reckoning and step ms; elastic resume:
               mp 2 (W=2) saves its state after its first step with a
               CheckpointManager and mp 2 x sharding 2 at stage 3 (W=4)
               restores it (restore_train_step) and takes the second
               step, held to the single process's step-1 loss and 2-step
               params, each rank's restored shards bitwise its slices of
               the saved leaves; prints the save's blocking and total
               and the restore's verify and load seconds with the card;
  9. times   - each kernel timed with CUDA events beside its bound, its
               plain version and one PyTorch library call (a yardstick
               the port never calls); row 1 beside the launch floor (an
               empty kernel timed the same way); rows 8 and 9 with every
               column accepted and with one (the serve-spec step's), a
               sector bound beside the byte bound; each varlen kernel
               is also held to its plain version at the pack it is
               timed at (both
               packs for rows 20 and 21, the long pack for the split
               pair), and rows 20-23 to VARLEN_DRIFT_EXCESS along f64
               products (the long pack, and row 20 on one 65,536-token
               segment); rows 17 and 18 at
               the train and train-long shapes, rows 14 and 16 at the
               shapes where JAX takes rows 13 and 15, row 2 at row 3's
               (rows 2 and 3 also by the profiler's kernel time), rows 6
               and 7 also at the profiled verify step's even rows and by
               the profiler's kernel time; rows 3 and 5-9 also at a
               rank's shape under mp 2 (tp_rank_times);
 10. a JSON line {"kernels": [...]} (rows 3 and 5-9 with an "mp2_rank"
     entry: their times at a rank's shape and their launches in
     serve-tp's ranks), the total wall seconds, and, last,
     {"ok": true, "device": ...}.

Needs one CUDA device; writes its numbers to chiprun_out/chip_smoke.json.
Imports nothing of JAX and nothing of paddle_tpu.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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


_T0 = time.perf_counter()


_PHASES = []    # (phase header, its start in seconds): the record's timeline


def phase(name):
    """A phase's header, with the script's seconds so far."""
    at = time.perf_counter() - _T0
    _PHASES.append((name, round(at, 1)))
    print(f"\n== {name} == (at {at:.1f} s)", flush=True)


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


def ptxas_lines(log):
    """ptxas's registers, spills and notes on wgmma serialisation in a
    build log, each as "kernel: line\"."""
    out, kern = [], ""
    for line in log.splitlines():
        m = re.search(r"entry function '_ZN\w*\d([a-z][a-z0-9_]*?_kernel)"
                      r"(I\w*?)?Ev?(P|\d|N)", line)
        if m:    # the kernel's name and its mangled template arguments
            kern = m.group(1) + (m.group(2) or "")
        if "registers" in line or "spill" in line or "wgmma" in line:
            out.append(f"{kern}: {line.strip()}")
    return out


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
        for line in ptxas_lines(log):
            print(f"  {name}: {line}")
    print(f"build seconds {secs:.2f}")
    # each nvcc's wall seconds, longest first: the first is the critical
    # path (csrc/paged_attention.cu builds in parts, then one link)
    print("nvcc seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(_build.BUILD_SECONDS.items(),
                                          key=lambda kv: -kv[1])))
    # the int8 split walks' shared memory (8 K row groups of partial
    # scores, a 16 KiB slice a piece) and registers bound how many CTAs
    # share an SM
    occ = _build.kernel("paged_attention", "paged_quant_occupancy",
                        [ctypes.c_int] * 4)
    for kind, what, rows in ((0, "int8 decode (rows 5, 4: "
                              "paged_split_kernel<signed char>), REP",
                              (1, 2, 4, 8)),
                             (1, "int8 verify (row 7: "
                              "paged_verify_split_kernel<signed char>), "
                              "chunk rows", (2, 4, 5, 8))):
        print(f"occupancy at HD=128 bs=128, {what} "
              f"{'/'.join(map(str, rows))}: "
              f"{[occ(kind, r, 128, 128) for r in rows]} CTAs/SM")
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
# the serve phase's profiled decode step (profile_steps): 8 rows at 1,000
# cached tokens, a batch of even rows
PAGED_STEP_POSITIONS = [1000] * 8
# Rows 3 and 2 split a row's blocks across CTAs; each split must round P
# against the running max of one walk over all the blocks before it (the
# plain version's ``splits`` form). A split that rounded against its own
# max moves o by 8.8e-4 to 1.2e-3 rel frob at rows of 2-4 blocks
# (PAGED_SCHEDULE_POSITIONS; a CPU run of the plain versions), under
# PAGED_ATOL in every element, so o is also held to this
PAGED_SCHEDULE_FROB = 2 ** -12
PAGED_SCHEDULE_POSITIONS = [200, 255, 300, 383, 140, 129, 511, 250]


# Row 1 on the grid of rows N x widths H the port runs (a decode step and
# its single row, a prefill chunk, a train step; ERNIE, TinyLlama, Llama and
# llama_13b) in both dtypes, eps 1e-5 (the Llama configs'); then ERNIE's
# train step at its eps, an odd eps (0.37, past the rows' mean square so a
# dropped eps shows) and a row of zeros (out exactly 0: a dropped eps makes
# NaN). bf16 within RMS_TOL, f32 within RMS_TOL_F32 (the card tests'), the
# output memory poisoned with NaN first, the same bits on a second call.
# bf16 also to RMS_SCHEDULE_FROB rel frob: the kernel and the plain
# version round once, after x * inv * w in f32, and differ only where an
# f32 sum in another order moves inv by an ulp or two (under 5e-5 rel frob
# at these shapes, a CPU run of the plain version with inv moved by 1 and
# 3 ulps); w applied after the cast rounds twice (2.7e-3 to 2.8e-3) and a
# mean over H - 1 moves every row (7e-4 to 1.7e-3), both inside RMS_TOL's
# one rounding step
RMS_ROWS = (1, 8, 256, 8192)
RMS_WIDTHS = (1024, 2048, 4096, 5120)
RMS_TOL_F32 = dict(rtol=1e-6, atol=1e-6)
RMS_SCHEDULE_FROB = 2 ** -12
RMS_ODD_EPS = 0.37


def _rms_case(rn, n, h, eps, dtype, g, dev, zero_row=False):
    """Row 1 at one shape against its plain version under the rules
    above; returns (max_abs_err, a line to print)."""
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    if zero_row:
        x[n // 2] = 0
    w = (1 + 0.1 * torch.randn((h,), generator=g, device=dev)).to(dtype)
    outs = []
    for _ in range(2):
        keep = torch.full((n, h), float("nan"), device=dev, dtype=dtype)
        del keep
        outs.append(rn.fused_rms_norm(x, w, eps))
    ref = rn.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    got = outs[0]
    err = (got.float() - ref.float()).abs().max().item()
    tol = RMS_TOL if dtype == torch.bfloat16 else RMS_TOL_F32
    torch.testing.assert_close(got, ref, **tol)
    fro = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
    assert dtype != torch.bfloat16 or fro <= RMS_SCHEDULE_FROB, (
        f"rms_norm [{n},{h}] bf16: rel frob {fro:.3e} over 2^-12")
    same = torch.equal(outs[0], outs[1])
    assert same, f"rms_norm [{n},{h}] {dtype}: two calls differ"
    zero_ok = not zero_row or bool((got[n // 2] == 0).all())
    assert zero_ok, f"rms_norm [{n},{h}]: the row of zeros is not 0"
    frob_tol = ", frob 2^-12" if dtype == torch.bfloat16 else ""
    return err, (f"rms_norm [{n},{h}] {str(dtype)[6:]} eps {eps:g}"
                 f"{' zero row' if zero_row else ''} max_abs_err {err:.3e} "
                 f"rel frob {fro:.3e} (tol rtol {tol['rtol']:g}, atol "
                 f"{tol['atol']:g}{frob_tol}); the same bits twice {same}")


def check_rms(dev, errs):
    """Row 1 against its plain version (the cases above)."""
    from paddle_tpu_torch.ops import rms_norm as rn
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(n, h, 1e-5, dtype, False) for dtype in (torch.bfloat16,
                                                       torch.float32)
             for h in RMS_WIDTHS for n in RMS_ROWS]
    cases += [(MOE_B * MOE_S, 1024, 1e-6, torch.bfloat16, False),
              (256, 4096, RMS_ODD_EPS, torch.bfloat16, False),
              (8, 5120, RMS_ODD_EPS, torch.float32, False),
              (8, 4096, 1e-5, torch.bfloat16, True),
              (256, 1024, 1e-6, torch.float32, True)]
    for n, h, eps, dtype, zero_row in cases:
        err, line = _rms_case(rn, n, h, eps, dtype, g, dev, zero_row)
        print(line)
        errs["rms_norm"] = max(errs.get("rms_norm", 0.0), err)


def check_kernels(dev):
    phase("check kernels against their plain versions (bf16)")
    errs = {}
    check_rms(dev, errs)
    check_paged_update(dev, errs)
    return errs


def check_paged_update(dev, errs):
    """Row 3 against its plain version at the kernel's split
    (``kernel_splits``): within PAGED_ATOL and, at rows of 2-4 blocks,
    PAGED_SCHEDULE_FROB; the same bits over three calls; the pools, new
    columns included, bitwise the plain version's."""
    from paddle_tpu_torch.ops import paged_attention as pa
    for nh, nkv, positions in ((32, 32, PAGED_POSITIONS),
                               (32, 8, PAGED_POSITIONS),
                               (40, 40, PAGED_POSITIONS),   # llama_13b
                               (16, 16, PAGED_POSITIONS),   # mp 2's rank
                               (32, 32, PAGED_SCHEDULE_POSITIONS)):
        a = _paged_inputs(nh, nkv, positions, SEED + nkv, dev)
        kp2, vp2 = a["k_pool"].clone(), a["v_pool"].clone()
        args = (a["q"], a["new_k"], a["new_v"])
        call = args + (a["k_pool"], a["v_pool"], a["tables"],
                       a["positions"], a["layer"])
        splits = pa.kernel_splits(a["tables"].shape[1], 128)
        got = pa.paged_attend_update(*call)
        ref = pa.paged_attend_update_plain(*args, kp2, vp2, a["tables"],
                                           a["positions"], a["layer"],
                                           splits=splits)
        # the same column written again: the pools do not move, and the
        # splits' ordered combine gives the same bits
        again = [pa.paged_attend_update(*call) for _ in range(2)]
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        fro = ((got - ref).norm() / ref.norm()).item()
        assert torch.isfinite(got).all(), "paged_attend_update: non-finite"
        assert err <= PAGED_ATOL, f"paged_attend_update err {err}"
        assert fro <= PAGED_SCHEDULE_FROB, f"paged_attend_update frob {fro}"
        assert all(torch.equal(got, x) for x in again), \
            "paged_attend_update: bits differ between calls"
        # the pools, new columns included, are bitwise the plain version's
        assert torch.equal(a["k_pool"], kp2) and torch.equal(a["v_pool"], vp2)
        pos = a["positions"].long()
        blk = a["tables"][torch.arange(len(pos), device=dev), pos // 128]
        col = a["k_pool"][a["layer"], blk.long(), :, pos % 128]
        assert torch.equal(col, a["new_k"]), "new k column not written"
        print(f"paged_attend_update NH={nh} NKV={nkv} HD=128 bs=128 B=8 "
              f"positions {positions} ({splits} splits): max_abs_err "
              f"{err:.3e} (tol {PAGED_ATOL}), rel frob {fro:.3e} (tol "
              f"2^-12), the same bits over three calls, pools bitwise "
              f"equal")
        errs["paged_attend_update"] = max(
            errs.get("paged_attend_update", 0.0), err)


def _verify_inputs(nh, nkv, qstart, T, seed, dev, dtype=torch.bfloat16,
                   hd=128, bs=128, layers=2, spread=None, max_nb=None):
    """A verify batch over fragmented random tables that hold each row's
    qstart cached tokens and its T fed positions (qstart 0: a padding row
    on the null table). ``spread`` scales each row's second block of keys
    in the last layer, so its scores lead the first block's by hundreds
    of log2 units; then q lies on a 2^-5 grid and the keys on a 2^-4 grid
    (integers in the scaled block), so every score is a sum that f32
    holds exactly in any order. Scores of magnitude ~800 summed in two
    orders differ by ~1e-4, which near-tied keys turn into output errors
    of ~5e-5, over the f32 limit; exact scores leave the check to the
    mask, the softmax and P.V. Also the fed columns new_k/new_v
    [layers, B, T, KVD]. Tables are ``max_nb`` wide (default: one past the
    longest row's blocks)."""
    from paddle_tpu_torch.ops.paged_attention import LOG2E
    g = torch.Generator(device=dev).manual_seed(seed)
    b, kvd = len(qstart), nkv * hd
    need = [-(-(q + T) // bs) if q else 0 for q in qstart]
    n_pool = 1 + sum(need)
    perm = (torch.randperm(n_pool - 1, generator=g, device=dev) + 1).tolist()
    tables = torch.zeros((b, max_nb or max(need) + 1), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k_pool, v_pool = randn(layers, n_pool, kvd, bs), randn(layers, n_pool,
                                                           kvd, bs)
    q = (torch.randn((b, T, nh, hd), generator=g, device=dev)
         * (LOG2E / math.sqrt(hd))).to(dtype)
    if spread is not None:
        k_pool = torch.round(k_pool * 16) / 16
        for i, n in enumerate(need):
            if n > 1:
                blk = int(tables[i, 1])
                k_pool[-1, blk] = torch.round(k_pool[-1, blk] * spread)
        q = torch.round(q * 32) / 32
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables.to(dev),
                qstart=torch.tensor(qstart, dtype=torch.int32, device=dev),
                new_k=randn(layers, b, T, kvd), new_v=randn(layers, b, T, kvd),
                layer=layers - 1)


# row 6 cases: bf16 at llama_7b's attention shape (draft_k 4: T = 5), then
# f32 GQA cases over T = 1..8 with a score spread; every case has a
# padding row (qstart 0). Held at the kernel's split (``kernel_splits``) to
# flash_close on acc / l (FLASH_TOL's forward entry: f32 rel 1e-5, frob
# 1e-5; bf16 rel 2^-6, frob 2^-10, P rounded to bf16 in both) and m +
# log2(l) to 1e-4 + 1e-6 |ref| (f32) or 1e-3 + 1e-5 |ref| (bf16); the
# padding row exactly acc = 0, l = 0, m = -1e30 (the outputs' memory
# poisoned with NaN first); the same bits over three calls. At rows of 2-4
# blocks (VERIFY_SCHEDULE_QSTART) acc / l also to PAGED_SCHEDULE_FROB, as
# row 3: a split that rounds P against its own max moves it by more.
VERIFY_QSTART = [1, 127, 128, 129, 3000, 0, 1500, 4000]
VERIFY_SCHEDULE_QSTART = [p + 1 for p in PAGED_SCHEDULE_POSITIONS]
VERIFY_SPREAD = 150.0   # the spread block's scores lead by hundreds
VERIFY_CASES = [(32, 32, 5, torch.bfloat16, None),
                (16, 16, 5, torch.bfloat16, None),      # a rank at mp 2
                (8, 4, 1, torch.float32, VERIFY_SPREAD),
                (8, 4, 4, torch.float32, VERIFY_SPREAD),
                (16, 4, 6, torch.float32, VERIFY_SPREAD),
                (32, 4, 8, torch.float32, VERIFY_SPREAD),
                (32, 4, 3, torch.float32, VERIFY_SPREAD)]
COMMIT_LEN = [0, 5, 3, 5, 1, 4, 2, 5]


def verify_held(name, kern, plain, q, qstart, f32, rel, frob, sched=False):
    """Row 6 or 7 (``kern()``) against its plain version at the kernel's
    split (``plain()``): the rules above, the rounding schedule's frob too
    where ``sched``. Returns (max_abs_err of acc / l, a line to print)."""
    B, T, NH, HD = q.shape
    outs = []
    for _ in range(3):
        # NaN under every output, so that an element left unwritten shows
        keep = [torch.full(shape, float("nan"), device=q.device)
                for shape in ((B, T, NH, HD), (B, T, NH), (B, T, NH))]
        del keep
        outs.append(kern())
    ra, rm, rl = plain()
    torch.cuda.synchronize()
    acc, m, l = outs[0]
    live = qstart > 0
    got, ref = acc[live] / l[live][..., None], ra[live] / rl[live][..., None]
    ok, excess, fro, err = flash_close(got, ref, rel, frob)
    lse, rlse = m[live] + torch.log2(l[live]), rm[live] + torch.log2(
        rl[live])
    lse_err = (lse - rlse).abs().max().item()
    lse_ok = bool(((lse - rlse).abs() <= (1e-4 if f32 else 1e-3)
                   + (1e-6 if f32 else 1e-5) * rlse.abs()).all())
    dead_ok = (bool((acc[~live] == 0).all()) and bool((l[~live] == 0)
               .all()) and bool((m[~live] == -1e30).all()))
    same = all(torch.equal(x, y) for o in outs[1:] for x, y in zip(outs[0], o))
    sched_ok = not sched or fro <= PAGED_SCHEDULE_FROB
    line = (f"{name}: acc/l max_abs_err {err:.3e} excess {excess:.3e} rel "
            f"frob {fro:.3e}{' (tol 2^-12)' if sched else ''}; lse "
            f"max_abs_err {lse_err:.3e}; padding row exact {dead_ok}; the "
            f"same bits over three calls {same}")
    print(line)
    assert ok and lse_ok and dead_ok and same and sched_ok, (
        f"{name} disagrees: flash rule {ok} (excess {excess:.3e}), lse "
        f"{lse_ok}, padding row {dead_ok}, bits {same}, rel frob "
        f"{fro:.3e}{' over 2^-12' if not sched_ok else ''}")
    return err


def check_verify(dev, errs):
    """Row 6 against its plain version at the kernel's split."""
    from paddle_tpu_torch.ops import paged_attention as pa
    phase("check the verify read against its plain version")
    cases = [c + (VERIFY_QSTART,) for c in VERIFY_CASES] + [
        VERIFY_CASES[0] + (VERIFY_SCHEDULE_QSTART,)]
    for nh, nkv, T, dtype, spread, qstart in cases:
        a = _verify_inputs(nh, nkv, qstart, T, SEED + nh + T, dev,
                           dtype=dtype, spread=spread)
        args = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                a["layer"])
        splits = pa.kernel_splits(a["tables"].shape[1], 128)
        chunks, height = pa.verify_chunks(T * nh // nkv)
        sched = qstart is VERIFY_SCHEDULE_QSTART
        err = verify_held(
            f"paged_attention_verify {str(dtype)[6:]} NH={nh} NKV={nkv} "
            f"T={T} qstart {qstart}{' spread' if spread else ''} "
            f"({splits} splits, {chunks} chunks of {height} rows)",
            lambda: pa.paged_attention_verify(*args),
            lambda: pa.paged_attention_verify_plain(*args, splits=splits),
            a["q"], a["qstart"], dtype == torch.float32,
            *FLASH_TOL[dtype][0], sched=sched)
        errs["paged_attention_verify"] = max(
            errs.get("paged_attention_verify", 0.0), err)
        del a


# int8 paged KV (rows 5, 4, 7, 9). Quantized pools of the 7B shape come
# from kv_quant_columns of random bf16 columns (the serving path's bytes);
# the small GQA cases put random codes under power-of-two scales, q on a
# 2^-5 grid, and multiply the K scales of each row's second block by
# QUANT_SPREAD so its scores lead the first block's by hundreds of log2
# units: every score is then exact in f32 in any order, and the check sees
# the mask, the softmax and P.V. P is f32 in the kernels and the plain
# versions (q cast to f32), so every case takes FLASH_TOL's f32 forward
# entry (rel 1e-5, frob 1e-5); row 7's m + log2(l) to 1e-4 + 1e-6 |ref|.
# Rows 5, 4 and 7 are held to the plain versions at the kernel's split
# (``kernel_splits``; each split from its own max), and at rows of 2-4
# blocks (PAGED_SCHEDULE_POSITIONS) also to PAGED_SCHEDULE_FROB, as rows 3
# and 6 are.
QUANT_SPREAD = 128.0
QUANT_CASES = [(32, 32, torch.bfloat16, None),    # llama_7b, bf16 q
               (16, 16, torch.bfloat16, None),    # a rank at mp 2
               (8, 4, torch.float32, QUANT_SPREAD),
               (16, 4, torch.float32, QUANT_SPREAD),
               (32, 4, torch.float32, QUANT_SPREAD)]


def _quantize_pool(pool, nkv):
    """A [L, NP, KVD, bs] float pool column by column through
    kv_quant_columns: (int8 codes, f32 scales [L, NP, NKV, bs])."""
    from paddle_tpu_torch.ops.paged_attention import kv_quant_columns
    L, NP, KVD, bs = pool.shape
    q, s = kv_quant_columns(pool.permute(0, 1, 3, 2).reshape(-1, KVD), nkv)
    return (q.reshape(L, NP, bs, KVD).permute(0, 1, 3, 2).contiguous(),
            s.reshape(L, NP, bs, nkv).permute(0, 1, 3, 2).contiguous())


def _quant_inputs(nh, nkv, counts, seed, dev, qdtype, T=None, hd=128,
                  bs=128, layers=2, spread=None, max_nb=None):
    """int8 pools and scale pools over fragmented random tables that hold
    each row's new token at position ``counts`` or, with T, its ``counts``
    cached tokens and T fed positions; q [B, NH, HD] or [B, T, NH, HD] in
    qdtype, pre-scaled; fed or new columns' codes and scales [layers, B,
    T or 1, KVD | NKV]; tables ``max_nb`` wide (default: one past the
    longest row's blocks).
    spread None: every pool and new column is kv_quant_columns of a random
    bf16 column. Else the exact-score layout described above."""
    from paddle_tpu_torch.ops.paged_attention import LOG2E, kv_quant_columns
    g = torch.Generator(device=dev).manual_seed(seed)
    b, kvd = len(counts), nkv * hd
    if T is None:           # decode rows: the new token at position c
        need = [c // bs + 1 for c in counts]
    else:                   # verify rows: c cached and T fed (0: padding)
        need = [-(-(c + T) // bs) if c else 0 for c in counts]
    n_pool = 1 + sum(need)
    perm = (torch.randperm(n_pool - 1, generator=g, device=dev) + 1).tolist()
    tables = torch.zeros((b, max_nb or max(need) + 1), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    qshape = (b, nh, hd) if T is None else (b, T, nh, hd)
    q = torch.randn(qshape, generator=g, device=dev) * (LOG2E / math.sqrt(hd))
    cshape = (layers, b, T or 1)
    if spread is None:
        def pool():
            return _quantize_pool(torch.randn(
                (layers, n_pool, kvd, bs), generator=g, device=dev,
                dtype=torch.bfloat16), nkv)

        def cols():
            c, sc = kv_quant_columns(torch.randn(
                (math.prod(cshape), kvd), generator=g, device=dev,
                dtype=torch.bfloat16), nkv)
            return c.reshape(*cshape, kvd), sc.reshape(*cshape, nkv)
        (kp, ks), (vp, vs) = pool(), pool()
        (nk, nks), (nv, nvs) = cols(), cols()
    else:
        def codes(*shape):
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)

        def scales(*shape):
            return 2.0 ** -torch.randint(5, 8, shape, generator=g,
                                         device=dev).float()
        kp, vp = codes(layers, n_pool, kvd, bs), codes(layers, n_pool, kvd,
                                                       bs)
        ks, vs = scales(layers, n_pool, nkv, bs), scales(layers, n_pool, nkv,
                                                         bs)
        for i, n in enumerate(need):
            if n > 1:
                ks[-1, int(tables[i, 1])] *= spread
        nk, nv = codes(*cshape, kvd), codes(*cshape, kvd)
        nks, nvs = scales(*cshape, nkv), scales(*cshape, nkv)
        q = torch.round(q * 32) / 32
    return dict(q=q.to(qdtype), k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                tables=tables.to(dev),
                rows=torch.tensor(counts, dtype=torch.int32, device=dev),
                new_k=nk, new_v=nv, new_ks=nks, new_vs=nvs, layer=layers - 1)


def check_quant(dev, errs):
    """Rows 5, 4 and 7 against their plain versions at the kernel's split
    at llama_7b's attention shape (bf16 q, pools from kv_quant_columns of
    bf16 columns; row 3's positions, row 6's qstarts) and on the f32 GQA
    spread cases, the schedule's frob at rows of 2-4 blocks too (though P
    stays f32); rows 5 and 4 the same bits over three calls, row 5's pools
    bitwise the plain version's with the new bytes and scales landed, row
    4's length-0 row exactly 0 over a NaN-poisoned output; row 7 under
    ``verify_held``'s rules (row 9: ``check_commit``)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    phase("check the int8 kernels (rows 5, 4, 7) against their plain "
          "versions")
    rel, frob = FLASH_TOL[torch.float32][0]
    cases = [c + (PAGED_POSITIONS,) for c in QUANT_CASES] + [
        QUANT_CASES[0] + (PAGED_SCHEDULE_POSITIONS,)]
    for nh, nkv, qdtype, spread, positions in cases:
        sched = positions is PAGED_SCHEDULE_POSITIONS
        a = _quant_inputs(nh, nkv, positions, SEED + nh + nkv + sched, dev,
                          qdtype, spread=spread)
        pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        ref_pools = [t.clone() for t in pools]
        new = [a[k][-1, :, 0].contiguous()
               for k in ("new_k", "new_v", "new_ks", "new_vs")]
        call = (a["q"], *new, *pools, a["tables"], a["rows"], a["layer"])
        splits = pa.kernel_splits(a["tables"].shape[1], 128)
        # the same column written again: the pools do not move, and the
        # splits' ordered combine gives the same bits
        outs = [pa.paged_attend_update_quant(*call) for _ in range(3)]
        ref = pa.paged_attend_update_quant_plain(a["q"], *new, *ref_pools,
                                                 a["tables"], a["rows"],
                                                 a["layer"], splits=splits)
        torch.cuda.synchronize()
        got = outs[0]
        ok, excess, fro, err = flash_close(got, ref, rel, frob)
        same = all(torch.equal(got, x) for x in outs[1:])
        bitwise = all(torch.equal(x, y) for x, y in zip(pools, ref_pools))
        pos = a["rows"].long()
        blk = a["tables"][torch.arange(len(pos), device=dev), pos // 128]
        landed = torch.equal(pools[0][a["layer"], blk.long(), :, pos % 128],
                             new[0]) and torch.equal(
            pools[2][a["layer"], blk.long(), :, pos % 128], new[2])
        name = (f"{str(qdtype)[6:]} q NH={nh} NKV={nkv} HD=128"
                f"{' spread' if spread else ''}")
        print(f"paged_attend_update_quant {name} positions {positions} "
              f"({splits} splits): max_abs_err {err:.3e} excess "
              f"{excess:.3e} rel frob {fro:.3e}"
              f"{' (tol 2^-12)' if sched else ''}; the same bits over three "
              f"calls {same}; pools bitwise {bitwise}, new bytes and scales "
              f"landed {landed}")
        assert ok and same and bitwise and landed and (
            not sched or fro <= PAGED_SCHEDULE_FROB), \
            "paged_attend_update_quant disagrees"
        errs["paged_attend_update_quant"] = max(
            errs.get("paged_attend_update_quant", 0.0), err)
        lengths = a["rows"] + 1
        lengths[0] = 0                      # a row of length 0 reads 0
        outs = []
        for _ in range(3):
            # NaN under the output, so that a row left unwritten shows
            torch.full(a["q"].shape, float("nan"), device=dev)
            outs.append(pa.paged_attention_quant(a["q"], *pools, a["tables"],
                                                 lengths, a["layer"]))
        ref = pa.paged_attention_quant_plain(a["q"], *pools, a["tables"],
                                             lengths, a["layer"],
                                             splits=splits)
        torch.cuda.synchronize()
        got = outs[0]
        ok, excess, fro, err = flash_close(got[1:], ref[1:], rel, frob)
        same = all(torch.equal(got, x) for x in outs[1:])
        zero = bool((got[0] == 0).all())
        print(f"paged_attention_quant {name} lengths {lengths.tolist()} "
              f"({splits} splits): max_abs_err {err:.3e} excess "
              f"{excess:.3e} rel frob {fro:.3e}"
              f"{' (tol 2^-12)' if sched else ''}; the same bits over three "
              f"calls {same}; length-0 row exactly 0 {zero}")
        assert ok and same and zero and (
            not sched or fro <= PAGED_SCHEDULE_FROB), \
            "paged_attention_quant disagrees"
        errs["paged_attention_quant"] = max(
            errs.get("paged_attention_quant", 0.0), err)
        del a, pools, ref_pools, outs

    cases = [c + (VERIFY_QSTART,) for c in VERIFY_CASES] + [
        VERIFY_CASES[0] + (VERIFY_SCHEDULE_QSTART,)]
    for nh, nkv, T, dtype, spread, qstart in cases:
        a = _quant_inputs(nh, nkv, qstart, SEED + nh + T, dev, dtype,
                          T=T, spread=spread and QUANT_SPREAD)
        args = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        splits = pa.kernel_splits(a["tables"].shape[1], 128)
        err = verify_held(
            f"paged_attention_verify_quant {str(dtype)[6:]} q NH={nh} "
            f"NKV={nkv} T={T} qstart {qstart}{' spread' if spread else ''} "
            f"({splits} splits)",
            lambda: pa.paged_attention_verify_quant(*args),
            lambda: pa.paged_attention_verify_quant_plain(*args,
                                                          splits=splits),
            a["q"], a["rows"], True, rel, frob,
            sched=qstart is VERIFY_SCHEDULE_QSTART)
        errs["paged_attention_verify_quant"] = max(
            errs.get("paged_attention_verify_quant", 0.0), err)
        del a



# Dead columns never enter a product in rows 2-7: each kernel runs twice on
# the same inputs, once with every dead column (past its row's last token
# in the row's last block, and all of null block 0) zero and once NaN (the
# int8 pools: their scale pools NaN, the codes random); the outputs must be
# finite where a row is live and bitwise equal. A tail that multiplied an
# exact 0 weight by a stale NaN would make the second NaN.
DEAD_POSITIONS = [0, 1, 126, 128, 300, 777, 1023, 1500]   # ragged tails
DEAD_QSTART = [1, 127, 128, 129, 300, 0, 1500, 1000]      # a padding row


def _fill_dead(pools, tables, last, value):
    """Set every column of ``pools`` past last[b] in row b's last block,
    and all of block 0, to ``value`` (in place); last[b] < 0: nothing of
    row b is live."""
    bs = pools[0].shape[-1]
    for b, lst in enumerate(last.tolist()):
        if lst >= 0:
            blk = int(tables[b, lst // bs])
            for t in pools:
                t[:, blk, :, lst % bs + 1:] = value
    for t in pools:
        t[:, 0] = value


def check_dead_columns(dev):
    from paddle_tpu_torch.ops import paged_attention as pa
    phase("check that dead KV columns never reach rows 2-7 (NaN against "
          "zero in every dead column)")
    nan = float("nan")
    out = {}
    verify_live = [i for i, q in enumerate(DEAD_QSTART) if q]

    def twice(name, make, run, pools_of, last_of, live_rows):
        res = []
        for value in (0.0, nan):
            a = make()
            _fill_dead(pools_of(a), a["tables"], last_of(a), value)
            got = run(a)
            torch.cuda.synchronize()
            res.append(got if isinstance(got, tuple) else (got,))
        fin = all(bool(torch.isfinite(t[live_rows]).all()) for t in res[1])
        same = all(torch.equal(x, y) for x, y in zip(*res))
        print(f"{name}: live rows finite over NaN dead columns {fin}, "
              f"bitwise equal to the zero-dead run {same}")
        assert fin and same, f"{name}: a dead column reached the output"
        out[name] = same

    def paged(seed):
        return lambda: _paged_inputs(32, 32, DEAD_POSITIONS, seed, dev)
    twice("paged_attend_update (row 3)", paged(SEED + 140),
          lambda a: pa.paged_attend_update(
              a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
              a["tables"], a["positions"], a["layer"]),
          lambda a: (a["k_pool"], a["v_pool"]),
          lambda a: a["positions"], slice(None))
    twice("paged_attention (row 2)", paged(SEED + 141),
          lambda a: pa.paged_attention(
              a["q"], a["k_pool"], a["v_pool"], a["tables"],
              a["positions"] + 1, a["layer"]),
          lambda a: (a["k_pool"], a["v_pool"]),
          lambda a: a["positions"], slice(None))
    twice("paged_attention_verify (row 6)",
          lambda: _verify_inputs(32, 32, DEAD_QSTART, SPEC_K + 1,
                                 SEED + 142, dev),
          lambda a: pa.paged_attention_verify(
              a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
              a["layer"]),
          lambda a: (a["k_pool"], a["v_pool"]),
          lambda a: a["qstart"] - 1, verify_live)

    def quant(seed, T=None):
        counts = DEAD_POSITIONS if T is None else DEAD_QSTART
        return lambda: _quant_inputs(32, 32, counts, seed, dev,
                                     torch.bfloat16, T=T)
    scales = lambda a: (a["k_scale"], a["v_scale"])
    new = lambda a: [a[k][-1, :, 0].contiguous()
                     for k in ("new_k", "new_v", "new_ks", "new_vs")]
    twice("paged_attend_update_quant (row 5)", quant(SEED + 143),
          lambda a: pa.paged_attend_update_quant(
              a["q"], *new(a), a["k_pool"], a["v_pool"], a["k_scale"],
              a["v_scale"], a["tables"], a["rows"], a["layer"]),
          scales, lambda a: a["rows"], slice(None))
    twice("paged_attention_quant (row 4)", quant(SEED + 144),
          lambda a: pa.paged_attention_quant(
              a["q"], a["k_pool"], a["v_pool"], a["k_scale"], a["v_scale"],
              a["tables"], a["rows"] + 1, a["layer"]),
          scales, lambda a: a["rows"], slice(None))
    twice("paged_attention_verify_quant (row 7)",
          quant(SEED + 145, T=SPEC_K + 1),
          lambda a: pa.paged_attention_verify_quant(
              a["q"], a["k_pool"], a["v_pool"], a["k_scale"], a["v_scale"],
              a["tables"], a["rows"], a["layer"]),
          scales, lambda a: a["rows"] - 1, verify_live)
    return out


# Rows 8 and 9 (the commit) against their plain versions: bitwise on every
# block but the null block 0, block 0 byte for byte as it was (the kernels
# write live columns only, never block 0; the plain versions route dead
# columns there), the same bits from a second call on the same inputs, and
# every live column of a real block written. Commit lengths all 0, all 1
# (the serve-spec step's: nothing accepted), all T and mixed; windows
# across a block edge (qstart bs - 3 and bs - 2 with T = 5); bs 16 to
# 1024; f32, bf16 and int8 pools. Row 0 is a padding row (qstart 0, its
# table all block 0), whose live columns, where its commit length says so,
# land nowhere.
COMMIT_LENS = {"none": [0] * 8, "one": [1] * 8, "all": [5] * 8,
               "mixed": COMMIT_LEN}
# (dtype, layers, block size, commit-length sets[, heads]): llama_7b's
# commit (L = 32, KVD = 4096, bs 128) in bf16 and int8, a rank's at mp 2
# (KVD = 2048), then four layers at the other block sizes and in f32
COMMIT_CASES = [(torch.bfloat16, 32, 128, tuple(COMMIT_LENS)),
                ("int8", 32, 128, tuple(COMMIT_LENS)),
                (torch.bfloat16, 32, 128, ("all", "mixed"), 16),
                ("int8", 32, 128, ("all", "mixed"), 16),
                (torch.float32, 4, 128, tuple(COMMIT_LENS)),
                (torch.bfloat16, 4, 16, ("all", "mixed")),
                (torch.bfloat16, 4, 1024, ("all", "mixed")),
                ("int8", 4, 16, ("all", "mixed")),
                ("int8", 4, 1024, ("one", "mixed")),
                (torch.float32, 4, 64, ("one", "mixed"))]


def commit_qstart(bs):
    """Qstarts whose windows of T = 5 cross a block edge at bs (rows 2
    and 3); row 0 a padding row."""
    return [0, 3, bs - 3, bs - 2, 300, bs, 1000, 2000]


def commit_case(pa, dtype, layers, bs, lens, seed, dev, heads=32):
    """Row 8 (dtype a float type) or row 9 (dtype "int8") at one case;
    returns (max_abs_err on blocks 1:, a line to print)."""
    quant = dtype == "int8"
    qstart, T = commit_qstart(bs), 5
    if quant:
        a = _quant_inputs(heads, heads, qstart, seed, dev, torch.bfloat16,
                          T=T, bs=bs, layers=layers)
        names, qs = ("k_pool", "v_pool", "k_scale", "v_scale"), a["rows"]
        new = [a[k] for k in ("new_k", "new_v", "new_ks", "new_vs")]
        kern, plain = pa.paged_verify_commit_quant, \
            pa.paged_verify_commit_quant_plain
    else:
        a = _verify_inputs(heads, heads, qstart, T, seed, dev, dtype=dtype,
                           bs=bs, layers=layers)
        names, qs = ("k_pool", "v_pool"), a["qstart"]
        new = [a["new_k"], a["new_v"]]
        kern, plain = pa.paged_verify_commit, pa.paged_verify_commit_plain
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    orig = [a[k] for k in names]
    runs = []
    for _ in range(2):
        pools = [t.clone() for t in orig]
        kern(*new, *pools, a["tables"], qs, clen)
        runs.append(pools)
    ref = [t.clone() for t in orig]
    plain(*new, *ref, a["tables"], qs, clen)
    torch.cuda.synchronize()
    got = runs[0]
    bitwise = all(torch.equal(x[:, 1:], y[:, 1:]) for x, y in zip(got, ref))
    block0 = all(torch.equal(x[:, 0], y[:, 0]) for x, y in zip(got, orig))
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    err = max((x[:, 1:].float() - y[:, 1:].float()).abs().max().item()
              for x, y in zip(got, ref))
    # a random column equals the old one with odds of about 255^-4096
    written = [int((x[:, 1:] != y[:, 1:]).any(dim=2).sum())
               for x, y in zip(got, orig)]
    want = layers * sum(c for c, q in zip(lens, qstart) if q > 0)
    line = (f"{kern.__name__} L={layers} B=8 T={T} KVD={heads * 128} bs={bs} "
            f"{'int8' if quant else str(dtype)[6:]} qstart {qstart} "
            f"commit_len {lens}: bitwise but block 0 {bitwise}, block 0 "
            f"untouched {block0}, the same bits twice {same}, columns "
            f"written {written} of {want}")
    assert bitwise and block0 and same, line
    assert all(n == want for n in written), line
    return err, line


def check_commit(dev, errs):
    """Rows 8 and 9 against their plain versions (the cases above)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    phase("check the commit (rows 8 and 9) against its plain versions")
    for i, (dtype, layers, bs, sets, *heads) in enumerate(COMMIT_CASES):
        key = ("paged_verify_commit_quant" if dtype == "int8"
               else "paged_verify_commit")
        for name in sets:
            err, line = commit_case(pa, dtype, layers, bs, COMMIT_LENS[name],
                                    SEED + 8 + i, dev, *heads)
            print(line)
            errs[key] = max(errs.get(key, 0.0), err)
        torch.cuda.empty_cache()


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
# BH = 128 is the Llama train phase's shape, at BH = 160 train-13b's
# (B = 4 x 40 heads), at BH = 64 and 32 train-dp's mp 2 (B = 4 and 2
# rows a rank x 16 heads); S = 512, D = 64 the ERNIE
# phase's (B = 8 x 16 heads); S = 1024, D = 64 at BH = 256 the generate
# phase's prefill (B = 8 x 32 heads, kv heads repeated). Sq != Sk are
# flash_block_fwd's shapes (one KV block of a ring, causal top-left); a
# kv_len < Sk masks the keys past it (forward only: the backward takes
# every key). (BH, Sq, Sk, D, causal, dtype, kv_len or None for all.)
FLASH_TOL = {torch.float32: ((1e-5, 1e-5), (1e-4, 1e-4)),
             torch.bfloat16: ((2 ** -6, 2 ** -10), (2 ** -6, 2 ** -10))}
FLASH_CASES = [(8, 200, 200, 128, True, torch.bfloat16, None),
               (8, 200, 200, 128, False, torch.bfloat16, None),
               (128, 2048, 2048, 128, True, torch.bfloat16, None),
               (160, 2048, 2048, 128, True, torch.bfloat16, None),
               (64, 2048, 2048, 128, True, torch.bfloat16, None),
               (32, 2048, 2048, 128, True, torch.bfloat16, None),
               (8, 2048, 2048, 128, False, torch.bfloat16, None),
               (128, 512, 512, 64, True, torch.bfloat16, None),
               (GEN_B * 32, GEN_S, GEN_S, 64, True, torch.bfloat16, None),
               (8, 256, 512, 128, True, torch.bfloat16, None),
               (8, 512, 256, 64, True, torch.bfloat16, None),
               (8, 384, 640, 128, False, torch.bfloat16, None),
               (8, 300, 1152, 128, True, torch.bfloat16, 1000),
               (8, 200, 333, 64, False, torch.bfloat16, 130),
               (8, 200, 200, 64, True, torch.float32, None)]


def _flash_inputs(bh, s, d, dtype, seed, dev, sk=None):
    """q pre-scaled and do [bh, s, d]; k, v [bh, sk (default s), d]."""
    from paddle_tpu_torch.ops.flash_attention import LOG2E
    g = torch.Generator(device=dev).manual_seed(seed)
    qs = (torch.randn((bh, s, d), generator=g, device=dev)
          * (LOG2E / math.sqrt(d))).to(dtype)
    kv = [torch.randn((bh, s if sk is None else sk, d), generator=g,
                      device=dev).to(dtype) for _ in range(2)]
    return [qs] + kv + [torch.randn((bh, s, d), generator=g, device=dev)
                        .to(dtype)]


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


def flash_case(fa, bh, s, d, causal, dtype, seed, dev, sk=None,
               kv_len=None):
    """One case of both kernels against their plain versions: {output:
    flash_close(...)} for o, dq, dk, dv, and the lse's max abs error.
    With kv_len (keys past it masked), the forward only."""
    qs, k, v, do = _flash_inputs(bh, s, d, dtype, seed, dev, sk)
    (rel_f, frob_f), (rel_b, frob_b) = FLASH_TOL[dtype]
    o, lse = fa.flash_fwd(qs, k, v, causal, kv_len)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v, causal, kv_len)
    grads = {}
    if kv_len is None:
        delta = (do.float() * o_ref.float()).sum(-1)
        got = fa.flash_bwd(qs, k, v, do, lse_ref, delta, causal,
                           1 / math.sqrt(d))
        want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, delta, causal,
                                  1 / math.sqrt(d))
        grads = dict(zip(("dq", "dk", "dv"), zip(got, want)))
    torch.cuda.synchronize()
    res = {"o": flash_close(o, o_ref, rel_f, frob_f)}
    res.update((name, flash_close(a, b, rel_b, frob_b))
               for name, (a, b) in grads.items())
    return res, (lse - lse_ref).abs().max().item()


def check_flash(dev, errs):
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("check flash kernels against their plain versions")
    for i, (bh, sq, sk, d, causal, dtype, kv_len) in enumerate(FLASH_CASES):
        res, err_lse = flash_case(fa, bh, sq, d, causal, dtype, SEED + i,
                                  dev, sk, kv_len)
        (rel_f, frob_f), (rel_b, frob_b) = FLASH_TOL[dtype]
        print(f"flash BH={bh} Sq={sq} Sk={sk} kv_len={kv_len or sk} D={d} "
              f"causal={causal} {str(dtype)[6:]} "
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
        if kv_len is None:
            errs["flash_bwd"] = max(errs.get("flash_bwd", 0.0),
                                    *(res[n][3] for n in ("dq", "dk", "dv")))
        torch.cuda.empty_cache()


TRAIN_LOSS_RTOL = 1e-5   # f32 on both; sums in another order


def check_tiny_train(dev, mode="auto"):
    """Three tiny fp32 train steps through the kernels on the card give
    the losses of the same steps through the plain versions on the CPU,
    and the card run advances the flash counters of the backward ``mode``
    (PADDLE_TPU_TORCH_FLASH_BWD): flash_bwd under auto, the split pair
    under split."""
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.ops import flash_attention as fa
    phase(f"check a tiny fp32 Llama train ({fa.ENV_FLASH_BWD}={mode}): card "
          f"kernels vs CPU plain")
    cfg = tl.llama_tiny(vocab=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, seq=256)
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, size=(2, 201)).astype(np.int32)
    ids, labels = x[:, :-1], x[:, 1:]
    params0 = tl.init_llama_params(cfg, seed=1, device="cpu")
    names = ("flash_fwd", "flash_bwd", "flash_bwd_dkv", "flash_bwd_dq")
    out = []
    with _bwd_mode(mode):
        for d in ("cpu", dev):
            step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(),
                                             device=d)
            # copies: the step updates params in place
            params = {k: ({kk: vv.to(d, copy=True) for kk, vv in v.items()}
                          if isinstance(v, dict) else v.to(d, copy=True))
                      for k, v in params0.items()}
            opt = tl._adamw_init(params)
            for n in names:
                getattr(fa, n).launches = 0
            losses = []
            for _ in range(3):
                params, opt, loss = step(params, opt, ids, labels)
                losses.append(float(loss))
            out.append((losses, {n: getattr(fa, n).launches for n in names}))
    (cpu, n0), (card, n1) = out
    L = cfg.num_hidden_layers
    split = mode == "split"
    want = {"flash_fwd": 3 * 2 * L, "flash_bwd": 0 if split else 3 * L,
            "flash_bwd_dkv": 3 * L if split else 0,
            "flash_bwd_dq": 3 * L if split else 0}
    assert not any(n0.values()) and n1 == want, out
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL)
    print(f"losses card {card} cpu {cpu} (rtol {TRAIN_LOSS_RTOL}); "
          f"launches {n1}")


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


def _poisoned(shape, dtype, dev):
    """Frees a NaN-filled block of ``shape``: the caching allocator hands
    it to the next allocation of that size, so an output element that a
    kernel leaves unwritten reads NaN and not a lucky zero."""
    torch.full(shape, float("nan"), dtype=dtype, device=dev)


def gmm_case(tg, counts, n_rows, sched, dtype, k, n, seed, dev):
    """fwd, dX and dW against their plain versions; dead tiles and empty
    experts must be exactly zero. Returns {kernel: flash_close(...)}."""
    e = counts.shape[0]
    lhs, rhs, dout = _gmm_operands(dev, dtype, n_rows, e, k, n, seed)
    rel, frob = GMM_TOL[dtype]
    got = {}
    _poisoned((n_rows, n), dtype, dev)
    got["gmm_fwd"] = tg.gmm_fwd(lhs, rhs, sched)
    _poisoned((n_rows, k), dtype, dev)
    got["gmm_dx"] = tg.gmm_dx(dout, rhs, sched)
    got["gmm_dw"] = tg.gmm_dw(lhs, dout, sched, num_experts=e)
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
        cases += [(f"{name} {cl}", c, rows, sc, dtype, k, n)
                  for dtype, shapes in (
                      (torch.float32, ((128, 64), (256, 192))),
                      # bf16 dW on wgmma: 128-column blocks, and a
                      # 64-column last block at N = 192
                      (torch.bfloat16, ((256, 192), (256, 256))))
                  for k, n in shapes]
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
    check_gmm_one_expert(tg, dev)
    for key, (dk, dp) in gmm_drifts(tg, dev).items():
        ok = dw_drift_ok(dk, dp)
        print(f"{key} bf16 on the ERNIE slice, drift against f64: kernel "
              f"{dk:+.3e}, plain {dp:+.3e}, excess {dk - dp:+.3e} "
              f"{'ok' if ok else 'FAILED'}")
        assert ok, f"{key} drift"
    torch.cuda.empty_cache()


# A kernel's drift along an f64 product may exceed its plain version's by
# this much: dW's when one expert holds every row (tools/gmm_mutants.py
# measures the sound kernel and one that carries the sum in the tensor
# cores), the forward's and dX's on the ERNIE slice
DW_DRIFT_EXCESS = 2e-6


def dw_drift(x, ref):
    """sum((x - ref) ref) / sum(ref ref): a sum that loses to rounding
    toward zero drifts low."""
    d = x.double() - ref
    return ((d * ref).sum() / (ref * ref).sum()).item()


def dw_drift_ok(kernel_drift, plain_drift):
    return abs(kernel_drift - plain_drift) <= DW_DRIFT_EXCESS


def gmm_drifts(tg, dev):
    """The forward's and dX's drift along a product summed in f64 from
    the same bf16 operands, kernel and plain version, at both MOE_SHAPES
    on the ERNIE slice's schedule -> {"gmm_fwd[K=..,N=..]": (kernel drift,
    plain drift), ...}."""
    counts, n_rows, sched = _slice_schedule(dev)
    out = {}
    for k, n in MOE_SHAPES:
        lhs, rhs, dout = _gmm_operands(dev, torch.bfloat16, n_rows,
                                       counts.shape[0], k, n, SEED + 41)
        for name, a, kern, plain in (
                ("gmm_fwd", lhs, tg.gmm_fwd, tg.gmm_fwd_plain),
                ("gmm_dx", dout, tg.gmm_dx, tg.gmm_dx_plain)):
            ref = torch.zeros((n_rows, n if name == "gmm_fwd" else k),
                              dtype=torch.float64, device=dev)
            for rows, e in tg._live_tiles(sched, 128):
                w = rhs[e].double()
                ref[rows] = a[rows].double() @ (w if name == "gmm_fwd"
                                                else w.T)
            got, want = kern(a, rhs, sched), plain(a, rhs, sched)
            torch.cuda.synchronize()
            out[f"{name}[K={k},N={n}]"] = (dw_drift(got, ref),
                                           dw_drift(want, ref))
            del ref, got, want
        del lhs, rhs, dout
    return out


def check_gmm_one_expert(tg, dev):
    """dW when one expert holds all of the ERNIE slice's 16,384 routed
    rows (128 tiles summed into one block), bf16 at (K, N) = MOE_SHAPES[0]:
    the kernel against its plain version under GMM_TOL, and both against
    a product summed in f64 from the same bf16 operands (relative
    Frobenius error and drift along the reference, ``dw_drift``; the
    kernel's may exceed the plain version's by ``DW_DRIFT_EXCESS``)."""
    k, n = MOE_SHAPES[0]
    e, routed = 32, MOE_B * MOE_S * 4
    c = torch.zeros((e,), dtype=torch.int32, device=dev)
    c[0] = routed
    sched = tg.tile_schedule(c, routed // 128, 128)[:2]
    lhs, _, dout = _gmm_operands(dev, torch.bfloat16, routed, e, k, n,
                                 SEED + 40)
    got = tg.gmm_dw(lhs, dout, sched, num_experts=e)
    want = tg.gmm_dw_plain(lhs, dout, sched, num_experts=e)
    ref = lhs.double().T @ dout.double()
    torch.cuda.synchronize()
    ok, excess, fro, err = flash_close(got, want, *GMM_TOL[torch.bfloat16])
    line, drifts = {}, []
    for name, x in (("kernel", got[0]), ("plain", want[0])):
        drifts.append(dw_drift(x, ref))
        fro_x = ((x.double() - ref).norm() / ref.norm()).item()
        line[name] = f"rel frob {fro_x:.3e}, drift {drifts[-1]:+.3e}"
    drift_ok = dw_drift_ok(*drifts)
    print(f"gmm_dw one expert holds all {routed} rows K={k} N={n} bf16: "
          f"against plain max_abs_err {err:.3e}, rel frob {fro:.3e} "
          f"{'ok' if ok else 'FAILED'}; against f64: kernel {line['kernel']}"
          f"; plain {line['plain']}; drift excess "
          f"{drifts[0] - drifts[1]:+.3e} {'ok' if drift_ok else 'FAILED'}")
    assert ok and drift_ok and all((got[1:] == 0).all(1).all(1)), \
        "gmm_dw one expert"


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


def check_tiny_ernie_capacity(dev):
    """Three tiny fp32 ERNIE-MoE train steps under the capacity slot
    schedule (the default dispatch) on the non-split stack, every layer
    MoE and five layers at moe_every 2, through the kernels on the card
    give the CPU's losses and routing counts; each layer is recomputed in
    the backward, so the flash forward launches twice a layer and step,
    and no grouped matmul runs."""
    import dataclasses
    from paddle_tpu_torch.models import ernie_moe as tm
    phase("check a tiny fp32 ERNIE-MoE train under capacity dispatch, "
          "non-split stacks: card kernels vs CPU plain")
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, size=(2, 97)).astype(np.int32)
    for field in (dict(moe_every=1), dict(num_hidden_layers=5)):
        cfg = dataclasses.replace(_tiny_ernie_config(), dispatch_mode=None,
                                  **field)
        assert tm.resolve_dispatch_mode(cfg) == "capacity"
        params0 = tm.init_params(cfg, seed=1, device="cpu")
        assert "dense" not in params0["layers"]
        out = []
        for d in ("cpu", dev):
            step, _, _ = tm.build_train_step(cfg, device=d, with_stats=True)
            params = _to_device(params0, d)
            opt = tm._adamw_init(params)
            _zero_counts()
            losses, counts = [], []
            for _ in range(3):
                params, opt, loss, st = step(params, opt, x[:, :-1],
                                             x[:, 1:])
                losses.append(float(loss))
                counts.append([float(st[k]) for k in (
                    "moe_routed_tokens", "moe_dropped_tokens")])
            out.append((losses, counts, _counts()))
        (cpu, c0, n0), (card, c1, n1) = out
        L = cfg.num_hidden_layers
        assert not any(n0.values()), n0
        assert n1["flash_fwd"] == 3 * 2 * L and n1["flash_bwd"] == 3 * L, n1
        assert n1["rms_norm"] == 3 * ((2 * L + 1) + 2 * L), n1
        assert n1["gmm_fwd"] == n1["gmm_dx"] == n1["gmm_dw"] == 0, n1
        assert c0 == c1, (c0, c1)
        np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL)
        print(f"{field}: losses card {card} cpu {cpu} (rtol "
              f"{TRAIN_LOSS_RTOL}); routed/dropped {c1[-1]} on both; "
              f"launches flash {n1['flash_fwd']}/{n1['flash_bwd']} rms "
              f"{n1['rms_norm']}")


def check_tiny_streams(dev, kv_dtype="auto"):
    """A tiny fp32 Llama served through the kernels on the card gives the
    same greedy streams and events as the same engine through the plain
    versions on the CPU (the trace of the port's CPU parity tests), with
    the KV pools in ``kv_dtype``."""
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_tiny)
    phase(f"check a tiny fp32 Llama (kv_dtype {kv_dtype}): card kernels vs "
          f"CPU plain, greedy streams")
    cfg = llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                     seq=512)
    params = init_llama_params(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (7, 130, 300)]
    serve = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=64, max_seq_len=512, kv_dtype=kv_dtype)
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
    return out[1][0]


def check_tiny_spec_streams(dev, kv_dtype="auto"):
    """check_tiny_streams's model and trace with speculation on (draft_k 4,
    the default 1-layer draft), its o_proj and down_proj scaled by
    SPEC_DAMP so that the draft's proposals are accepted in part and the
    commit writes windows of several columns: speculative streams on the
    card (rows 3, 6 and 8; int8: 3, 7 and 9), speculative streams on the
    CPU (plain versions) and non-speculative streams on the card are
    token-identical; the two speculative runs have equal event logs and
    counts; every pool is leak-free."""
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_tiny)
    from paddle_tpu_torch.ops import paged_attention as pa
    phase(f"check a tiny fp32 Llama with speculation (kv_dtype {kv_dtype}): "
          f"card vs CPU vs non-speculative")
    verify = (pa.paged_attention_verify_quant if kv_dtype == "int8"
              else pa.paged_attention_verify)
    cfg = llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                     seq=512)
    params = init_llama_params(cfg, seed=3, device="cpu")
    for name in ("o_proj", "down_proj"):
        params["layers"][name].mul_(SPEC_DAMP)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (7, 130, 300)]
    serve = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=64, max_seq_len=512, draft_k=4,
                 kv_dtype=kv_dtype)
    out = {}
    for name, d, spec in (("card_spec", dev, True), ("cpu_spec", "cpu", True),
                          ("card_plain", dev, False)):
        eng = InferenceEngine(_to_device(params, d), cfg,
                              ServeConfig(speculative=spec, **serve),
                              record_events=True, device=d)
        before = verify.launches
        stats = eng.run([Request(pr, max_new_tokens=8, arrival=float(i))
                         for i, pr in enumerate(prompts)], deterministic=True)
        assert eng.pool.used_blocks == 0, f"{name}: pool leaked blocks"
        if name == "card_spec":
            assert verify.launches - before == \
                cfg.num_hidden_layers * stats["decode_steps"] > 0
        out[name] = ({s.req.request_id: s.tokens for s in eng.finished},
                     eng.events, stats["speculative"])
    assert out["card_spec"][0] == out["cpu_spec"][0] == out["card_plain"][0], \
        "speculative streams differ"
    assert out["card_spec"][1] == out["cpu_spec"][1], "event logs differ"
    assert out["card_spec"][2] == {**out["cpu_spec"][2], "draft_step_ms_mean":
                                   out["card_spec"][2]["draft_step_ms_mean"]}
    sp = out["card_spec"][2]
    assert 0 < sp["accepted"] < sp["proposed"], sp
    print(f"streams identical (card spec, CPU spec, card plain) for "
          f"{len(prompts)} requests, {len(out['card_spec'][1])} events "
          f"equal, pools leak-free; speculative {out['card_spec'][2]}")


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
    layer 1, with one split (the function as it was) and with the
    kernel's own split: the attention under flash_close (merged over
    positions), the caches bitwise (column pos holds new k/v, no other
    column changed), and the same bits from a second launch. Returns
    ({kernel (split): (ok, excess, frob, max err)}, the largest lead of
    tile 1's score max over tile 0's in log2 units, the kernel's split
    count)."""
    q, nk, nv, kc, vc = _slab_inputs(dev, dtype, b, nh, nkv, hd, T, seed,
                                     spread)
    s = torch.einsum("bgrd,bgdt->bgrt",
                     q.float().reshape(b, nkv, nh // nkv, hd),
                     kc[1].float().reshape(b, nkv, hd, T)[..., :256])
    lead = (s[..., 128:].amax(-1) - s[..., :128].amax(-1)).max().item()
    nsplit = da.kernel_splits(b, nkv, T, dev)
    rel, frob = SLAB_TOL[dtype]
    res = {}
    for pos in positions:
        k0, v0 = kc.clone(), vc.clone()
        got_ro = da.decode_attention_slab(q, kc, vc, 1, pos)
        again_ro = da.decode_attention_slab(q, kc, vc, 1, pos)
        refs_ro = [da.decode_attention_plain(q, k0, v0, 1, pos, n)
                   for n in (1, nsplit)]
        kp, vp = kc.clone(), vc.clone()
        k2, v2 = kc.clone(), vc.clone()
        got = da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, pos)
        again = da.decode_attend_update_slab(q, nk, nv, k2, v2, 1, pos)
        refs = [da.decode_attend_update_plain(q, nk, nv, kp, vp, 1, pos)]
        refs.append(da.decode_attention_plain(q, kp, vp, 1, pos, nsplit))
        torch.cuda.synchronize()
        assert torch.equal(kc, kp) and torch.equal(vc, vp), \
            f"slab caches differ from the plain version's at pos {pos}"
        assert torch.equal(k2, kp) and torch.equal(v2, vp), pos
        assert torch.equal(got, again) and torch.equal(got_ro, again_ro), \
            f"slab kernels give other bits on a second run at pos {pos}"
        k0[1, :, :, pos], v0[1, :, :, pos] = nk, nv
        assert torch.equal(kc, k0) and torch.equal(vc, v0), \
            f"column {pos} not written, or another column changed"
        for name, a, rs in (("decode_attend_update_slab", got, refs),
                            ("decode_attention_slab", got_ro, refs_ro)):
            for n, r in zip((1, nsplit), rs):
                c = flash_close(a, r, rel, frob)
                key = f"{name} (plain, splits={n})"
                p = res.get(key, (True, -math.inf, 0.0, 0.0))
                res[key] = (p[0] and c[0], max(p[1], c[1]), max(p[2], c[2]),
                            max(p[3], c[3]))
    return res, lead, nsplit


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
        res, lead, nsplit = slab_case(da, dtype, b, nh, nkv, hd, T,
                                      positions, SEED + i, dev, spread)
        rel, frob = SLAB_TOL[dtype]
        print(f"slab {name} {str(dtype)[6:]} positions {positions}, "
              f"{nsplit} splits of {da.split_tiles(T, nsplit)} tiles (tol "
              f"rel {rel:g} of |ref| + row max + rms, frob {frob:g}; caches "
              f"bitwise; bits over two runs): tile 1 leads tile 0 by up to "
              f"{lead:.1f} log2 units")
        for kern, (ok, excess, fro, err) in res.items():
            print(f"  {kern}: max_abs_err {err:.3e}  worst excess over the "
                  f"limit {excess:.3e}  rel frob {fro:.3e}  "
                  f"{'ok' if ok else 'FAILED'}")
            errs[kern.split()[0]] = max(errs.get(kern.split()[0], 0.0), err)
        assert all(r[0] for r in res.values()), f"slab kernels disagree: {res}"
        assert spread is None or lead > 130, f"spread only {lead}"
        assert spread is None or nsplit > 1, "the spread needs a split edge"
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
# bf16 layouts whose segments straddle the wgmma kernels' 128-row tiles
# and end inside a warpgroup's 64 rows (self and cross-attention),
# cross-attention with an empty k segment (rows with no live key), and a
# 2,048-token segment that starts 32 keys into a 64-key tile (a forward
# that walked its 64-key tiles from the segment's start, not from a
# multiple of 64, rounds P against other running maxima: 9.9e-4 to
# 1.04e-3 rel frob from the plain version on it, at the bf16 limit;
# tools/fwd_tile_gap.py --varlen)
VARLEN_BF16 = [([127, 129, 1, 255], None),
               ([127, 129, 1, 255], [130, 1, 127, 200]),
               ([40, 8, 30], [64, 0, 32]),
               ([32, 2048], None)]
# The bf16 limit above cannot resolve that gap, so on the last layout,
# causal, the bf16 forward's o is also held to this rel frob of its plain
# version: with the same rounding schedule the two differ only where f32
# sums in another order round o to another bf16 value (6.7e-5 to 7.3e-5
# on an H100; the shifted walk 9.4e-4). Non-causal rows there average
# 2,048 keys, o is small and those flips weigh more (1.7e-4 to 2.4e-4),
# so the rule is not applied to them.
VARLEN_FWD_SCHEDULE_FROB = 2 ** -12


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


# A varlen kernel's drift along an f64 product may exceed its plain
# version's by this much (rows 20-23 at the long pack and on one
# 65,536-token segment): between the sound kernels' excess (at most 6.6e-7
# in size on an H100) and that of kernels that carry the sum over q tiles
# or key stages in the tensor cores' accumulator (-7.5e-6 to -1.3e-4 for
# dK and dV, -7.8e-6 for dQ and -7.1e-6 for o on the long segment;
# tools/varlen_mutants.py, tools/flash_long_accuracy.py --varlen)
VARLEN_DRIFT_EXCESS = 2e-6
VARLEN_DRIFT_HEADS = 4


def varlen_fwd_f64(q, k, v, lens, scale, rows=4096):
    """A causal self-attention pack's forward at the plain version's
    rounding points (S in f32 times scale log2 e, the online softmax over
    64-key tiles aligned to multiples of 64 with P rounded to q's dtype
    against the running max), every sum and rescale in f64: q, k, v
    [H, T, D] -> o f64."""
    from paddle_tpu_torch.ops.flash_varlen import BLOCK_K, LOG2E
    dev, dt = q.device, q.dtype
    c2 = float(scale) * LOG2E
    o = torch.zeros(q.shape, dtype=torch.float64, device=dev)
    a = 0
    for n in lens:
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            qf = q[:, a + r0:a + r1].float()
            row = torch.arange(a + r0, a + r1, device=dev)[:, None]
            m = torch.full(qf.shape[:2], -math.inf, dtype=torch.float64,
                           device=dev)
            l = torch.zeros_like(m)
            acc = torch.zeros(qf.shape, dtype=torch.float64, device=dev)
            for c0 in range(a // BLOCK_K * BLOCK_K, a + r1, BLOCK_K):
                c0, c1 = max(c0, a), min(c0 + BLOCK_K, a + r1)
                s = (qf @ k[:, c0:c1].float().transpose(1, 2)) * c2
                col = torch.arange(c0, c1, device=dev)[None]
                s = s.masked_fill(col > row, -math.inf)
                mn = torch.maximum(m, s.amax(-1).double())
                base = torch.where(mn == -math.inf, 0.0, mn)
                p = torch.exp2(s - base[..., None].float())
                al = torch.exp2(m - base)
                l = l * al + p.double().sum(-1)
                acc = acc * al[..., None] \
                    + p.to(dt).double() @ v[:, c0:c1].double()
                m = mn
            o[:, a + r0:a + r1] = acc / l[..., None]
        a += n
    return o


def varlen_bwd_f64(q, k, v, do, lse, delta, lens, scale, rows=1024):
    """A causal self-attention pack's backward at the plain version's
    rounding points (S, P and dS in f32, P rounded to q's dtype for dV,
    dS for dK and dQ), every product summed in f64: q, k, v, do [H, T, D]
    -> (dq, dk, dv) f64."""
    from paddle_tpu_torch.ops.flash_varlen import LOG2E
    dev, dt = q.device, q.dtype
    dq, dk, dv = (torch.zeros(x.shape, dtype=torch.float64, device=dev)
                  for x in (q, k, v))
    c2, lse2 = float(scale) * LOG2E, lse.float() * LOG2E
    a = 0
    for n in lens:
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            rs, ks = slice(a + r0, a + r1), slice(a, a + r1)
            qf, dof = q[:, rs].float(), do[:, rs].float()
            kf, vf = k[:, ks].float(), v[:, ks].float()
            dead = (torch.arange(r1, device=dev)[None]
                    > torch.arange(r0, r1, device=dev)[:, None])
            p = torch.exp2((qf @ kf.transpose(1, 2)) * c2
                           - lse2[:, rs, None]).masked_fill(dead, 0.0)
            dp = dof @ vf.transpose(1, 2)
            ds = (p * (dp - delta[:, rs, None]) * scale).to(dt).double()
            dv[:, ks] += p.to(dt).double().transpose(1, 2) @ dof.double()
            dk[:, ks] += ds.transpose(1, 2) @ qf.double()
            dq[:, rs] = ds @ kf.double()
            del p, dp, ds
        a += n
    return dq, dk, dv


def _drift_row(got, plain, ref):
    """got's and plain's drift along ref and their excess; ok when
    |excess| <= VARLEN_DRIFT_EXCESS."""
    dk_, dp_ = dw_drift(got, ref), dw_drift(plain, ref)
    return {"kernel": dk_, "plain": dp_, "excess": dk_ - dp_,
            "kernel_frob": ((got.double() - ref).norm() / ref.norm()).item(),
            "plain_frob": ((plain.double() - ref).norm() / ref.norm()).item(),
            "ok": abs(dk_ - dp_) <= VARLEN_DRIFT_EXCESS}


def varlen_drifts(fv, q, k, v, do, lens, heads=VARLEN_DRIFT_HEADS,
                  backward=True):
    """Rows 20-23 on the first ``heads`` heads of a causal self-attention
    pack (packed [T, H, D] inputs; the heads are copied to contiguous
    [heads, T, D]), each kernel and its plain version against an f64
    reference (``varlen_fwd_f64``, ``varlen_bwd_f64``) -> {output:
    ``_drift_row``}: "o" (row 20), and with ``backward`` "fused dq",
    "fused dk", "fused dv" (row 21), "split dq" (row 23), "split dk",
    "split dv" (row 22). The backward takes the plain forward's lse and
    delta."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (x.transpose(0, 1)[:heads].contiguous()
                       for x in (q, k, v, do))
    cu = _cu_dev(lens, q.device)
    o = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)[0]
    o_p, lse = fv.varlen_fwd_plain(qh, kh, vh, cu, cu, True, scale)
    out = {"o": _drift_row(o, o_p, varlen_fwd_f64(qh, kh, vh, lens, scale))}
    del o
    if backward:
        delta = (doh.float() * o_p.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        ref = varlen_bwd_f64(qh, kh, vh, doh, lse, delta, lens, scale)
        plain = fv.varlen_bwd_plain(*args)
        for path, got in (("fused", fv.varlen_bwd(*args)),
                          ("split", (fv.varlen_bwd_dq(*args),
                                     *fv.varlen_bwd_dkv(*args)))):
            for name, a, b, r in zip(("dq", "dk", "dv"), got, plain, ref):
                out[f"{path} {name}"] = _drift_row(a, b, r)
    torch.cuda.synchronize()
    return out


def print_drifts(where, drifts):
    for n, x in drifts.items():
        print(f"varlen {n} {where}, drift against f64: kernel "
              f"{x['kernel']:+.3e}, plain {x['plain']:+.3e}, excess "
              f"{x['excess']:+.3e} (limit {VARLEN_DRIFT_EXCESS:g}) "
              f"{'ok' if x['ok'] else 'FAILED'}; rel frob kernel "
              f"{x['kernel_frob']:.3e}, plain {x['plain_frob']:.3e}")


def check_varlen(dev, errs):
    from paddle_tpu_torch.ops import flash_varlen as fv
    phase("check varlen kernels against their plain versions")
    cases = [(f"short pack H={VARLEN_H} D={VARLEN_D}", torch.bfloat16,
              VARLEN_SHORT, None, VARLEN_H, VARLEN_D, None)]
    cases += [(f"layout {lq}/{lk}", torch.float32, lq, lk, 2, d, SPREAD_SCALE)
              for (lq, lk), d in zip(VARLEN_F32, (64, 128) * 4)]
    cases += [(f"layout {lq}/{lk}", torch.bfloat16, lq, lk, 2, d, None)
              for lq, lk in VARLEN_BF16 for d in (64, 128)]
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
            if dtype == torch.bfloat16 and causal \
                    and (lq, lk) == VARLEN_BF16[-1]:
                fro = res["o"][2]
                print(f"  o rel frob {fro:.3e} (rounding schedule limit "
                      f"{VARLEN_FWD_SCHEDULE_FROB:g})")
                assert fro <= VARLEN_FWD_SCHEDULE_FROB, \
                    f"o off the plain version's rounding schedule: {fro}"
            if dtype == torch.bfloat16:   # one wgmma body, DQ on and off
                assert all(torch.equal(a, b) for a, b in
                           zip(got["fused"][1:], got["split"][1:])), \
                    "fused dK/dV differ from the split pair's"
                print("  fused dk and dv bitwise equal to the split pair's")
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
    """Fused against split at the short pack (bf16 limits; dK and dV
    bitwise), the split outputs and the fused dK/dV bitwise over two runs,
    segment isolation, and GQA at TinyLlama's width through the autograd
    entry against the CPU's plain versions."""
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
    _, fused2, dq2, dkv2 = grads(k, v)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2), "split dQ differs between two runs"
    assert torch.equal(dkv[0], dkv2[0]) and torch.equal(dkv[1], dkv2[1]), \
        "split dK/dV differ between two runs"
    assert torch.equal(fused[1], fused2[1]) and \
        torch.equal(fused[2], fused2[2]), "fused dK/dV differ between two runs"
    assert torch.equal(fused[1], dkv[0]) and torch.equal(fused[2], dkv[1]), \
        "fused dK/dV differ from the split pair's"
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), fused, (dq,) + dkv):
        ok, excess, fro, err = flash_close(a, b, rel, frob)
        worst = max(worst, fro)
        assert ok, f"fused and split {name} disagree: {excess} {fro}"
    print(f"varlen short pack: fused vs split dq, dk, dv within rel {rel:g}"
          f"/frob {frob:g} (worst rel frob {worst:.3e}); split dq, dk and dv "
          f"and fused dk and dv bitwise equal over two runs; fused dk and dv "
          f"bitwise equal to the split pair's")
    del dkv2, fused2
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
    run alone, and a torch.profiler split of one more step
    (after a warm-up step inside its window)."""
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
        runs = iters + 4        # warm-up, sync check, timed, profiled (2)
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
    """fwd+bwd under torch.profiler: device ms of the varlen kernels against
    everything else (the delta reduction, the dQ cast, copies), by class.
    The tracer can miss the launches just after it starts, so the window
    holds a warm-up step, whose events the profiler's schedule drops, and
    counts the second step (read when that step's trace is ready)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: seen.append(
                     _device_ms_by_class(p))) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()
    by_class, top = seen[-1] if seen else ({}, [])
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
    takes them), each output written once. The fused backward is timed at
    the long pack too. Drift (``varlen_drifts``, held to
    ``VARLEN_DRIFT_EXCESS``): rows 20-23 on four heads of the long pack,
    and row 20 on two heads of one 65,536-token segment (where o carried
    in the accumulator shows; at the long pack it hides under the
    limit)."""
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
        calls.append(("varlen_bwd", lambda: fv.varlen_bwd(*args),
                      lambda: fv.varlen_bwd_plain(*args),
                      7 * el + 2 * st, 5, lb, ("dq", "dk", "dv")))
        if name == "long":
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
        del o, args
        if name == "long":
            drifts = varlen_drifts(fv, q, k, v, do, lens)
            out[f"drift[long pack,T={t},H={VARLEN_DRIFT_HEADS},D={d}]"] = \
                drifts
            print_drifts(f"at the long pack ({VARLEN_DRIFT_HEADS} heads)",
                         drifts)
            assert all(x["ok"] for x in drifts.values()), drifts
        del q, k, v, do
        torch.cuda.empty_cache()
    seg = [65536]
    q, k, v, do = _varlen_inputs(dev, torch.bfloat16, seg, None, 2, d,
                                 SEED + 61)
    drifts = varlen_drifts(fv, q, k, v, do, seg, 2, backward=False)
    out[f"drift[one segment,T={seg[0]},H=2,D={d}]"] = drifts
    print_drifts(f"on one {seg[0]}-token segment (2 heads)", drifts)
    assert all(x["ok"] for x in drifts.values()), drifts
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


def serve_7b(dev):
    """The serve phase (bf16 KV), then the serve-int8 phase: the same
    weights and trace with ServeConfig(kv_dtype="int8")."""
    from paddle_tpu_torch import init_llama_params, llama_7b
    phase("serve llama_7b (bf16, 32 layers, random weights)")
    cfg = llama_7b()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"weights made on the card in {time.perf_counter() - t0:.2f} s, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params")
    stats, streams = _serve_run(params, cfg, "auto", dev)
    phase("serve-int8: llama_7b with kv_dtype='int8' (bf16 weights, 32 "
          "layers, the serve phase's trace)")
    stats["int8"], streams8 = _serve_run(params, cfg, "int8", dev)
    same = [i for i in streams if streams[i] == streams8[i]]
    diverge = {i: next(j for j, (a, b) in enumerate(zip(streams[i],
                                                         streams8[i]))
                       if a != b) for i in streams if i not in same}
    stats["int8"]["streams_equal_bf16"] = len(same)
    stats["int8"]["first_divergence"] = diverge
    print(f"int8 streams equal to the bf16 serve phase's: {len(same)} of "
          f"{len(streams)}; first divergent index of the others {diverge} "
          f"(reported, not asserted: int8 KV is not bitwise bf16 KV)")
    stats["ops"] = serve_ops(params, cfg, dev)
    del params
    _release_card()
    print(f"card memory allocated after serve: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return stats


# ---------------------------------------------------------------------------
# serve-ops: the rest of the serving engine on llama_7b (inside serve_7b,
# on its weights)
# ---------------------------------------------------------------------------

# bench.py's prefix-cache trace (bench_serve_prefix_cache, TPU branch)
PC_REQUESTS, PC_RATE, PC_NEW, PC_SYSTEM, PC_TAIL = 24, 12.0, 32, 1024, (16, 96)
PC_SERVE = dict(block_size=128, num_blocks=257, max_batch=8,
                prefill_chunk=256, max_seq_len=2048)
# bench.py's overload trace (bench_serve_overload, TPU branch): deadlines
# on the iteration clock
OV_REQUESTS, OV_NEW, OV_TTFT, OV_TOTAL = 24, 32, 30.0, 120.0
OV_SERVE = dict(block_size=128, num_blocks=33, max_batch=4,
                prefill_chunk=256, max_seq_len=1024, max_queue=16,
                overcommit=8.0)
# the JAX engine's metrics_snapshot() keys, in order, for a config without
# the prefix cache and speculation (tests/test_torch_metrics_registry.py
# holds this list to the JAX engine)
OPS_SNAPSHOT_KEYS = [
    "ttft_seconds", "tpot_seconds", "queue_wait_seconds", "queue_depth",
    "running", "prefilling", "batch_capacity", "pool_utilization",
    "iterations", "preemptions", "finished_requests", "rejected_requests",
    "shed_requests", "failed_requests", "decode_redrives",
    "generated_tokens"]
POISON_TOKEN = 31000


def _release_card():
    """Free the card memory of deleted engines: the write guards and the
    wrappers close over their engine (a reference cycle), so collect
    before the caching allocator returns the memory."""
    gc.collect()
    torch.cuda.empty_cache()


def _divergence(a, b):
    """(rids whose streams are equal, {rid: first divergent index}) over
    the rids both hold."""
    common = [r for r in a if r in b]
    same = [r for r in common if a[r] == b[r]]
    first = {r: next((j for j, (x, y) in enumerate(zip(a[r], b[r]))
                      if x != y), min(len(a[r]), len(b[r])))
             for r in common if r not in same}
    return same, first


def _guard_writes(eng):
    """Hold every position a decode step or a verify commit is about to
    write to a block of reference count 1 (no write into a block another
    sequence shares); returns the list whose length counts the held
    writes."""
    held, grow = [], eng._grow_rows
    bs = eng.pool.block_size

    def guarded(window):
        rows, caps = grow(window)
        for s in rows:
            for pos in range(s.n_cached, s.n_cached + caps[s.req.request_id]):
                b = s.blocks[pos // bs]
                assert eng.pool.ref_count(b) == 1, \
                    f"request {s.req.request_id} writes shared block {b}"
                held.append(b)
        return rows, caps
    eng._grow_rows = guarded
    return held


def _ops_run(name, eng, reqs, cfg, deterministic=True, expect_fail=None):
    """One run of ``eng`` with the kernel counts set to 0 just before it
    and read just after: the decode kernel of its KV dtype (rows 3 or 5)
    and RMSNorm (row 1) launched, nothing else. Returns (stats or the
    exception, launches, wall seconds)."""
    decode = ("paged_attend_update_quant" if eng.kv_dtype == "int8"
              else "paged_attend_update")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        stats = eng.run(reqs, deterministic=deterministic)
    except Exception as e:  # noqa: BLE001 -- the crash run's fault
        if expect_fail is None or not isinstance(e, expect_fail):
            raise
        stats = e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ran = {k: n for k, n in launches.items() if n}
    assert ran.get(decode, 0) > 0 and ran.get("rms_norm", 0) > 0 and \
        set(ran) <= {decode, "rms_norm"}, (name, ran)
    print(f"  {name}: run {wall:.2f} s, launches {ran}")
    return stats, ran, wall


def _ops_trace(prompts, new, arrivals, **kw):
    from paddle_tpu_torch import Request
    return [Request(list(p), max_new_tokens=new, arrival=float(a),
                    request_id=i, **kw)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def _serve_prompts(cfg, n):
    """The serve phase's first n prompts (_serve_run's trace)."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, 1025, size=16)
    rng.exponential(0.25, size=16)
    return [rng.randint(1, cfg.vocab_size, size=int(m)).tolist()
            for m in lens][:n]


def serve_ops(params, cfg, dev):
    """The serve-ops phase: dead columns, quarantine, the prefix cache,
    overload, crash and recovery, a live weight swap and telemetry, each
    a run (or runs) of InferenceEngine on llama_7b's weights."""
    phase("serve-ops: dead columns, quarantine, prefix cache, overload, "
          "crash and recover, swap, telemetry (llama_7b, bf16, 32 layers)")
    t_phase = time.perf_counter()
    out = {"dead_columns": ops_dead_columns(params, cfg, dev),
           "quarantine": ops_quarantine(params, cfg, dev),
           "prefix_cache": ops_prefix_cache(params, cfg, dev)}
    out["overload"] = ops_overload(params, cfg, dev)
    out["crash"] = ops_crash(params, cfg, dev)
    out["swap"], out["telemetry"] = ops_swap_telemetry(params, cfg, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve-ops phase {out['phase_s']:.1f} s")
    return out


def ops_dead_columns(params, cfg, dev):
    """8 requests (the serve trace's first 8 prompts), 16 new tokens, in
    bf16 and int8 KV: pools (int8: scale pools, codes random) filled with
    NaN before the run against zero-filled pools. Streams must be bitwise
    identical: no dead column reaches a product."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    phase("serve-ops / dead columns: NaN-filled pools against zero pools")
    prompts = _serve_prompts(cfg, 8)
    res = {}
    for kv in ("auto", "int8"):
        streams = []
        for fill in ("zero", "nan"):
            eng = InferenceEngine(params, cfg, ServeConfig(
                block_size=128, num_blocks=65, max_batch=8,
                prefill_chunk=256, max_seq_len=2048, kv_dtype=kv),
                device=dev)
            if fill == "nan":
                if kv == "int8":
                    for t in (eng.k_pool, eng.v_pool):
                        t.copy_(torch.randint_like(t, -127, 128))
                    eng.k_scale.fill_(float("nan"))
                    eng.v_scale.fill_(float("nan"))
                else:
                    eng.k_pool.fill_(float("nan"))
                    eng.v_pool.fill_(float("nan"))
            stats, _, _ = _ops_run(f"{kv} {fill}", eng, _ops_trace(
                prompts, 16, range(8)), cfg)
            assert stats["requests"] == 8 and stats["failed"] == 0, stats
            assert eng.pool.used_blocks == 0, "pool leaked blocks"
            streams.append({s.req.request_id: s.tokens
                            for s in eng.finished})
            del eng
            _release_card()
        assert streams[0] == streams[1], f"{kv}: NaN dead columns moved a " \
                                         f"stream"
        res[kv] = {"streams_bitwise_equal": True, "requests": 8}
        print(f"  {kv}: 8 streams bitwise identical over NaN-filled and "
              f"zero-filled pools")
    return res


def ops_quarantine(params, cfg, dev):
    """A genuine poison: token POISON_TOKEN's embedding row set to NaN
    (saved and restored). 8 requests through 2 rows of a 9-block pool,
    the first a 100-token prompt holding the token (its chunk's padding
    columns carry NaN into null block 0 from layer 1 on, its freed blocks
    are handed on uncleared). It must fail with 'non-finite prefill
    logits' and every other request finish (finite logits: the NaN screen
    quarantines nothing else), on reused blocks; streams of the others
    reported against a run without it."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    phase("serve-ops / quarantine: one request holding a NaN embedding "
          "row, 7 clean ones on its reused blocks")
    rng = np.random.RandomState(SEED + 21)
    prompts = [rng.randint(1, cfg.vocab_size, size=int(n)).tolist()
               for n in [100] + list(rng.randint(150, 400, size=7))]
    prompts = [[t if t != POISON_TOKEN else t + 1 for t in p]
               for p in prompts]
    prompts[0][40] = POISON_TOKEN
    serve = ServeConfig(block_size=128, num_blocks=9, max_batch=2,
                        prefill_chunk=256, max_seq_len=1024, max_queue=16,
                        overcommit=16.0)
    saved = params["embed"][POISON_TOKEN].clone()
    params["embed"][POISON_TOKEN] = float("nan")
    try:
        eng = InferenceEngine(params, cfg, serve, device=dev)
        freed, reused = [], []
        quarantine, alloc = eng._quarantine, eng.pool.alloc

        def q(seq, cause):
            freed.extend(seq.blocks)
            quarantine(seq, cause)

        def a(n):
            got = alloc(n)
            reused.extend(b for b in (got or ()) if b in freed)
            return got
        eng._quarantine, eng.pool.alloc = q, a
        stats, _, _ = _ops_run("with the poisoned request", eng,
                               _ops_trace(prompts, 16, range(8)), cfg)
        failed = [(s.req.request_id, s.fail_cause) for s in eng.failed]
        assert failed == [(0, "non-finite prefill logits")], failed
        assert stats["requests"] == 7 and eng.pool.used_blocks == 0, stats
        assert reused, "no later request reused the poisoned blocks"
        got = {s.req.request_id: s.tokens for s in eng.finished}
        del eng
        clean = InferenceEngine(params, cfg, serve, device=dev)
        _ops_run("without it", clean, [r for r in _ops_trace(
            prompts, 16, range(8)) if r.request_id], cfg)
        want = {s.req.request_id: s.tokens for s in clean.finished}
        del clean
    finally:
        params["embed"][POISON_TOKEN] = saved
    _release_card()
    same, first = _divergence(got, want)
    print(f"  request 0 failed: {failed[0][1]}; the other 7 finished on "
          f"{len(set(reused))} reused blocks of its {len(set(freed))}; "
          f"streams equal to the run without it: {len(same)} of 7, first "
          f"divergent index of the others {first}")
    return {"failed": failed, "finished": len(got),
            "reused_blocks": len(set(reused)),
            "streams_equal_without_poison": len(same),
            "first_divergence": first}


def _pc_trace(cfg):
    rng = np.random.RandomState(16)
    system = rng.randint(1, cfg.vocab_size, size=PC_SYSTEM).tolist()
    prompts = []
    for i in range(PC_REQUESTS):
        if rng.rand() < 0.8 or i == 0:   # 80% share the system prompt
            prompts.append(system + rng.randint(
                1, cfg.vocab_size, size=rng.randint(*PC_TAIL)).tolist())
        else:
            prompts.append(rng.randint(
                1, cfg.vocab_size,
                size=rng.randint(PC_SYSTEM // 4, PC_SYSTEM // 2)).tolist())
    return prompts, np.cumsum(rng.exponential(1.0 / PC_RATE,
                                              size=PC_REQUESTS))


def ops_prefix_cache(params, cfg, dev):
    """bench.py's prefix-cache trace: cache off and on in wall mode, then
    in deterministic mode. Hits in both cache-on runs, a leak-free pool
    and no decode write into a shared block asserted; hit rate, hit
    tokens, cached blocks, COW copies, TTFT and tokens/s off and on, and
    cached-vs-cold streams reported."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    phase(f"serve-ops / prefix cache: bench.py's trace, {PC_REQUESTS} "
          f"requests, 80% with a {PC_SYSTEM}-token system prompt")
    prompts, arrivals = _pc_trace(cfg)
    res, streams = {}, {}
    for mode in ("wall", "deterministic"):
        det = mode == "deterministic"
        for cache in (False, True):
            eng = InferenceEngine(params, cfg, ServeConfig(
                prefix_cache=cache, **PC_SERVE), device=dev)
            held = _guard_writes(eng)
            stats, ran, wall = _ops_run(
                f"{mode} cache {'on' if cache else 'off'}", eng, _ops_trace(
                    prompts, PC_NEW, range(PC_REQUESTS) if det
                    else arrivals), cfg, deterministic=det)
            assert stats["requests"] == PC_REQUESTS and \
                stats["unfinished"] == 0, stats
            assert eng.pool.used_blocks == 0, "pool leaked blocks"
            pc = stats["prefix_cache"]
            if cache:
                assert pc["hits"] > 0, pc
                assert eng.pool.cached_blocks == pc["entries"], pc
            key = f"{mode}_{'on' if cache else 'off'}"
            res[key] = {k: stats[k] for k in (
                "iterations", "prefill_chunks", "decode_steps",
                "tokens_per_sec", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "tpot_p99_s", "prefix_cache")}
            res[key].update(run_s=wall, launches=ran,
                            guarded_writes=len(held),
                            tokens_per_s_wall=stats["generated_tokens"] / wall)
            if det:
                streams[cache] = {s.req.request_id: s.generated
                                  for s in eng.finished}
            print(f"  {key}: prefill chunks {stats['prefill_chunks']}, "
                  f"TTFT p50 {stats['ttft_p50_s']} p99 {stats['ttft_p99_s']}"
                  f" ({mode} clock), tokens/s {stats['tokens_per_sec']}, "
                  f"{len(held)} decode writes held to unshared blocks"
                  + (f", hit rate {pc['hit_rate']:.4f} ({pc['hits']} of "
                     f"{pc['lookups']}), hit tokens {pc['hit_tokens']}, "
                     f"cached blocks {eng.pool.cached_blocks}, COW copies "
                     f"{pc['cow_copies']}" if cache else ""))
            del eng
            _release_card()
    same, first = _divergence(streams[True], streams[False])
    res["streams_cached_equal_cold"] = len(same)
    res["first_divergence"] = first
    print(f"  deterministic streams cached vs cold equal: {len(same)} of "
          f"{PC_REQUESTS}; first divergent index of the others {first} "
          f"(a hit prefills from token 1024 in other chunks than a cold "
          f"prefill, so its KV rounds differently on the card)")
    return res


def _ov_trace(cfg, arrivals, deadlines=True, scale=1.0):
    rng = np.random.RandomState(17)
    plens = rng.choice([64, 128, 384], size=OV_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab_size, size=int(n)).tolist()
               for n in plens]
    kw = (dict(ttft_deadline=OV_TTFT * scale, deadline=OV_TOTAL * scale)
          if deadlines else {})
    return _ops_trace(prompts, OV_NEW, arrivals, **kw)


def _journal_path(tag):
    d = os.path.join(ROOT, "chiprun_out", "journals")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{tag}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    return path


def ops_overload(params, cfg, dev):
    """bench.py's overload trace with the journal on: deterministic twice
    (identical shed lists, outcomes and streams; every request in exactly
    one terminal state with a cause; leak-free), then one wall run at
    twice the drain rate, the iteration-clock deadlines rescaled to
    seconds by the measured iteration time."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    phase(f"serve-ops / overload: bench.py's burst, {OV_REQUESTS} "
          f"requests of 64/128/384 tokens, TTFT deadline {OV_TTFT} and "
          f"total {OV_TOTAL} iterations")
    runs = []
    for tag in ("a", "b"):
        eng = InferenceEngine(params, cfg, ServeConfig(**OV_SERVE),
                              journal=_journal_path(f"overload_{tag}"),
                              device=dev)
        stats, ran, wall = _ops_run(f"deterministic {tag}", eng, _ov_trace(
            cfg, range(OV_REQUESTS)), cfg)
        assert eng.pool.used_blocks == 0, "pool leaked blocks"
        runs.append((sorted((s.req.request_id, s.fail_cause)
                            for s in eng.shed), stats["outcomes"],
                     {s.req.request_id: s.tokens for s in eng.finished},
                     stats, wall))
        del eng
    (shed_a, out_a, tok_a, st_a, wall_a), (shed_b, out_b, tok_b, _, _) = runs
    assert (shed_a, out_a, tok_a) == (shed_b, out_b, tok_b), \
        "deterministic overload replays differ"
    assert set(out_a) == set(range(OV_REQUESTS))
    for rid, (state, cause) in out_a.items():
        assert state in ("finished", "shed", "rejected", "failed"), rid
        assert state == "finished" or cause, rid
    pace = wall_a / (2.0 * OV_REQUESTS)
    it_wall = wall_a / max(st_a["iterations"], 1)
    eng = InferenceEngine(params, cfg, ServeConfig(**OV_SERVE),
                          journal=_journal_path("overload_wall"), device=dev)
    st_w, ran, wall = _ops_run("wall, twice the drain rate", eng, _ov_trace(
        cfg, [i * pace for i in range(OV_REQUESTS)], scale=it_wall), cfg,
        deterministic=False)
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    del eng
    _release_card()
    res = {"det_finished": st_a["requests"], "det_shed": st_a["shed"],
           "det_rejected": st_a["rejected"], "det_iterations":
           st_a["iterations"], "det_run_s": wall_a,
           "det_ttft_p99_iterations": st_a["ttft_p99_s"],
           "wall_finished": st_w["requests"], "wall_shed": st_w["shed"],
           "wall_rejected": st_w["rejected"],
           "wall_shed_rate": st_w["shed"] / OV_REQUESTS,
           "goodput_tokens_per_s": st_w["generated_tokens"] / wall,
           "wall_ttft_p99_s": st_w["ttft_p99_s"], "wall_run_s": wall,
           "iteration_s": it_wall}
    print(f"  deterministic (twice, identical): finished {res['det_finished']}"
          f", shed {res['det_shed']}, rejected {res['det_rejected']}, "
          f"{res['det_iterations']} iterations in {wall_a:.2f} s; wall at "
          f"twice the drain rate: finished {res['wall_finished']}, shed "
          f"{res['wall_shed']} (rate {res['wall_shed_rate']:.3f}), rejected "
          f"{res['wall_rejected']}, goodput {res['goodput_tokens_per_s']:.1f}"
          f" tokens/s, TTFT p99 {res['wall_ttft_p99_s']} s")
    return res


def ops_crash(params, cfg, dev):
    """The overload trace's prompts and arrivals (no deadlines, so every
    accepted request must finish) with the journal on: an uncrashed run,
    then a run killed by ``serve.decode.after`` raising at its 3rd hit,
    recover() in a fresh engine and the never-journaled requests
    re-submitted. Every accepted request finishes, every journaled token
    is kept verbatim, the pool is leak-free; the re-derived tokens are
    reported against the uncrashed run."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig, read_journal
    from paddle_tpu_torch.testing import faults
    phase("serve-ops / crash and recover: the overload trace, killed at "
          "the 3rd decode, recovered from its journal")
    eng = InferenceEngine(params, cfg, ServeConfig(**OV_SERVE),
                          journal=_journal_path("crash_ref"), device=dev)
    _ops_run("uncrashed", eng, _ov_trace(cfg, range(OV_REQUESTS), False),
             cfg)
    ref = {s.req.request_id: s.generated for s in eng.finished}
    del eng
    path = _journal_path("crash")
    os.environ[faults.ENV_FAULTS] = "1"
    try:
        eng = InferenceEngine(params, cfg, ServeConfig(**OV_SERVE),
                              journal=path, device=dev)
        with faults.scope("serve.decode.after", "raise", nth=3) as plan:
            err, _, _ = _ops_run("killed", eng, _ov_trace(
                cfg, range(OV_REQUESTS), False), cfg,
                expect_fail=faults.FaultError)
        assert plan.fired == 1 and isinstance(err, faults.FaultError), err
        assert eng.pool.used_blocks == 0, "the crash leaked blocks"
        del eng, err           # the traceback holds the engine's frames
    finally:
        del os.environ[faults.ENV_FAULTS]
    mid = read_journal(path)
    eng = InferenceEngine(params, cfg, ServeConfig(**OV_SERVE), journal=path,
                          device=dev)
    rec = eng.recover()
    journaled = {s.req.request_id for s in eng.waiting + eng.finished}
    rest = [r for r in _ov_trace(cfg, range(OV_REQUESTS), False)
            if r.request_id not in journaled]
    stats, _, _ = _ops_run("recovered", eng, rest, cfg)
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    got = {s.req.request_id: s.generated for s in eng.finished}
    for rid, (state, cause) in stats["outcomes"].items():
        assert state in ("finished", "rejected"), (rid, state, cause)
    assert set(mid.requests) <= set(got), "a journaled request was lost"
    for rid, toks in mid.tokens.items():
        assert got[rid][:len(toks)] == toks, f"journaled tokens of {rid} " \
                                             f"were not kept"
    del eng
    _release_card()
    same, first = _divergence(got, ref)
    n_kept = sum(len(t) for t in mid.tokens.values())
    print(f"  recovered {rec['recovered']} requests ({rec['replayed']} "
          f"re-driven), {len(rest)} re-submitted, {n_kept} journaled tokens "
          f"kept verbatim; finished {len(got)}; streams equal to the "
          f"uncrashed run {len(same)} of {len(set(got) & set(ref))}, first "
          f"divergent index of the others {first} (a re-prefill rounds KV "
          f"differently from decode on the card)")
    return {"recover": rec, "resubmitted": len(rest), "finished": len(got),
            "journaled_tokens_kept": n_kept,
            "streams_equal_uncrashed": len(same),
            "first_divergence": first}


def ops_swap_telemetry(params, cfg, dev):
    """The serve trace's first 8 requests (64 new tokens, deterministic):
    a plain run, a run with ``swap_weights`` of a copy of the same tree at
    iteration 5 (streams bitwise equal to the plain run), and a run with
    StepMetrics, RequestTracer and FlightRecorder on (streams equal,
    metrics_snapshot() keys in the JAX engine's order, a trace for every
    request). Returns (swap results, telemetry results)."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    from paddle_tpu_torch.observability import StepMetrics
    phase("serve-ops / swap and telemetry: the serve trace's first 8 "
          "requests")
    serve = ServeConfig(block_size=128, num_blocks=129, max_batch=8,
                        prefill_chunk=256, max_seq_len=2048)
    prompts = _serve_prompts(cfg, 8)
    streams, tps, swap = {}, {}, None
    for kind in ("plain", "swap", "telemetry"):
        kw = (dict(telemetry=StepMetrics(name="serve"), trace_requests=True,
                   flight_recorder=True) if kind == "telemetry" else {})
        eng = InferenceEngine(params, cfg, serve, device=dev, **kw)
        if kind == "swap":
            copy = {k: ({kk: vv.clone() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for k, v in params.items()}
            assert eng.swap_weights(copy, at_iteration=5) == \
                {"scheduled_at": 5}
        stats, ran, wall = _ops_run(kind, eng, _ops_trace(prompts, 64,
                                                          range(8)), cfg)
        assert stats["requests"] == 8 and eng.pool.used_blocks == 0, stats
        streams[kind] = {s.req.request_id: s.tokens for s in eng.finished}
        tps[kind] = stats["generated_tokens"] / wall
        if kind == "swap":
            assert stats["weight_swaps"] == 1
            swap = dict(eng.last_swap, streams_bitwise_equal=(
                streams["swap"] == streams["plain"]))
            # the engine's swap_ms is host time: its copies are queued.
            # Time one immediate swap to the device's end too
            nbytes = sum(t.numel() * t.element_size() for t in _leaves(copy))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            eng.swap_weights(copy)
            ev[1].record()
            torch.cuda.synchronize()
            swap.update(swap_device_ms=ev[0].elapsed_time(ev[1]),
                        swap_bytes=nbytes,
                        swap_bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3)
            del copy
            assert swap["streams_bitwise_equal"], "the swap moved a stream"
            print(f"  swap of {swap['n_leaves']} leaves at iteration "
                  f"{swap['iteration']} ({swap['in_flight_running']} "
                  f"running, {swap['in_flight_prefill']} prefilling): "
                  f"{swap['swap_ms']:.2f} ms host (the copies queued); "
                  f"streams bitwise equal to the plain run; a swap timed to "
                  f"the device's end {swap['swap_device_ms']:.2f} ms for "
                  f"{nbytes} bytes (bound {swap['swap_bound_ms']:.2f} ms: "
                  f"each read and written once)")
        if kind != "telemetry":
            del eng
            _release_card()
    assert streams["telemetry"] == streams["plain"], "telemetry moved a " \
                                                     "stream"
    snap = eng.metrics_snapshot()
    assert list(snap) == OPS_SNAPSHOT_KEYS, list(snap)
    assert eng.tracer.request_ids() == list(range(8))
    assert eng.tracer.span_count("finish") == 8
    prom = eng.render_prometheus().splitlines()
    summ = eng.metrics.summary()
    tele = {"snapshot": {k: (v.snapshot() if hasattr(v, "snapshot") else v)
                         for k, v in snap.items()},
            "prometheus_head": prom[:14], "prometheus_lines": len(prom),
            "spans": eng.tracer.span_count(),
            "recorder_records": len(eng.recorder.ring),
            "step_metrics": {k: summ[k] for k in (
                "steps", "step_time_ms_mean", "step_time_ms_p50",
                "step_time_ms_p99", "mem_peak_bytes_in_use") if k in summ},
            "tokens_per_s_off": tps["plain"],
            "tokens_per_s_on": tps["telemetry"]}
    del eng
    _release_card()
    print(f"  telemetry on: streams equal, snapshot keys in the JAX order, "
          f"{tele['spans']} spans over 8 request traces, "
          f"{tele['recorder_records']} recorder records; tokens/s off "
          f"{tps['plain']:.1f}, on {tps['telemetry']:.1f}")
    print("  render_prometheus() head:")
    for line in prom[:14]:
        print(f"    {line}")
    return swap, tele


def _serve_requests(cfg):
    """The serve trace: 16 requests, prompts of 128-1024 tokens, 64 new
    tokens, Poisson gaps of 0.25 s."""
    from paddle_tpu_torch import Request
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, 1025, size=16)
    arrivals = np.cumsum(rng.exponential(0.25, size=16)) - 0.25
    return [Request(rng.randint(1, cfg.vocab_size, size=int(n)).tolist(),
                    max_new_tokens=64, arrival=float(max(a, 0.0)),
                    request_id=i)
            for i, (n, a) in enumerate(zip(lens, arrivals))]


def _serve_warm_up(params, cfg, kv_dtype, dev):
    """A warm-up on a small pool: cuBLAS handles, allocator, kernel
    loads."""
    from paddle_tpu_torch import InferenceEngine, Request, ServeConfig
    warm = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=9, max_batch=2, prefill_chunk=256,
        max_seq_len=1024, kv_dtype=kv_dtype), device=dev)
    warm.run([Request(list(range(1, 200)), max_new_tokens=3)])
    del warm
    torch.cuda.empty_cache()


def _serve_run(params, cfg, kv_dtype, dev):
    """The serve trace (16 requests, prompts of 128-1024 tokens, 64 new
    tokens, Poisson gaps of 0.25 s) on ServeConfig(block_size=128,
    num_blocks=129, max_batch=8, prefill_chunk=256, max_seq_len=2048,
    kv_dtype=kv_dtype) after a warm-up on a small pool; launches counted
    from the run alone; then the profile of one decode step and one
    prefill chunk. Returns (stats, streams by request id)."""
    from paddle_tpu_torch import InferenceEngine, ServeConfig
    serve = ServeConfig(block_size=128, num_blocks=129, max_batch=8,
                        prefill_chunk=256, max_seq_len=2048,
                        kv_dtype=kv_dtype)
    reqs = _serve_requests(cfg)
    _serve_warm_up(params, cfg, kv_dtype, dev)
    eng = InferenceEngine(params, cfg, serve, device=dev)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    stats = eng.run(reqs)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
    L = cfg.num_hidden_layers
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        eng.k_pool, eng.v_pool) + ((eng.k_scale, eng.v_scale)
                                   if eng.k_scale is not None else ()))
    bf16_bytes = 2 * eng.k_pool.numel() * 2
    print(f"requests {stats['requests']}  generated {stats['generated_tokens']}"
          f"  iterations {stats['iterations']}  decode steps {steps}  "
          f"prefill chunks {chunks}  preemptions {stats['preemptions']}")
    print(f"tokens/s {stats['tokens_per_sec']}")
    print(f"TTFT p50 {stats['ttft_p50_s']} s  p99 {stats['ttft_p99_s']} s")
    print(f"TPOT p50 {stats['tpot_p50_s']} s  p99 {stats['tpot_p99_s']} s")
    print(f"decode step mean {stats['decode_step_ms_mean']} ms  "
          f"prefill chunk mean {stats['prefill_chunk_ms_mean']} ms")
    print(f"KV pools ({kv_dtype}, scale pools included) {pool_bytes} bytes "
          f"= {pool_bytes / bf16_bytes:.4f} x the bf16 pools' {bf16_bytes}")
    decode = ("paged_attend_update_quant" if kv_dtype == "int8"
              else "paged_attend_update")
    print(f"launches {launches}  ({decode} = {L} x {steps} decode steps; "
          f"rms = {2 * L + 1} x ({steps} + {chunks}))  peak mem {peak:.2f} GiB")
    assert stats["requests"] == 16 and stats["unfinished"] == 0
    assert all(len(s.generated) == 64 for s in eng.finished)
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    assert stats["kv_dtype"] == kv_dtype
    assert launches[decode] == L * steps > 0
    assert all(n == 0 for k, n in launches.items()
               if k not in (decode, "rms_norm")), launches
    assert launches["rms_norm"] == (2 * L + 1) * (steps + chunks)
    stats["launches"] = launches
    stats["peak_mem_gib"] = peak
    stats["kv_pool_bytes"] = pool_bytes
    stats["kv_pool_bytes_bf16"] = bf16_bytes
    stats["profile"] = profile_steps(eng, cfg, dev)
    streams = {s.req.request_id: s.generated for s in eng.finished}
    del eng
    torch.cuda.empty_cache()
    return stats, streams


# the serve-spec phase: bench.py's bench_serve_speculative TPU branch
SPEC_K, SPEC_REQUESTS, SPEC_RATE, SPEC_NEW, SPEC_SYSTEM = 4, 24, 12.0, 32, 512
SPEC_TAIL = (16, 96)
SPEC_DAMP = 0.05
# verify logits against sequential decode at llama_7b. bf16: logits of
# |x| < 8 carry steps of 2^-5, products over B*T rows and over B rows round
# a random share of every layer's outputs one bf16 step apart, the fed
# tokens' P stays f32 in the verify step where row 3's kernel rounds it,
# and 32 layers compound that to a few tenths (0.278 at |x| <= 6.38 in
# this phase's first run, over the 0.125 first set here). f32, the same
# weights and prefixes: rounding of 2^-24 per operation leaves ~1e-4. f32
# over int8 pools: the verify quantizes fed columns computed over B*T rows
# and sequential decode over B rows, so f32 rounding between the two puts
# a few codes of layer 0 one quantization step (1/127 of a column's
# absmax) apart; each such step moves the next layers' inputs by far more
# than rounding, so the share of codes apart grows with depth (4.1% of
# all fed codes over 32 layers, up to 2 steps, on an H100) and the logits
# drift as bf16's compounding roundings do: the bf16 limit (4.9e-2
# measured, over the 1e-3 first set for this case). The check holds layer
# 0's fed codes within one step of sequential decode's.
SPEC_LOGIT_ATOL = {torch.bfloat16: 0.5, torch.float32: 1e-3, "int8": 0.5}


def check_verify_vs_sequential(params, cfg, dev):
    """One verify step's logits (the step's own helper) against K+1
    sequential decode steps that feed the same tokens, from copies of one
    pool state: cached prefixes of 1, 127, 128 and 1000 tokens written by
    the prefill chunk. In bf16 and, with the same weights cast, in f32,
    and in f32 over int8 pools (rows 7 and 5: both read the same
    dequantized values with P in f32): logits within SPEC_LOGIT_ATOL
    everywhere; the greedy token equal wherever the sequential top-2
    margin exceeds twice that."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    phase(f"check one verify step against {SPEC_K + 1} sequential decode "
          f"steps (llama_7b, bf16, f32 and f32 over int8 pools)")
    qstart, T, bs = [1, 127, 128, 1000], SPEC_K + 1, 128
    need = [-(-(q + T) // bs) for q in qstart]
    tables = np.zeros((len(qstart), max(need)), np.int32)
    at = 1
    for i, n in enumerate(need):
        tables[i, :n] = np.arange(at, at + n)
        at += n
    tables = torch.from_numpy(tables).to(dev)
    rng = np.random.RandomState(SEED + 6)
    prompts = [rng.randint(1, cfg.vocab_size, size=q) for q in qstart]
    fed = torch.from_numpy(rng.randint(1, cfg.vocab_size,
                                       size=(len(qstart), T))
                           .astype(np.int32)).to(dev)
    qs = torch.tensor(qstart, dtype=torch.int32, device=dev)
    out = {}
    for dtype, kv_dtype in ((torch.bfloat16, "auto"),
                            (torch.float32, "auto"), (torch.float32, "int8")):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = params if dtype == cfg.dtype else _to_device(params, dtype)
        kp, vp = tl.init_paged_kv_pool(c, 1 + sum(need), bs, kv_dtype,
                                       device=dev)
        sc = (tl.init_paged_kv_scales(c, 1 + sum(need), bs, device=dev)
              if kv_dtype == "int8" else None)
        for i, toks in enumerate(prompts):
            for start in range(0, len(toks), 256):
                ids = np.zeros((256,), np.int32)
                n = min(256, len(toks) - start)
                ids[:n] = toks[start:start + n]
                tl.llama_paged_prefill_chunk(p, kp, vp, tables[i], start,
                                             torch.from_numpy(ids).to(dev),
                                             n, c, kv_scales=sc)
        kp2, vp2 = kp.clone(), vp.clone()
        sc2 = sc and tuple(t.clone() for t in sc)
        with torch.no_grad():
            got, *cols = tl._verify_logits(p, kp, vp, tables, qs, fed, c, sc)
        want = torch.stack([tl.llama_paged_decode_step(
            p, kp2, vp2, tables, qs + j, fed[:, j].contiguous(), c,
            kv_scales=sc2)[0] for j in range(T)], dim=1)
        tol = SPEC_LOGIT_ATOL["int8" if sc else dtype]
        flips = None
        if sc:
            # the fed columns' codes against those sequential decode wrote
            pos = qs[:, None].long() + torch.arange(T, device=dev)
            blk = tables.long().gather(1, pos // bs)
            # advanced indices split by slices lead: [B, T, L, KVD]
            diff = torch.stack([(cols[i].int() - pool[:, blk, :, pos % bs]
                                 .permute(2, 0, 1, 3).int()).abs()
                                for i, pool in ((0, kp2), (1, vp2))])
            per_layer = (diff > 0).sum(dim=(0, 2, 3, 4))
            flips = (int(per_layer.sum()), diff.numel(), int(diff.max()),
                     int(diff[:, 0].max()), per_layer.tolist())
        err = (got - want).abs().max().item()
        top2 = want.topk(2, dim=-1).values
        gate = (top2[..., 0] - top2[..., 1]) > 2 * tol
        same = got.argmax(-1) == want.argmax(-1)
        res = {"max_abs_err": err, "tol": tol, "positions": same.numel(),
               "gated": int(gate.sum()), "gated_same": int(same[gate].sum()),
               "all_same": int(same.sum()), "code_flips": flips,
               "logit_absmax": want.abs().max().item()}
        name = str(dtype)[6:] + ("_int8_kv" if sc else "")
        out[name] = res
        print(f"{name}: verify vs sequential, qstart {qstart}, "
              f"T={T}: logits max_abs_err {err:.3e} (tol {tol}, |logit| up "
              f"to {res['logit_absmax']:.2f}); greedy tokens equal at "
              f"{res['all_same']}/{res['positions']} positions, at "
              f"{res['gated_same']}/{res['gated']} with a top-2 margin > "
              f"{2 * tol}" + ("" if flips is None else
                               f"; fed codes apart from sequential "
                               f"decode's: {flips[0]} of {flips[1]} (max "
                               f"{flips[2]} steps; layer 0 max "
                               f"{flips[3]}), by layer {flips[4]}"))
        assert flips is None or flips[3] <= 1, "layer 0's fed codes disagree"
        assert bool(torch.isfinite(got).all()), "verify logits not finite"
        assert err <= tol, "verify logits disagree with sequential"
        assert res["gated_same"] == res["gated"], "greedy tokens disagree"
        del kp, vp, kp2, vp2, p, sc, sc2
        torch.cuda.empty_cache()
    return out


def serve_spec(dev):
    """Speculative serving on llama_7b (bf16, 32 layers, seeded random
    weights with o_proj and down_proj scaled by SPEC_DAMP, so that the
    default 1-layer draft tracks the base), bench.py's speculative trace:
    24 requests of a 512-token shared system prompt and a 16-95 token tail
    (RandomState(18)), 32 new tokens each, Poisson arrivals at 12/s. A
    small warm-up, then speculation off and on in deterministic mode
    (arrival = iteration) and in wall mode; each run's launches are
    counted from the run alone."""
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params, llama_7b)
    phase(f"serve llama_7b with speculation (bf16, 32 layers, draft_k "
          f"{SPEC_K}, 1-layer draft)")
    cfg = llama_7b()
    L = cfg.num_hidden_layers
    params = init_llama_params(cfg, seed=SEED, device=dev)
    for name in ("o_proj", "down_proj"):
        params["layers"][name].mul_(SPEC_DAMP)
    out = {"verify_vs_sequential": check_verify_vs_sequential(params, cfg,
                                                              dev)}
    rng = np.random.RandomState(18)
    system = rng.randint(1, cfg.vocab_size, size=SPEC_SYSTEM).tolist()
    prompts = [system + rng.randint(1, cfg.vocab_size,
                                    size=rng.randint(*SPEC_TAIL)).tolist()
               for _ in range(SPEC_REQUESTS)]
    arrivals = np.cumsum(rng.exponential(1.0 / SPEC_RATE, size=SPEC_REQUESTS))
    serve_kw = dict(block_size=128, num_blocks=257, max_batch=8,
                    prefill_chunk=256, max_seq_len=2048, draft_k=SPEC_K)
    for spec, kv in ((False, "auto"), (True, "auto"), (True, "int8")):
        warm = InferenceEngine(params, cfg, ServeConfig(
            speculative=spec, kv_dtype=kv,
            **dict(serve_kw, num_blocks=17)), device=dev)
        warm.run([Request(prompts[0], max_new_tokens=6)])
        del warm
    torch.cuda.empty_cache()
    out["runs"], streams, eng = {}, {}, None
    # the int8 runs (serve-spec-int8) skip speculation off to keep the
    # script inside its time limit
    runs = [(mode, spec, "auto") for mode in ("deterministic", "wall")
            for spec in (False, True)]
    runs += [(mode, True, "int8") for mode in ("deterministic", "wall")]
    for mode, spec, kv in runs:
        det = mode == "deterministic"
        if (mode, spec, kv) == ("deterministic", True, "int8"):
            out["profile"] = profile_verify(eng, cfg, dev)
            phase("serve-spec-int8: the serve-spec trace and weights "
                  "with kv_dtype='int8', speculation on")
        del eng
        torch.cuda.empty_cache()
        eng = InferenceEngine(params, cfg, ServeConfig(
            speculative=spec, kv_dtype=kv, **serve_kw), device=dev)
        reqs = [Request(list(p), max_new_tokens=SPEC_NEW,
                        arrival=float(i) if det else float(t))
                for i, (p, t) in enumerate(zip(prompts, arrivals))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        stats = eng.run(reqs, deterministic=det)
        wall = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = stats["decode_steps"]
        assert stats["requests"] == SPEC_REQUESTS and \
            stats["unfinished"] == 0
        assert all(len(s.generated) == SPEC_NEW for s in eng.finished)
        assert eng.pool.used_blocks == 0, "pool leaked blocks"
        int8 = "_quant" if kv == "int8" else ""
        if spec:
            sp = stats["speculative"]
            path = {f"paged_attention_verify{int8}": L * steps,
                    f"paged_verify_commit{int8}": steps,
                    "paged_attend_update": sp["draft_layers"]
                    * sp["draft_steps"]}
        else:
            path = {"paged_attend_update": L * steps}
        assert all(launches[k] == n > 0 for k, n in path.items()), \
            (path, launches)
        assert all(n == 0 for k, n in launches.items()
                   if k not in path and k != "rms_norm"), launches
        key = (f"{mode}_{'on' if spec else 'off'}"
               f"{'_int8' if kv == 'int8' else ''}")
        r = {k: stats[k] for k in (
            "generated_tokens", "iterations", "decode_steps",
            "prefill_chunks", "preemptions", "tokens_per_sec",
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
            "decode_step_ms_mean", "prefill_chunk_ms_mean",
            "speculative")}
        r.update(tokens_per_iteration=stats["generated_tokens"]
                 / stats["iterations"], run_s=wall, peak_mem_gib=peak,
                 launches=launches)
        out["runs"][key] = r
        if det:
            streams[spec, kv] = {s.req.request_id: s.generated
                                 for s in eng.finished}
        print(f"{key}: iterations {r['iterations']}, decode steps "
              f"{steps}, tokens/iteration {r['tokens_per_iteration']:.3f}"
              f", tokens/s {r['tokens_per_sec']}, TTFT p50 "
              f"{r['ttft_p50_s']} p99 {r['ttft_p99_s']}, TPOT p50 "
              f"{r['tpot_p50_s']} p99 {r['tpot_p99_s']} ({mode} clock), "
              f"{'verify' if spec else 'decode'} step mean "
              f"{r['decode_step_ms_mean']:.3f} ms, run {wall:.2f} s, "
              f"peak mem {peak:.2f} GiB")
        if spec:
            sp = stats["speculative"]
            print(f"  accept rate {sp['accept_rate']:.4f} ({sp['accepted']}"
                  f" of {sp['proposed']} proposed), draft steps "
                  f"{sp['draft_steps']} at {sp['draft_step_ms_mean']:.3f}"
                  f" ms mean")
        print(f"  launches {launches}")
    for (a, b), key in ((((False, "auto"), (True, "auto")), ""),
                        (((True, "auto"), (True, "int8")), "_int8")):
        same = [rid for rid in streams[a]
                if streams[a][rid] == streams[b][rid]]
        diverge = {rid: next(j for j, (x, y) in enumerate(zip(
            streams[a][rid], streams[b][rid])) if x != y)
            for rid in streams[a] if rid not in same}
        out[f"streams_identical{key}"] = len(same)
        out[f"first_divergence{key}"] = diverge
        print(f"deterministic streams identical, {a} and {b} (speculation, "
              f"kv_dtype): {len(same)} of {SPEC_REQUESTS}; first divergent "
              f"index of the others {diverge}")
    out["launches"] = out["runs"]["wall_on"]["launches"]
    out["launches_int8"] = out["runs"]["wall_on_int8"]["launches"]
    out["profile_int8"] = profile_verify(eng, cfg, dev)
    del eng
    torch.cuda.empty_cache()
    out["cache"] = spec_cache_run(params, cfg, dev, prompts, serve_kw,
                                  out["runs"]["deterministic_on"])
    del params
    torch.cuda.empty_cache()
    return out


def spec_cache_run(params, cfg, dev, prompts, serve_kw, base):
    """serve-spec + cache: the serve-spec trace in deterministic mode with
    speculation and the prefix cache on. Hits on the shared 512-token
    system prompt, no verify commit into a shared block (held before each
    write) and a leak-free pool asserted; tokens/s and the accept rate
    reported beside the cache-off speculative run (``base``)."""
    from paddle_tpu_torch import InferenceEngine, Request, ServeConfig
    phase("serve-spec + cache: the serve-spec trace, speculation and the "
          "prefix cache on (deterministic)")
    L = cfg.num_hidden_layers
    eng = InferenceEngine(params, cfg, ServeConfig(
        speculative=True, prefix_cache=True, **serve_kw), device=dev)
    held = _guard_writes(eng)
    reqs = [Request(list(p), max_new_tokens=SPEC_NEW, arrival=float(i))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    stats = eng.run(reqs, deterministic=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in _counts().items() if n}
    steps, sp, pc = (stats["decode_steps"], stats["speculative"],
                     stats["prefix_cache"])
    path = {"paged_attention_verify": L * steps,
            "paged_verify_commit": steps,
            "paged_attend_update": sp["draft_layers"] * sp["draft_steps"]}
    assert all(launches.get(k) == n > 0 for k, n in path.items()) and \
        set(launches) <= set(path) | {"rms_norm"}, (path, launches)
    assert stats["requests"] == SPEC_REQUESTS and stats["unfinished"] == 0
    assert all(len(s.generated) == SPEC_NEW for s in eng.finished)
    assert pc["hits"] > 0, pc
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    res = {k: stats[k] for k in ("iterations", "decode_steps",
                                 "prefill_chunks", "tokens_per_sec",
                                 "ttft_p50_s", "ttft_p99_s", "speculative",
                                 "prefix_cache")}
    res.update(run_s=wall, launches=launches, guarded_writes=len(held),
               tokens_per_s_wall=stats["generated_tokens"] / wall,
               cache_off_tokens_per_s_wall=base["generated_tokens"]
               / base["run_s"],
               cache_off_accept_rate=base["speculative"]["accept_rate"],
               cache_off_prefill_chunks=base["prefill_chunks"])
    print(f"  hits {pc['hits']} of {pc['lookups']} ({pc['hit_tokens']} "
          f"tokens), COW copies {pc['cow_copies']}, prefill chunks "
          f"{stats['prefill_chunks']} (cache off {base['prefill_chunks']}); "
          f"{len(held)} commit writes held to unshared blocks; tokens/s "
          f"(wall) {res['tokens_per_s_wall']:.1f} against "
          f"{res['cache_off_tokens_per_s_wall']:.1f} cache off; accept rate "
          f"{sp['accept_rate']:.4f} against "
          f"{base['speculative']['accept_rate']:.4f}; run {wall:.2f} s")
    print(f"  launches {launches}")
    del eng
    _release_card()
    return res


def profile_verify(eng, cfg, dev):
    """Where one verify step (8 rows at 600 cached tokens, T = K + 1) of
    the speculative 7B engine spends device time: verify attention, the
    commit, matmuls and the rest, beside its wall time."""
    from paddle_tpu_torch.inference.kv_cache import pad_table
    from paddle_tpu_torch.models.llama import llama_paged_verify_step
    phase(f"profile one verify step (llama_7b, kv_dtype "
          f"{eng.kv_dtype})")
    T = SPEC_K + 1
    rows = [eng.pool.alloc(5) for _ in range(8)]
    tables = torch.from_numpy(np.stack(
        [pad_table(r, eng.serve.max_nb) for r in rows])).to(dev)
    qstart = torch.full((8,), 600, dtype=torch.int32, device=dev)
    t_live = torch.full((8,), T, dtype=torch.int32, device=dev)
    fed = torch.ones((8, T), dtype=torch.int32, device=dev)

    sc = (None if eng.k_scale is None else (eng.k_scale, eng.v_scale))

    def step():
        out, clen, fin = llama_paged_verify_step(
            eng.params, eng.k_pool, eng.v_pool, tables, qstart, t_live, fed,
            cfg, kv_scales=sc)[:3]
        return torch.cat([out.flatten(), clen, fin.int()]).cpu()
    res = _profile_one("verify_step", step)
    for r in rows:
        eng.pool.free(r)
    return res


PAGED_KERNELS = ("paged_attend_update", "paged_attention_verify",
                 "paged_verify_commit", "paged_attend_update_quant",
                 "paged_attention_quant", "paged_attention_verify_quant",
                 "paged_verify_commit_quant")


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
    for name in PAGED_KERNELS:
        getattr(pa, name).launches = 0
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0
    pa.paged_attention.launches = 0
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
            **{name: getattr(pa, name).launches for name in PAGED_KERNELS},
            "rms_norm": rn.fused_rms_norm.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "paged_attention": pa.paged_attention.launches,
            "gmm_fwd": tg.gmm_fwd.launches,
            "gmm_dx": tg.gmm_dx.launches,
            "gmm_dw": tg.gmm_dw.launches,
            "decode_attend_update_slab": da.decode_attend_update_slab.launches,
            "decode_attention_slab": da.decode_attention_slab.launches}


def train_batches(vocab, n):
    """The train phase's n seeded [TRAIN_B, TRAIN_S + 1] batches (ids and
    labels shifted by one)."""
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=(TRAIN_B, TRAIN_S + 1)).astype(np.int32)
            for _ in range(n)]


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
    batches = train_batches(cfg.vocab_size, TRAIN_STEPS + 1)
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


# ---------------------------------------------------------------------------
# the rest of single-device training: the remat policies, plain attention,
# chunked cross entropy, llama_13b, ERNIE-MoE under capacity dispatch
# ---------------------------------------------------------------------------

# (remat_policy, use_flash) of the train-policies phase; full first, the
# configuration the others are held to
POLICY_RUNS = [("full", None), ("dots", None), ("save_attn", None),
               ("save_mlp", None), ("offload_attn", None), ("full", False)]
POLICY_STEPS = 2        # timed steps a configuration, after one warm-up
# a policy's loss and gradients are held to full's under the split flash
# backward (rows 17 and 18 sum dQ without atomics, so one configuration
# gives the same bits twice; under row 16 two runs of full differed by
# 6.0e-3 relative Frobenius in one leaf on an NVIDIA H100 80GB HBM3 at
# 700 W): the loss bitwise,
# each leaf's gradient within TRAIN_LOSS_RTOL relative Frobenius. A
# policy changes which values are recomputed, never a value
# the plain attention (use_flash=False) against the flash kernels, both
# bf16, and each against an f32 reference: the same weights cast to f32,
# attention by torch's own SDPA (math backend), independent of both. The
# loss within PLAIN_LOSS_REL of full's; each leaf's gradient within
# PLAIN_GRAD_REL of full's, and its error against the f32 reference at
# most PLAIN_GRAD_RATIO times the flash path's on that leaf. Each limit
# lies between the sound reading and the least that a fault of the plain
# path read (this phase on an NVIDIA H100 80GB HBM3 at 700 W, the plain
# attention's logits scaled by 2 or 1.25, its causal mask one key late,
# or no mask): loss 1.94e-5 against 2.41e-4 to 1.01e-3; the worst leaf
# 5.88e-2 against 0.451 to 3.49; the worst ratio 0.993 against 6.86 to
# 52.7. Every leaf, both paths, lies 2e-2 to 6.6e-2 from f32: bf16's
# rounding over the whole stack, which the two attentions share
PLAIN_LOSS_REL, PLAIN_GRAD_REL, PLAIN_GRAD_RATIO = 2 ** -14, 2 ** -3, 2.5
# chunked against dense cross entropy: dx within one bf16 step; dhead
# within two, since the chunked head gradient is a sum of 8 bf16 partial
# products (each rounded, then added in bf16) where the dense one is one
# product rounded once
CE_ITERS, CE_GRAD_REL = 3, {"dx": 2 ** -8, "dhead": 2 ** -7}
TRAIN13_LAYERS = 12
SERVE13_REQUESTS = 8
# bench.py bench_moe's configuration (bench.py:269-275): B 8, S 512
MOE_BENCH = dict(vocab_size=8192, hidden_size=1024, intermediate_size=4096,
                 num_hidden_layers=8, num_attention_heads=8, num_experts=8,
                 moe_topk=2, capacity_factor=1.25, moe_every=2,
                 max_position_embeddings=512, dtype=torch.bfloat16)
MOE_BENCH_STEPS = 3


def step_launches(L, policy, use_flash=None):
    """Launches of rows 1, 14 and 16 in one Llama train step on L layers
    under remat: the forward runs both norms and one flash forward a layer
    and the final norm; the recompute both norms again and the flash
    forward unless the policy keeps attn_out with its lse; the backward
    one flash backward a layer. use_flash=False launches no flash."""
    flash = use_flash is not False
    keeps = policy in ("save_attn", "save_mlp", "offload_attn")
    return {"rms_norm": (2 * L + 1) + 2 * L,
            "flash_fwd": (L if keeps else 2 * L) if flash else 0,
            "flash_bwd": L if flash else 0}


def _grad_items(tree, prefix=""):
    """(name, [tensors]) of a gradient tree: a stacked leaf's per-layer
    slices together."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _grad_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, (list(v) if isinstance(v, list) else [v])


def _to_host(grads):
    return {n: [t.cpu() for t in ts] for n, ts in _grad_items(grads)}


def grads_rel_leaves(grads, ref_host):
    """{leaf: relative Frobenius error of ``grads`` against ``ref_host``
    (the same leaves on the host)}."""
    out = {}
    for name, ts in _grad_items(grads):
        num = den = 0.0
        for t, r in zip(ts, ref_host[name]):
            r = r.to(t.device).float()
            num += float((t.float() - r).pow(2).sum())
            den += float(r.pow(2).sum())
        out[name] = (num / max(den, 1e-30)) ** 0.5
    return out


def grads_rel(grads, ref_host):
    """The largest relative Frobenius error of a leaf of ``grads`` against
    ``ref_host``, and that leaf."""
    return max((v, k) for k, v in grads_rel_leaves(grads, ref_host).items())


def _sdpa_f32(q, k, v, is_causal=False):
    """The f32 reference's attention, [B, S, H, D] in and out (GQA by
    repeating kv heads): torch's SDPA, math backend, in f32."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[2] // k.shape[2]
    k, v = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v))
    with sdpa_kernel(SDPBackend.MATH):
        o = torch.nn.functional.scaled_dot_product_attention(
            *(t.transpose(1, 2).float() for t in (q, k, v)),
            is_causal=is_causal)
    return o.transpose(1, 2).to(q.dtype)


def f32_reference(cfg, ids, labels, dev):
    """Loss and gradients (on the host) of the configurations' initial
    state in f32: build_train_step's seeded bf16 weights cast to f32,
    full remat, the plain path with its attention swapped for
    :func:`_sdpa_f32`."""
    import dataclasses
    from torch.utils._pytree import tree_map
    from paddle_tpu_torch.models import llama as tl
    params = tree_map(lambda t: t.float(),
                      tl.init_llama_params(cfg, SEED, device=dev))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    plain, tl._xla_sdpa = tl._xla_sdpa, _sdpa_f32
    try:
        loss, grads = tl.llama_loss_and_grads(
            params, ids, labels, cfg32, tl.ParallelConfig(use_flash=False))
    finally:
        tl._xla_sdpa = plain
    out = float(loss), _to_host(grads)
    del params, grads
    torch.cuda.empty_cache()
    return out


def _train_steps(step, params, opt, batches):
    """One warm-up and the timed steps: (params, opt, losses, step ms)."""
    losses, step_ms = [], []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, x[:, :-1], x[:, 1:])
        losses.append(float(loss))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return params, opt, losses, step_ms


def train_policies(dev):
    """build_train_step on the train phase's configuration (llama_7b's
    width, 16 layers, B=4, S=2048, the same seeded weights) under each
    remat policy and with use_flash=False: loss and gradients from the
    initial state on batch 0, under the split flash backward, held to
    full's (full's gradients kept on the host, one set on the card at a
    time), then one warm-up and POLICY_STEPS timed steps with step ms,
    tokens/s, MFU, peak memory and the launches of rows 1, 14 and 16
    asserted to step_launches; offload_attn also the bytes it sends to
    the host a step. Plain attention's loss and gradients are also held,
    leaf by leaf beside the flash path's, to an f32 reference
    (:func:`f32_reference`)."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    phase(f"train-policies: llama_7b width, {TRAIN_LAYERS} layers (bf16, "
          f"B={TRAIN_B}, S={TRAIN_S}) under each remat policy and "
          f"use_flash=False")
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=TRAIN_LAYERS)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
               .astype(np.int32) for _ in range(POLICY_STEPS + 1)]
    ids0 = torch.from_numpy(batches[0][:, :-1]).to(dev)
    labels0 = torch.from_numpy(batches[0][:, 1:]).to(dev)
    flops_tok = tl.train_flops_per_token(cfg, TRAIN_S)
    hd = cfg.head_dim
    nh = cfg.num_attention_heads
    parked = L * TRAIN_B * nh * TRAIN_S * (hd * 2 + 4)   # o bf16, lse f32
    t0 = time.perf_counter()
    ref32 = f32_reference(cfg, ids0, labels0, dev)
    print(f"f32 reference: loss {ref32[0]!r} "
          f"({time.perf_counter() - t0:.1f} s)")
    out, ref = {}, None
    for policy, use_flash in POLICY_RUNS:
        key = policy if use_flash is not False else f"{policy}, use_flash=False"
        par = tl.ParallelConfig(remat_policy=policy, use_flash=use_flash)
        step, params, opt = tl.build_train_step(cfg, par, seed=SEED,
                                                device=dev)
        with _bwd_mode("split"):
            loss, grads = tl.llama_loss_and_grads(params, ids0, labels0,
                                                  cfg, par)
            loss = float(loss)
            r = {"loss": loss}
            if ref is None:
                again, grads2 = tl.llama_loss_and_grads(params, ids0,
                                                        labels0, cfg, par)
                ref = (loss, _to_host(grads))
                flash32 = grads_rel_leaves(grads, ref32[1])
                r["f32"] = {"loss_rel": abs(loss - ref32[0]) / ref32[0],
                            "grad_rel": flash32}
                r["grad_rel"], r["grad_rel_leaf"] = grads_rel(grads2, ref[1])
                assert float(again) == loss, (float(again), loss)
                assert r["grad_rel"] <= TRAIN_LOSS_RTOL, r
                print(f"full against itself: loss bitwise, gradients within "
                      f"{r['grad_rel']:.3e} ({r['grad_rel_leaf']})")
                del grads2
            else:
                r["grad_rel"], r["grad_rel_leaf"] = grads_rel(grads, ref[1])
                r["loss_rel"] = abs(loss - ref[0]) / abs(ref[0])
                if use_flash is False:
                    plain32 = grads_rel_leaves(grads, ref32[1])
                    full = grads_rel_leaves(grads, ref[1])
                    r["f32"] = {"loss_rel": abs(loss - ref32[0]) / ref32[0],
                                "grad_rel": plain32}
                    r["grad_rel_leaves"] = full
                    print(f"{'leaf':<18}{'flash-f32':>11}{'plain-f32':>11}"
                          f"{'ratio':>8}{'plain-flash':>13}   (loss: "
                          f"{out['full']['f32']['loss_rel']:.3e}, "
                          f"{r['f32']['loss_rel']:.3e}, "
                          f"{r['loss_rel']:.3e})")
                    for leaf, e in plain32.items():
                        print(f"{leaf:<18}{flash32[leaf]:>11.3e}{e:>11.3e}"
                              f"{e / flash32[leaf]:>8.3f}{full[leaf]:>13.3e}")
                    assert r["loss_rel"] <= PLAIN_LOSS_REL, r
                    assert r["grad_rel"] <= PLAIN_GRAD_REL, r
                    assert all(e <= PLAIN_GRAD_RATIO * flash32[leaf]
                               for leaf, e in plain32.items()), r
                else:
                    assert loss == ref[0], (key, loss, ref[0])
                    assert r["grad_rel"] <= TRAIN_LOSS_RTOL, r
        del grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        tl.park_on_host.bytes = 0
        params, opt, losses, step_ms = _train_steps(step, params, opt,
                                                    batches)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(batches)
        want = step_launches(L, policy, use_flash)
        assert all(math.isfinite(v) for v in losses), losses
        assert {k: launches[k] for k in want} == \
            {k: v * n for k, v in want.items()}, (key, launches, want)
        host_bytes = tl.park_on_host.bytes / n
        assert host_bytes == (parked if policy == "offload_attn" else 0), \
            (host_bytes, parked)
        ms = float(np.mean(step_ms[1:]))
        tps = TRAIN_B * TRAIN_S / (ms / 1e3)
        r.update(losses=losses, step_ms=step_ms, step_ms_mean=ms,
                 tokens_per_sec=tps, mfu=flops_tok * tps / BF16_OPS_PER_S,
                 peak_mem_gib=peak, launches_per_step={
                     k: launches[k] / n for k in want},
                 host_bytes_per_step=host_bytes)
        out[key] = r
        print(f"{key}: loss {loss!r} (full {ref[0]!r}); gradients within "
              f"{r['grad_rel']:.3e} of full's ({r['grad_rel_leaf']}); "
              f"steps {[round(t, 2) for t in step_ms]} ms; launches a "
              f"step {r['launches_per_step']}; to the host "
              f"{host_bytes:.0f} bytes a step; peak {peak:.2f} GiB")
        del step, params, opt
        torch.cuda.empty_cache()
    print(f"\n{'configuration':<26}{'step ms':>10}{'tokens/s':>11}"
          f"{'MFU':>8}{'peak GiB':>10}{'rms':>6}{'fwd':>5}{'bwd':>5}"
          f"{'host GB':>9}{'grad rel':>11}")
    for key, r in out.items():
        lp = r["launches_per_step"]
        print(f"{key:<26}{r['step_ms_mean']:>10.2f}"
              f"{r['tokens_per_sec']:>11.1f}{r['mfu']:>8.4f}"
              f"{r['peak_mem_gib']:>10.2f}{lp['rms_norm']:>6.0f}"
              f"{lp['flash_fwd']:>5.0f}{lp['flash_bwd']:>5.0f}"
              f"{r['host_bytes_per_step'] / 1e9:>9.3f}"
              f"{r['grad_rel']:>11.3e}")
    return {"layers": L, "batch": TRAIN_B, "seq": TRAIN_S,
            "timed_steps": POLICY_STEPS, "grad_rel_tol": TRAIN_LOSS_RTOL,
            "plain_tol": (PLAIN_LOSS_REL, PLAIN_GRAD_REL, PLAIN_GRAD_RATIO),
            "f32_loss": ref32[0], "runs": out}


def chunked_ce(dev):
    """chunked_ce_loss against masked_ce_loss over dense f32 logits at the
    train shape (B=4, S=2048, H=4096, V=32000; bf16 hidden and head,
    seeded, the last label of each row -100): forward and backward of
    each, the loss (within TRAIN_LOSS_RTOL), the gradients of x and head
    (within CE_GRAD_REL relative Frobenius), ms by CUDA events over
    CE_ITERS calls and the peak memory above the inputs."""
    from paddle_tpu_torch.models import llama as tl
    phase(f"chunked-ce: chunked_ce_loss against the dense f32 loss (B="
          f"{TRAIN_B}, S={TRAIN_S}, H=4096, V=32000, bf16)")
    g = torch.Generator(device=dev).manual_seed(SEED)
    h, v = 4096, 32000
    x = torch.randn((TRAIN_B, TRAIN_S, h), generator=g,
                    device=dev).to(torch.bfloat16)
    head = (torch.randn((h, v), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (TRAIN_B, TRAIN_S), generator=g, device=dev)
    labels[:, -1] = -100
    fns = {"dense": lambda xs, hs: tl.masked_ce_loss((xs @ hs).float(),
                                                     labels),
           "chunked": lambda xs, hs: tl.chunked_ce_loss(xs, hs, labels)}
    out = {}
    for name, fn in fns.items():
        xs = x.detach().requires_grad_()
        hs = head.detach().requires_grad_()

        def run():
            xs.grad = hs.grad = None
            loss = fn(xs, hs)
            loss.backward()
            return loss

        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = float(run().detach())
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(CE_ITERS):
            run()
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "ms": ev[0].elapsed_time(ev[1]) / CE_ITERS,
                     "peak_mem_gib": peak, "dx": xs.grad, "dhead": hs.grad}
    d, c = out["dense"], out["chunked"]
    rel = {k: float((c[k].float() - d[k].float()).norm()
                    / d[k].float().norm()) for k in ("dx", "dhead")}
    loss_rel = abs(c["loss"] - d["loss"]) / abs(d["loss"])
    for name, r in out.items():
        print(f"{name}: loss {r['loss']!r}  fwd+bwd {r['ms']:.3f} ms  peak "
              f"{r['peak_mem_gib']:.3f} GiB above the inputs")
    print(f"chunked against dense: loss rel {loss_rel:.3e} (tol "
          f"{TRAIN_LOSS_RTOL}); gradient rel Frobenius dx {rel['dx']:.3e}, "
          f"dhead {rel['dhead']:.3e} (tol {CE_GRAD_REL})")
    assert loss_rel <= TRAIN_LOSS_RTOL, loss_rel
    assert all(rel[k] <= CE_GRAD_REL[k] for k in rel), rel
    res = {name: {k: r[k] for k in ("loss", "ms", "peak_mem_gib")}
           for name, r in out.items()}
    res.update(loss_rel=loss_rel, grad_rel=rel)
    del out, x, head
    torch.cuda.empty_cache()
    return res


def train_13b(dev):
    """build_train_step on llama_13b's width cut to TRAIN13_LAYERS of 40
    layers (bf16, B=4, S=2048, save_mlp: bench.py's policy at this
    geometry, AdamW f32 moments): one warm-up and two timed steps; the
    launches of rows 1, 14 and 16 asserted."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    full = tl.llama_13b()
    cfg = dataclasses.replace(full, num_hidden_layers=TRAIN13_LAYERS)
    phase(f"train-13b: llama_13b width, {TRAIN13_LAYERS} of "
          f"{full.num_hidden_layers} layers (bf16, B={TRAIN_B}, "
          f"S={TRAIN_S}, save_mlp)")
    par = tl.ParallelConfig(remat_policy="save_mlp")
    t0 = time.perf_counter()
    step, params, opt = tl.build_train_step(cfg, par, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = tl.count_params(cfg)
    print(f"weights and moments made on the card in "
          f"{time.perf_counter() - t0:.2f} s, {n_params / 1e9:.3f} B params,"
          f" {12 * n_params / 1e9:.1f} GB of state (at 40 layers "
          f"{12 * tl.count_params(full) / 1e9:.1f} GB)")
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
               .astype(np.int32) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    params, opt, losses, step_ms = _train_steps(step, params, opt, batches)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = cfg.num_hidden_layers, len(batches)
    want = step_launches(L, "save_mlp")
    assert all(math.isfinite(v) for v in losses), losses
    assert {k: launches[k] for k in want} == \
        {k: v * n for k, v in want.items()}, (launches, want)
    ms = float(np.mean(step_ms[1:]))
    tps = TRAIN_B * TRAIN_S / (ms / 1e3)
    flops_tok = tl.train_flops_per_token(cfg, TRAIN_S)
    mfu = flops_tok * tps / BF16_OPS_PER_S
    print(f"losses {losses}; steps {[round(t, 2) for t in step_ms]} ms "
          f"(first a warm-up); step ms mean {ms:.2f}; tokens/s {tps:.1f}; "
          f"MFU {mfu:.4f}; launches "
          f"{ {k: launches[k] for k in want} } ({n} x {want}); peak "
          f"{peak:.2f} GiB")
    del step, params, opt
    torch.cuda.empty_cache()
    return {"layers": L, "batch": TRAIN_B, "seq": TRAIN_S,
            "params": n_params, "remat_policy": "save_mlp",
            "losses": losses, "step_ms": step_ms, "step_ms_mean": ms,
            "tokens_per_sec": tps, "mfu": mfu,
            "launches": {k: launches[k] for k in want},
            "peak_mem_gib": peak,
            "reduced": f"num_hidden_layers 40 -> {L} (state is 12 bytes a "
                       f"param: 156 GB at 40 layers, 64.8 GB at 16, too "
                       f"tight beside the activations)"}


def serve_13b(dev):
    """InferenceEngine on llama_13b at full width and depth (bf16, 40
    layers, seeded random weights) with the serve phase's ServeConfig and
    the first SERVE13_REQUESTS requests of its trace: every request
    finishes with its 64 tokens, none quarantined (the engine screens
    every row's logits for non-finite values), the pool leak-free, and
    the launches of rows 1 and 3 counted from the run alone."""
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params)
    from paddle_tpu_torch.models import llama as tl
    cfg = tl.llama_13b()
    phase(f"serve-13b: llama_13b (bf16, {cfg.num_hidden_layers} layers, "
          f"random weights), the serve trace's first {SERVE13_REQUESTS} "
          f"requests")
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights made on the card in {time.perf_counter() - t0:.2f} s, "
          f"{n_params / 1e9:.2f} B params, {2 * n_params / 1e9:.1f} GB")
    reqs = _serve_requests(cfg)[:SERVE13_REQUESTS]
    _serve_warm_up(params, cfg, "auto", dev)
    eng = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
        max_seq_len=2048), device=dev)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    stats = eng.run(reqs)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_hidden_layers
    steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
    print(f"requests {stats['requests']}  generated "
          f"{stats['generated_tokens']}  decode steps {steps}  prefill "
          f"chunks {chunks}  failed {stats['failed']}")
    print(f"tokens/s {stats['tokens_per_sec']}  TTFT p50 "
          f"{stats['ttft_p50_s']} s  p99 {stats['ttft_p99_s']} s  decode "
          f"step mean {stats['decode_step_ms_mean']} ms  prefill chunk mean "
          f"{stats['prefill_chunk_ms_mean']} ms")
    print(f"launches paged_attend_update {launches['paged_attend_update']} "
          f"(= {L} x {steps}), rms_norm {launches['rms_norm']} (= "
          f"{2 * L + 1} x ({steps} + {chunks}))  peak mem {peak:.2f} GiB")
    assert stats["requests"] == SERVE13_REQUESTS
    assert stats["unfinished"] == 0 and stats["failed"] == 0, stats
    assert all(len(s.generated) == 64 for s in eng.finished)
    assert eng.pool.used_blocks == 0, "pool leaked blocks"
    assert launches["paged_attend_update"] == L * steps > 0
    assert launches["rms_norm"] == (2 * L + 1) * (steps + chunks)
    assert all(n == 0 for k, n in launches.items()
               if k not in ("paged_attend_update", "rms_norm")), launches
    out = {k: stats[k] for k in (
        "requests", "generated_tokens", "decode_steps", "prefill_chunks",
        "tokens_per_sec", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
        "tpot_p99_s", "decode_step_ms_mean", "prefill_chunk_ms_mean")}
    out.update(params=n_params, launches=launches, peak_mem_gib=peak)
    del eng, params
    _release_card()
    return out


def ernie_capacity(dev):
    """build_train_step on bench.py bench_moe's configuration (MOE_BENCH,
    B=8, S=512): the capacity slot schedule (no dispatch mode named: the
    default, as bench_moe runs it) with with_stats, then the same widths
    under bench_moe_dropless's flags (ragged, multi_precision=False,
    with_stats); one warm-up and MOE_BENCH_STEPS timed steps each, the
    launches counted from each run alone."""
    from paddle_tpu_torch.models import ernie_moe as tm
    cfg = tm.ErnieMoEConfig(**MOE_BENCH)
    phase(f"ernie-capacity: bench_moe's ERNIE-MoE (bf16, 8 layers, E 8 "
          f"top-2, capacity_factor 1.25, B={MOE_B}, S={MOE_S}), capacity "
          f"against dropless")
    assert tm.resolve_dispatch_mode(cfg) == "capacity"
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(MOE_B, MOE_S + 1))
               .astype(np.int32) for _ in range(MOE_BENCH_STEPS + 1)]
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    flops_tok = tm.train_flops_per_token(cfg, MOE_S)
    out = {}
    for name, flags in (("capacity", dict(with_stats=True)),
                        ("dropless", dict(dispatch_mode="ragged",
                                          multi_precision=False,
                                          with_stats=True))):
        step, params, opt = tm.build_train_step(cfg, lr=1e-4, seed=SEED,
                                                device=dev, **flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        losses, step_ms, stats = [], [], []
        for x in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss, st = step(params, opt, x[:, :-1], x[:, 1:])
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            stats.append({k: v.tolist() for k, v in st.items()})
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(batches)
        gmm = 0 if name == "capacity" else 2 * n_moe * n
        assert all(math.isfinite(v) for v in losses), losses
        assert all(launches[k] == gmm for k in ("gmm_fwd", "gmm_dx",
                                                "gmm_dw")), launches
        assert launches["flash_fwd"] == launches["flash_bwd"] == L * n
        assert launches["rms_norm"] == (2 * L + 1) * n, launches
        last = stats[-1]
        assert all(s["moe_routed_tokens"] + s["moe_dropped_tokens"]
                   == MOE_B * MOE_S * cfg.moe_topk * n_moe for s in stats)
        assert ("moe_capacity_util" in last) == (name == "capacity")
        ms = float(np.mean(step_ms[1:]))
        tps = MOE_B * MOE_S / (ms / 1e3)
        mfu = flops_tok * tps / BF16_OPS_PER_S
        shown = {k: v for k, v in last.items() if k != "moe_expert_rows"}
        print(f"{name}: losses {[round(v, 6) for v in losses]}; steps "
              f"{[round(t, 2) for t in step_ms]} ms (first a warm-up); step "
              f"ms mean {ms:.2f}; tokens/s {tps:.1f}; active MFU {mfu:.4f}; "
              f"peak {peak:.2f} GiB; launches gmm {launches['gmm_fwd']}/"
              f"{launches['gmm_dx']}/{launches['gmm_dw']} flash "
              f"{launches['flash_fwd']}/{launches['flash_bwd']} rms "
              f"{launches['rms_norm']}")
        print(f"  routing stats of the last step (summed over {n_moe} MoE "
              f"layers; ratios averaged): {shown}")
        out[name] = {"losses": losses, "step_ms": step_ms,
                     "step_ms_mean": ms, "tokens_per_sec": tps,
                     "active_mfu": mfu, "peak_mem_gib": peak,
                     "routing_stats": stats, "launches": launches}
        del step, params, opt
        torch.cuda.empty_cache()
    out["capacity_over_dropless"] = (out["capacity"]["step_ms_mean"]
                                     / out["dropless"]["step_ms_mean"])
    print(f"capacity step ms / dropless step ms "
          f"{out['capacity_over_dropless']:.3f}")
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
        # a scheduled profile's step range carries its kernels' time again
        if e.device_type != DeviceType.CUDA or e.key == "Command Buffer Full" \
                or e.key.startswith("ProfilerStep"):
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
    if "paged_split_kernel" in name:    # <T, REP, WRITE, MAXT>
        int8 = "_quant" if "<signed char," in name else ""
        return ("paged_attention" if ", false," in name
                else "paged_attend_update") + int8
    if "paged_verify_split_kernel" in name:     # <T, R, MAXT>
        return ("paged_attention_verify_quant" if "<signed char," in name
                else "paged_attention_verify")
    # <W, QUANT>; paged_commit_quant_kernel: an older tree's row 9 (ab_times)
    if "paged_commit_quant_kernel" in name or (
            "paged_commit_kernel" in name and ", true>" in name):
        return "paged_verify_commit_quant"
    if "paged_commit_kernel" in name:
        return "paged_verify_commit"
    if "slab_kernel" in name:
        return "decode_attention"
    if "rms_norm_kernel" in name:
        return "rms_norm"
    if "varlen_fwd_kernel" in name or "varlen_fwd_wg_kernel" in name:
        return "varlen_fwd"
    if "varlen_bwd_kernel" in name or "varlen_bwd_wg_kernel" in name:
        return "varlen_bwd_dkv" if ", false>" in name else "varlen_bwd"
    if "varlen_dq_kernel" in name or "varlen_dq_wg_kernel" in name:
        return "varlen_bwd_dq"
    if "dq_cast_kernel" in name:      # the fused varlen backward's dQ cast
        return "varlen_bwd"
    if "flash_fwd_" in name:          # flash_fwd_kernel, flash_fwd_wg_kernel
        return "flash_fwd"
    if "flash_bwd_dq_" in name:       # flash_bwd_dq_kernel, _wg_kernel
        return "flash_bwd_dq"
    if "flash_bwd_kernel" in name or "flash_bwd_wg_kernel" in name:
        return "flash_bwd_dkv" if ", false>" in name else "flash_bwd"
    if "dq_finalize" in name:
        return "flash_bwd"
    if any(k in name for k in ("gmm_fwd_", "gmm_dx_", "gmm_dw_")):
        return "gmm"                  # gmm_dw_wg_kernel too
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_steps(eng, cfg, dev):
    """Where one decode step (8 rows at 1,000 cached tokens) and one
    256-token prefill chunk (at 768 cached) spend device time on the 7B
    engine's weights and pools (int8 with their scales where the engine
    has them): kernel time by class from torch.profiler,
    beside the step's host-clock wall time measured without the
    profiler. busy = device time / wall."""
    from paddle_tpu_torch.inference.kv_cache import pad_table
    from paddle_tpu_torch.models.llama import (llama_paged_decode_step,
                                               llama_paged_prefill_chunk)
    phase(f"profile one decode step and one prefill chunk (llama_7b, "
          f"kv_dtype {eng.kv_dtype})")
    rows = [eng.pool.alloc(8) for _ in range(8)]
    tables = torch.from_numpy(np.stack(
        [pad_table(r, eng.serve.max_nb) for r in rows])).to(dev)
    positions = torch.full((8,), 1000, dtype=torch.int32, device=dev)
    ids = torch.ones((8,), dtype=torch.int32, device=dev)
    chunk = torch.ones((256,), dtype=torch.int32, device=dev)
    sc = (None if eng.k_scale is None else (eng.k_scale, eng.v_scale))
    steps = {
        "decode_step": lambda: llama_paged_decode_step(
            eng.params, eng.k_pool, eng.v_pool, tables, positions, ids,
            cfg, kv_scales=sc)[0].cpu(),
        "prefill_chunk": lambda: llama_paged_prefill_chunk(
            eng.params, eng.k_pool, eng.v_pool, tables[0], 768, chunk, 256,
            cfg, kv_scales=sc)[0].cpu(),
    }
    out = {name: _profile_one(name, fn) for name, fn in steps.items()}
    for r in rows:
        eng.pool.free(r)
    return out


def _profile_one(name, fn):
    """Device ms by kernel class of one call of ``fn`` (torch.profiler)
    beside its host-clock wall ms (median of 5 calls without the
    profiler); busy = device ms / wall ms. ``fn`` ends in a host copy."""
    from torch.profiler import ProfilerActivity, profile
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
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy": device_ms / wall_ms, "by_class_ms": by_class,
           "top": sorted(top, reverse=True)[:8]}
    print(f"{name}: wall {wall_ms:.3f} ms (median of 5, no profiler), "
          f"device {device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}")
    print(f"  by class (ms): {by_class}")
    for ms, n, key in out["top"]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key}")
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


def _profiled_ms(fn, kernel, iters=20):
    """Device ms per launch of the kernels whose names hold ``kernel``,
    read from torch.profiler over ``iters`` calls of ``fn`` (one launch
    each): a second reading of a kernel's time that no host pacing can
    enter. The mean is taken over the launches the profiler recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / max(n, 1)


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def paged_update_times(dev, nh=32):
    """Row 3 at B=8, NH=NKV=``nh``, HD=128, bf16, row 3's positions
    (3,865 context tokens): the kernel, its plain version, SDPA over the
    context gathered beforehand (the gather and the column write outside
    its time) and the profiler's kernel time."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out = {}
    a = _paged_inputs(nh, nh, PAGED_POSITIONS, SEED + nh, dev)
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
             profiler_ms=_profiled_ms(lambda: pa.paged_attend_update(*call),
                                      "paged_split_kernel"),
             bytes=nbytes, context_tokens=ctx)
    out[f"paged_attend_update[B=8,NH=NKV={nh}]"] = r
    print(f"paged_attend_update B=8 NH=NKV={nh} ctx {ctx} tokens: {r}")
    return out


def times(dev, errs):
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    phase("times (CUDA events; ms = device time per call)")
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    # the launch floor: an empty kernel (torch.cuda._sleep(0)) queued back
    # to back, as row 1 is timed
    floor = _timed(lambda: torch.cuda._sleep(0), 200)
    out["launch_floor"] = floor
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
                          F32_OPS_PER_S), floor_ms=floor["ms"])
        out[f"rms_norm[{n},4096]"] = r
        print(f"rms_norm [{n},4096]: {r} (launch floor {floor['ms']:.6f} "
              f"ms)")
    out["rms_norm_host_ms_per_decode_step"] = rms_host_cost(dev)
    out.update(paged_update_times(dev))
    a = _paged_inputs(32, 32, PAGED_STEP_POSITIONS, SEED + 33, dev)
    b, nh, hd = a["q"].shape
    kvd = a["k_pool"].shape[2]
    # the same kernel at the profiled decode step's even rows
    ctx = sum(p + 1 for p in PAGED_STEP_POSITIONS)
    call = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
            a["tables"], a["positions"], a["layer"])
    nbytes = (b * nh * hd * 2 + 2 * b * kvd * 2 + 2 * ctx * kvd * 2
              + 2 * b * kvd * 2 + b * nh * hd * 4 + a["tables"].numel() * 4
              + b * 4)
    r = dict(_timed(lambda: pa.paged_attend_update(*call), 100),
             **_bound(nbytes, 4 * nh * hd * ctx, BF16_OPS_PER_S),
             bytes=nbytes, context_tokens=ctx)
    out["paged_attend_update[B=8,NH=NKV=32,even rows]"] = r
    print(f"paged_attend_update B=8 NH=NKV=32 rows of 1,001 tokens (the "
          f"profiled decode step's): {r}")
    out.update(paged_read_times(dev))
    out.update(flash_times(dev))
    out.update(split_times(dev))
    out.update(long_times(dev))
    out.update(gmm_times(dev))
    out.update(verify_times(dev))
    out.update(quant_times(dev))
    out.update(commit_times(dev))
    out.update(slab_times(dev))
    out.update(varlen_times(dev, errs))
    return out


# the profiled verify step's rows (profile_verify): 8 rows at 600 cached
# tokens, tables as wide as the serving engine's (max_seq_len 2048 / bs)
VERIFY_STEP_QSTART, VERIFY_STEP_MAX_NB = [600] * 8, 16


def _verify_library(q, pools, tables, qstart, layer, bs, scales=None):
    """SDPA of the T query rows over each row's context gathered (and
    dequantized to bf16 over int8 pools) beforehand, masked past qstart:
    the library yardstick of rows 6 and 7. Returns the call."""
    from paddle_tpu_torch.ops import paged_attention as pa
    b, T, nh, hd = q.shape
    tmax = int(qstart.max())
    nb = -(-tmax // bs)
    rows = tables[:, :nb].long()

    def gather(pool, sc):
        x = pool[layer][rows]
        if sc is not None:
            x = pa.kv_dequant_blocks(x, sc[layer][rows]).to(torch.bfloat16)
        return (x.reshape(b, nb, nh, hd, bs).permute(0, 2, 1, 4, 3)
                .reshape(b, nh, nb * bs, hd)[:, :, :tmax].contiguous())
    kc, vc = (gather(pool, sc) for pool, sc in zip(
        pools, scales or (None, None)))
    mask = (torch.arange(tmax, device=q.device)[None, :]
            < qstart[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()            # [B, NH, T, HD]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kc, vc, attn_mask=mask)


def verify_times(dev, nh=32, even=True):
    """Row 6 at row 3's timing shape with T = 5 fed tokens per row (B=8,
    NH=NKV=32, HD=128, bf16, qstart = row 3's positions + 1: 3,865 cached
    tokens in all), so the two rows compare, and at the profiled verify
    step's even rows (8 x 600 cached tokens, 16-block tables). Bytes: q, K
    and V of the cached tokens, the f32 partials, tables and qstart once.
    Operations: 2 products of 2 HD per (query row, token). Library
    yardstick: SDPA of the T query rows over the context gathered
    beforehand. ``profiler_ms``: torch.profiler's kernel time per launch
    (row 8: ``commit_times``). ``nh``: the heads (NH = NKV); ``even``:
    the even rows too."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out = {}
    T, bs, hd = SPEC_K + 1, 128, 128
    qstart = [p + 1 for p in PAGED_POSITIONS]
    b, kvd = len(qstart), nh * hd
    for key, rows, width, seed in (
            ("", qstart, None, SEED + 61 + 32 - nh),
            (",even rows", VERIFY_STEP_QSTART, VERIFY_STEP_MAX_NB,
             SEED + 63))[:2 if even else 1]:
        a = _verify_inputs(nh, nh, rows, T, seed, dev, hd=hd, max_nb=width)
        ctx = sum(rows)
        nbytes = (b * T * nh * hd * 2 + 2 * ctx * kvd * 2
                  + b * T * nh * (hd + 2) * 4 + a["tables"].numel() * 4
                  + b * 4)
        call = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                a["layer"])
        r = dict(_timed(lambda: pa.paged_attention_verify(*call), 100),
                 profiler_ms=_profiled_ms(
                     lambda: pa.paged_attention_verify(*call),
                     "paged_verify_split_kernel"),
                 plain_ms=_timed(
                     lambda: pa.paged_attention_verify_plain(*call), 10)
                 ["ms"],
                 library_ms=_timed(_verify_library(
                     a["q"], (a["k_pool"], a["v_pool"]), a["tables"],
                     a["qstart"], a["layer"], bs), 50)["ms"],
                 **_bound(nbytes, 4 * T * nh * hd * ctx, BF16_OPS_PER_S),
                 bytes=nbytes, context_tokens=ctx)
        out[f"paged_attention_verify[B=8,T=5,NH=NKV={nh}{key}]"] = r
        print(f"paged_attention_verify B=8 T=5 NH=NKV={nh} ctx {ctx} "
              f"tokens{key.replace(',', ', ')}: {r}")
        del a

    return out


def quant_times(dev, nh=32, even=True):
    """Rows 5 and 4 at row 3's timing shape and row 7 at row 6's (B=8,
    NH=NKV=32, HD=128, bf16 q, int8 pools from kv_quant_columns of bf16
    columns; row 3's positions, so 3,865 context tokens: row 4 reads
    lengths = positions + 1, row 7 qstart = positions + 1 with T = 5), and
    rows 5 and 4 at the profiled decode step's even rows (8 x 1,001
    tokens, 16-block tables) and row 7 at row 6's, with ``profiler_ms``
    (row 9: ``commit_times``). Bytes: q, the int8 K and V of the context
    with their f32 scales, the f32 output (row 7: the partials) and the
    indices once; row 5 adds the new columns read and written with their
    scales. Operations: 2 products of 2 HD per (query row, token) in f32
    (the walk runs on the CUDA cores). Library yardstick: SDPA over the
    context gathered and dequantized to bf16 beforehand. ``nh``: the
    heads (NH = NKV); ``even``: the even rows too."""
    from paddle_tpu_torch.ops import paged_attention as pa
    F = torch.nn.functional
    out = {}
    T, bs, hd = SPEC_K + 1, 128, 128
    b, kvd, nkv = len(PAGED_POSITIONS), nh * hd, nh
    for key, positions, width, seed in (
            ("", PAGED_POSITIONS, None, SEED + 71 + 32 - nh),
            (",even rows", PAGED_STEP_POSITIONS, 16, SEED + 75))[
                :2 if even else 1]:
        a = _quant_inputs(nh, nh, positions, seed, dev, torch.bfloat16,
                          max_nb=width)
        ctx = sum(p + 1 for p in positions)
        pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        new = [a[k][-1, :, 0].contiguous()
               for k in ("new_k", "new_v", "new_ks", "new_vs")]
        lengths = a["rows"] + 1
        read = (b * nh * hd * 2 + 2 * ctx * (kvd + 4 * nkv) + b * nh * hd * 4
                + a["tables"].numel() * 4 + b * 4)
        cols = 2 * b * (kvd + 4 * nkv)
        ops = 4 * nh * hd * ctx
        tmax = max(positions) + 1
        nb = -(-tmax // bs)
        rows = a["tables"][:, :nb].long()
        kc, vc = (pa.kv_dequant_blocks(c[a["layer"]][rows],
                                       sc[a["layer"]][rows])
                  .to(torch.bfloat16).reshape(b, nb, nh, hd, bs)
                  .permute(0, 2, 1, 4, 3).reshape(b, nh, nb * bs, hd)
                  [:, :, :tmax].contiguous()
                  for c, sc in ((pools[0], pools[2]), (pools[1], pools[3])))
        mask = (torch.arange(tmax, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        qd = a["q"][:, :, None, :]
        lib = _timed(lambda: F.scaled_dot_product_attention(
            qd, kc, vc, attn_mask=mask), 50)["ms"]
        upd = (a["q"], *new, *pools, a["tables"], a["rows"], a["layer"])
        rd = (a["q"], *pools, a["tables"], lengths, a["layer"])
        for name, nbytes, kern, plain in (
                ("paged_attend_update_quant", read + 2 * cols,
                 lambda: pa.paged_attend_update_quant(*upd),
                 lambda: pa.paged_attend_update_quant_plain(*upd)),
                ("paged_attention_quant", read,
                 lambda: pa.paged_attention_quant(*rd),
                 lambda: pa.paged_attention_quant_plain(*rd))):
            r = dict(_timed(kern, 100),
                     profiler_ms=_profiled_ms(kern, "paged_split_kernel"),
                     plain_ms=_timed(plain, 10)["ms"],
                     library_ms=lib, **_bound(nbytes, ops, F32_OPS_PER_S),
                     bytes=nbytes, context_tokens=ctx)
            out[f"{name}[B=8,NH=NKV={nh}{key}]"] = r
            print(f"{name} B=8 NH=NKV={nh} ctx {ctx} "
                  f"tokens{key.replace(',', ', ')}: {r}")
        del a, kc, vc, pools, new

    qstart = [p + 1 for p in PAGED_POSITIONS]
    for key, rows, width, seed in (
            ("", qstart, None, SEED + 72 + 32 - nh),
            (",even rows", VERIFY_STEP_QSTART, VERIFY_STEP_MAX_NB,
             SEED + 74))[:2 if even else 1]:
        a = _quant_inputs(nh, nh, rows, seed, dev, torch.bfloat16, T=T,
                          max_nb=width)
        ctx = sum(rows)
        call = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        nbytes = (b * T * nh * hd * 2 + 2 * ctx * (kvd + 4 * nkv)
                  + b * T * nh * (hd + 2) * 4 + a["tables"].numel() * 4
                  + b * 4)
        r = dict(_timed(lambda: pa.paged_attention_verify_quant(*call), 100),
                 profiler_ms=_profiled_ms(
                     lambda: pa.paged_attention_verify_quant(*call),
                     "paged_verify_split_kernel"),
                 plain_ms=_timed(lambda: pa.paged_attention_verify_quant_plain(
                     *call), 10)["ms"],
                 library_ms=_timed(_verify_library(
                     a["q"], (a["k_pool"], a["v_pool"]), a["tables"],
                     a["rows"], a["layer"], bs,
                     (a["k_scale"], a["v_scale"])), 50)["ms"],
                 **_bound(nbytes, 4 * T * nh * hd * ctx, F32_OPS_PER_S),
                 bytes=nbytes, context_tokens=ctx)
        out[f"paged_attention_verify_quant[B=8,T=5,NH=NKV={nh}{key}]"] = r
        print(f"paged_attention_verify_quant B=8 T=5 NH=NKV={nh} ctx {ctx} "
              f"tokens{key.replace(',', ', ')}: {r}")
        del a

    return out


def commit_sectors(qstart, clen, bs, esize):
    """32-byte sectors that one pool row of every (row, live segment)
    takes: the window of each row's live columns, split at block edges,
    in a pool row of bs elements of esize bytes (bs * esize a multiple of
    32)."""
    n = 0
    for q, c in zip(qstart, clen):
        t = 0
        while t < c:
            col = (q + t) % bs
            m = min(c - t, bs - col)
            n += ((col + m) * esize - 1) // 32 - col * esize // 32 + 1
            t += m
    return n


def commit_timing_inputs(dev, quant, nkv=32):
    """Row 8's (bf16) or row 9's (``quant``) timing inputs: L=32, B=8, T=5,
    KVD=128 ``nkv``, row 6's timing rows (qstart = row 3's positions + 1).
    Returns (kernel, plain version, the inputs' dict, the fed columns, the
    pools, qstart)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    qstart = [p + 1 for p in PAGED_POSITIONS]
    if quant:
        a = _quant_inputs(nkv, nkv, qstart, SEED + 73 + 32 - nkv, dev,
                          torch.bfloat16, T=SPEC_K + 1, layers=32)
        return (pa.paged_verify_commit_quant,
                pa.paged_verify_commit_quant_plain, a,
                [a[k] for k in ("new_k", "new_v", "new_ks", "new_vs")],
                [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")],
                a["rows"])
    a = _verify_inputs(nkv, nkv, qstart, SPEC_K + 1, SEED + 62 + 32 - nkv,
                       dev, layers=32)
    return (pa.paged_verify_commit, pa.paged_verify_commit_plain, a,
            [a["new_k"], a["new_v"]], [a["k_pool"], a["v_pool"]],
            a["qstart"])


def commit_times(dev, nkv=32, lengths=None):
    """Rows 8 and 9 at L=32, B=8, T=5, KVD=4096 (bf16 pools; int8 with 32
    f32 scales a column) over row 6's timing rows (qstart = row 3's
    positions + 1), at two commit lengths: every column accepted
    (``commit_len = T``, the key without a suffix) and the serve-spec
    step's (``commit_len = 1``: nothing accepted). Byte bound: the live
    columns read and written once (with their scales), plus the per-row
    indices. Sector bound: the live windows' 32-byte sectors in every pool
    row of K and V (and of the scale pools), written, plus the bytes read,
    over 3.35 TB/s: each pool row's window lies bs elements from the next
    row's, so a sector is the least a write moves. Library yardstick: one
    advanced-index assignment per pool of the live columns, indices and
    gathered sources made beforehand. ``profiler_ms``: torch.profiler's
    kernel time per launch. ``nkv``: the kv heads; ``lengths``: the
    commit lengths timed (default T and 1)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out = {}
    L, T, bs = 32, SPEC_K + 1, 128
    qstart = [p + 1 for p in PAGED_POSITIONS]
    b, kvd = len(qstart), nkv * 128
    for quant in (False, True):
        kern, plain, a, new, pools, qs = commit_timing_inputs(dev, quant,
                                                              nkv)
        esize = 1 if quant else 2
        for n_live in lengths or (T, 1):
            clen_l = [n_live] * b
            clen = torch.tensor(clen_l, dtype=torch.int32, device=dev)
            args = (*new, *pools, a["tables"], qs, clen)
            li, bid, col, _, bi, ti = pa.paged_commit_schedule(
                qs, clen, a["tables"], L, T, bs).long()
            live = ti < clen[bi]
            li, bid, col, bi, ti = (x[live] for x in (li, bid, col, bi, ti))
            srcs = [t[li, bi, ti] for t in new]

            def library():
                for pool, src in zip(pools, srcs):
                    pool[li, bid, :, col] = src
            cols = L * sum(clen_l)
            index_bytes = 3 * b * 4 + a["tables"].numel() * 4
            read = 2 * cols * kvd * esize + (2 * cols * nkv * 4 if quant
                                             else 0)
            sectors = 2 * L * kvd * commit_sectors(qstart, clen_l, bs, esize)
            if quant:
                sectors += 2 * L * nkv * commit_sectors(qstart, clen_l, bs,
                                                        4)
            r = dict(_timed(lambda: kern(*args), 200),
                     profiler_ms=_profiled_ms(lambda: kern(*args),
                                              "paged_commit"),
                     plain_ms=_timed(lambda: plain(*args), 20)["ms"],
                     library_ms=_timed(library, 50)["ms"],
                     **_bound(2 * read + index_bytes, 0, BF16_OPS_PER_S),
                     bytes=2 * read + index_bytes, sectors=sectors,
                     sector_bound_ms=(sectors * 32 + read + index_bytes)
                     / HBM_BYTES_PER_S * 1e3)
            key = (f"{kern.__name__}[L=32,B=8,T=5,KVD={kvd}"
                   f"{'' if n_live == T else ',commit_len=1'}]")
            out[key] = r
            print(f"{key}: {r}")
            del srcs, li, bid, col, bi, ti
        del a, new, pools
        torch.cuda.empty_cache()
    return out


def tp_rank_times(dev):
    """Rows 3 and 5-9 at a rank's shapes under serve-tp (llama_7b over mp
    2: NH = NKV = 16, KVD 2048), timed as at 32 heads (the main shape
    only; the commit with every column accepted)."""
    phase("times at a rank's shapes under mp 2 (NH = NKV = 16)")
    out = paged_update_times(dev, 16)
    out.update(verify_times(dev, 16, even=False))
    out.update(quant_times(dev, 16, even=False))
    out.update(commit_times(dev, 16, lengths=(SPEC_K + 1,)))
    return out


def slab_times(dev):
    """Rows 10 and 11 at the generate phase's decode shape, pos 1023: B=8,
    NH=32 over NKV=4, HD=64, T=1152, bf16. Bytes: q, K and V columns
    0..pos and the f32 output once; the update adds new k/v read and the
    column written. Operations: 2 products of 2 HD per (head, token).
    Library yardstick: SDPA with GQA over the context pre-transposed to
    [B, NKV, pos+1, HD] (the column write outside its time). Also the
    split grid."""
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
    nsplit = da.kernel_splits(b, nkv, SLAB_T, dev)
    tps = da.split_tiles(SLAB_T, nsplit)
    grid = dict(nsplit=nsplit, tiles_per_split=tps,
                ctas=nkv * b * nsplit,
                live_ctas=nkv * b * ((pos // da.TILE_T) // tps + 1))
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
                 bytes=nbytes, context_tokens=ctx, **grid)
        key = f"{name}[B=8,NH=32,NKV=4,HD=64,pos=1023]"
        out[key] = r
        print(f"{key} bf16: {r}")
    return out


def flash_times(dev):
    """The flash kernels at the train phase's shape: B=4, NH=32, S=2048,
    D=128, causal, bf16; row 14 also at the ERNIE phase's (B=8, NH=16,
    S=512, D=64) and the generate phase's prefill (B=8, NH=32, S=1024,
    D=64), and row 16 at the ERNIE phase's. Work counted for the live
    (query, key) pairs, S (S + 1) / 2 per head: the forward does 2
    products (Q K^T, P V), the backward 5 (S, dP, dV, dK, dQ), 2 D
    operations per pair each. Bytes: each input read once, each output
    written once. Library yardsticks: SDPA's causal forward; for the
    backward, SDPA forward + backward minus its forward (both timed
    here)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    out = {}
    for b, nh, s, d in ((TRAIN_B, 32, TRAIN_S, 128), (MOE_B, 16, MOE_S, 64),
                        (GEN_B, 32, GEN_S, 64)):
        key = f"flash_fwd[B={b},NH={nh},S={s},D={d},causal]"
        out[key] = _flash_fwd_times(fa, b, nh, s, d)
        print(f"{key} bf16: {out[key]}")
    out.update(_flash_bwd_times(fa, TRAIN_B, 32, TRAIN_S, 128))
    out.update(_flash_bwd_times(fa, 8, 16, 512, 64))
    return out


def _flash_fwd_times(fa, b, nh, s, d, iters=20):
    """Row 14 at [B, NH, S, D], causal, bf16, counted as flash_times
    counts it, with SDPA's causal forward beside it."""
    F = torch.nn.functional
    bh = b * nh
    qs, k, v, _ = _flash_inputs(bh, s, d, torch.bfloat16, SEED,
                                torch.device("cuda", 0))
    pairs, el = bh * s * (s + 1) // 2, bh * s * d
    q4, k4, v4 = (t.reshape(b, nh, s, d) for t in (qs, k, v))
    return dict(_timed(lambda: fa.flash_fwd(qs, k, v, True), iters),
                plain_ms=_timed(lambda: fa.flash_fwd_plain(qs, k, v, True),
                                2)["ms"],
                library_ms=_timed(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), iters)["ms"],
                **_bound(4 * el * 2 + bh * s * 4, 2 * 2 * d * pairs,
                         BF16_OPS_PER_S))


def _flash_bwd_times(fa, b, nh, s, d):
    """Row 16 at [B, NH, S, D], causal, bf16, counted as flash_times
    counts it, with SDPA's backward (forward + backward minus forward)
    beside it."""
    F = torch.nn.functional
    bh, scale = b * nh, d ** -0.5
    qs, k, v, do = _flash_inputs(bh, s, d, torch.bfloat16, SEED + 7,
                                 torch.device("cuda", 0))
    o, lse = fa.flash_fwd(qs, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    pairs, el = bh * s * (s + 1) // 2, bh * s * d
    q4, k4, v4, do4 = (t.reshape(b, nh, s, d) for t in (qs, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o4, (qg, kg, vg), do4)

    lib_fwd = _timed(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)["ms"]
    lib_both = _timed(sdpa_fwd_bwd, 20)["ms"]
    args = (qs, k, v, do, lse, delta, True, scale)
    r = dict(_timed(lambda: fa.flash_bwd(*args), 20),
             plain_ms=_timed(lambda: fa.flash_bwd_plain(*args), 2)["ms"],
             library_ms=lib_both - lib_fwd, library_fwd_bwd_ms=lib_both,
             **_bound(7 * el * 2 + 2 * bh * s * 4, 5 * 2 * d * pairs,
                      BF16_OPS_PER_S))
    key = f"flash_bwd[B={b},NH={nh},S={s},D={d},causal]"
    print(f"{key} bf16: {r}")
    return {key: r}


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


# ---------------------------------------------------------------------------
# the dense flash dispatch: the split backward (rows 17, 18), the block
# entries, read-only paged attention (row 2) and the long-context phases
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _bwd_mode(mode):
    """PADDLE_TPU_TORCH_FLASH_BWD set to ``mode`` inside the block and
    restored after it, whatever happens inside."""
    from paddle_tpu_torch.ops import flash_attention as fa
    old = os.environ.get(fa.ENV_FLASH_BWD)
    os.environ[fa.ENV_FLASH_BWD] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(fa.ENV_FLASH_BWD, None)
        else:
            os.environ[fa.ENV_FLASH_BWD] = old


# (BH, Sq, Sk, D, causal, dtype, spread): the train shape in bf16, and
# bf16 at Sq != Sk with a kv tail off the 128-key stages; f32 at
# a length that is no multiple of 64, a ring off-diagonal block (Sq != Sk,
# not causal), causal at Sq < Sk, and a score spread (keys 64..67 scaled
# so their scores lead by hundreds of log2 units)
SPLIT_CASES = [(TRAIN_B * 32, TRAIN_S, TRAIN_S, 128, True, torch.bfloat16,
                None),
               (8, 200, 330, 128, True, torch.bfloat16, None),
               (8, 330, 200, 64, False, torch.bfloat16, None),
               (8, 200, 200, 64, True, torch.float32, None),
               (8, 128, 320, 128, False, torch.float32, None),
               (8, 130, 200, 128, True, torch.float32, None),
               (8, 200, 200, 64, True, torch.float32, 60.0)]


def _split_inputs(bh, sq, sk, d, dtype, seed, dev, causal=True,
                  spread=None):
    """qs (pre-scaled), k, v, do, and the plain forward's o and lse."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(seed)
    qs = (torch.randn((bh, sq, d), generator=g, device=dev)
          * (fa.LOG2E / math.sqrt(d))).to(dtype)
    k, v = (torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((bh, sq, d), generator=g, device=dev).to(dtype)
    if spread is not None:
        k[:, 64:68] = (k[:, 64:68].float() * spread).to(dtype)
    o, lse = fa.flash_fwd_plain(qs, k, v, causal)
    return qs, k, v, do, o, lse


def check_split(dev, errs):
    """Rows 17 and 18 against their plain versions under the flash rule;
    row 17's dK and dV bitwise row 16's on the same inputs, row 18's dQ
    bitwise over two runs; row 18's dQ drift along f64 products at
    train-long's S within VARLEN_DRIFT_EXCESS of the plain version's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("check the split backward (rows 17, 18) against its plain "
          "versions")
    for i, (bh, sq, sk, d, causal, dtype, spread) in enumerate(SPLIT_CASES):
        qs, k, v, do, o, lse = _split_inputs(bh, sq, sk, d, dtype,
                                             SEED + 80 + i, dev, causal,
                                             spread)
        delta = (do.float() * o.float()).sum(-1)
        args = (qs, k, v, do, lse, delta, causal, 1 / math.sqrt(d))
        lead = None
        if spread is not None:
            s = (qs.float() @ k.float().transpose(1, 2))
            lead = (s[:, :, 64:68].amax() - s[:, :, :64].amax()).item()
            assert lead > 200, lead
        dk, dv = fa.flash_bwd_dkv(*args)
        dq = fa.flash_bwd_dq(*args)
        dq2 = fa.flash_bwd_dq(*args)
        _, dk_f, dv_f = fa.flash_bwd(*args)
        dk_r, dv_r = fa.flash_bwd_dkv_plain(*args)
        dq_r = fa.flash_bwd_dq_plain(*args)
        torch.cuda.synchronize()
        rel, frob = FLASH_TOL[dtype][1]
        res = {"dq": flash_close(dq, dq_r, rel, frob),
               "dk": flash_close(dk, dk_r, rel, frob),
               "dv": flash_close(dv, dv_r, rel, frob)}
        bitwise = (torch.equal(dk, dk_f) and torch.equal(dv, dv_f),
                   torch.equal(dq, dq2))
        spread_note = "" if lead is None else f" spread lead {lead:.0f} log2"
        print(f"split BH={bh} Sq={sq} Sk={sk} D={d} causal={causal} "
              f"{str(dtype)[6:]}{spread_note} (tol rel {rel:g} of |ref| + "
              f"row max + rms, frob {frob:g})")
        for name, (ok, excess, fro, err) in res.items():
            print(f"  {name}: max_abs_err {err:.3e}  worst excess over the "
                  f"limit {excess:.3e}  rel frob {fro:.3e}  "
                  f"{'ok' if ok else 'FAILED'}")
        print(f"  dK, dV bitwise row 16's: {bitwise[0]}; dQ bitwise over two "
              f"runs: {bitwise[1]}")
        assert all(r[0] for r in res.values()), f"split disagrees: {res}"
        assert all(bitwise), bitwise
        errs["flash_bwd_dkv"] = max(errs.get("flash_bwd_dkv", 0.0),
                                    res["dk"][3], res["dv"][3])
        errs["flash_bwd_dq"] = max(errs.get("flash_bwd_dq", 0.0),
                                   res["dq"][3])
        del args, dk, dv, dq, dq2, dk_f, dv_f, dk_r, dv_r, dq_r
        torch.cuda.empty_cache()
    x = split_dq_drift(fa, dev)
    print(f"split dQ (row 18) at BH={DQ_DRIFT_HEADS} S={LONG_S} D=128 causal "
          f"bf16, drift against f64: kernel {x['kernel']:+.3e}, plain "
          f"{x['plain']:+.3e}, excess {x['excess']:+.3e} (limit "
          f"{VARLEN_DRIFT_EXCESS:g}) {'ok' if x['ok'] else 'FAILED'}; rel "
          f"frob kernel {x['kernel_frob']:.3e}, plain {x['plain_frob']:.3e}")
    assert x["ok"], f"row 18's dQ drifts: {x}"


DQ_DRIFT_HEADS = 2


def dense_dq_f64(q, k, v, do, lse, delta, causal, scale, rows=1024):
    """Row 18's function at the plain version's rounding points (S, P and
    dS in f32, dS rounded to q's dtype before the scale), each product
    summed in f64: q pre-scaled, k, v, do [BH, S, D] -> dq f64."""
    from paddle_tpu_torch.ops.flash_attention import LOG2E
    dev = q.device
    sq, sk = q.shape[1], k.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float64, device=dev)
    lse2 = lse.float() * LOG2E
    for h in range(q.shape[0]):
        kf, vf = k[h].float(), v[h].float()
        for r0 in range(0, sq, rows):
            r1 = min(r0 + rows, sq)
            kn = min(r1, sk) if causal else sk
            s = q[h, r0:r1].float() @ kf[:kn].T
            if causal:
                s = s.masked_fill(torch.arange(kn, device=dev)[None]
                                  > torch.arange(r0, r1, device=dev)[:, None],
                                  -1e30)
            p = torch.exp2(s - lse2[h, r0:r1, None])
            dp = do[h, r0:r1].float() @ vf[:kn].T
            ds = (p * (dp - delta[h, r0:r1, None])).to(q.dtype).double()
            dq[h, r0:r1] = (ds @ kf[:kn].double()) * scale
            del s, p, dp, ds
    return dq


def split_dq_drift(fa, dev, s=None, heads=DQ_DRIFT_HEADS):
    """Row 18 and its plain version on ``heads`` heads at S = ``s``
    (default train-long's; D = 128, causal, bf16) against
    ``dense_dq_f64``: ``_drift_row``. A dQ sum carried in the tensor
    cores' accumulator over the key stages drifts low."""
    s = LONG_S if s is None else s
    qs, k, v, do, o, lse = _split_inputs(heads, s, s, 128, torch.bfloat16,
                                         SEED + 140, dev)
    delta = (do.float() * o.float()).sum(-1)
    args = (qs, k, v, do, lse, delta, True, 128 ** -0.5)
    row = _drift_row(fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args),
                     dense_dq_f64(*args))
    torch.cuda.synchronize()
    return row


BLOCK_S, BLOCK_N = 1024, 4       # the ring check: 4 blocks of 256


def _ring_blocks(fa, q, k, v, do, nb, scale):
    """Causal attention of q, k, v [BH, S, D] as a ring of nb blocks
    computes it: block (i, j) causal on the diagonal, full below it,
    skipped above; forward partials merged by log-sum-exp, the backward of
    each block under the global lse and delta, summed. Returns (o, lse,
    dq, dk, dv) in f32."""
    n = q.shape[1] // nb
    part = [slice(i * n, (i + 1) * n) for i in range(nb)]
    blk = lambda t, i: t[:, part[i]].contiguous()
    o, lse = torch.empty_like(q), torch.empty(q.shape[:2], device=q.device)
    for i in range(nb):
        ps = [fa.flash_block_fwd(blk(q, i), blk(k, j), blk(v, j), j == i,
                                 scale) for j in range(i + 1)]
        m = torch.logsumexp(torch.stack([p[1] for p in ps]), 0)
        o[:, part[i]] = sum(p[0] * torch.exp(p[1] - m)[..., None] for p in ps)
        lse[:, part[i]] = m
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for i in range(nb):
        for j in range(i + 1):
            g = fa.flash_block_bwd(blk(q, i), blk(k, j), blk(v, j), blk(do, i),
                                   blk(lse, i), blk(delta, i), j == i, scale)
            dq[:, part[i]] += g[0]
            dk[:, part[j]] += g[1]
            dv[:, part[j]] += g[2]
    return o, lse, dq, dk, dv


def check_blocks(dev):
    """flash_block_fwd / flash_block_bwd on the card (f32, BH=8, S=1024,
    D=128, causal): the ring decomposition into four 128-aligned blocks
    against one full-attention call, under both backward modes; a key
    tile no q row reaches gets dK = dV = 0 exactly."""
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("check the block entries: four KV blocks merged by log-sum-exp, "
          "the per-block backward under global lse/delta, against one full "
          "call (f32)")
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    q, k, v, do = (torch.randn((8, BLOCK_S, 128), generator=g, device=dev)
                   for _ in range(4))
    scale = 128 ** -0.5
    (rel, frob) = FLASH_TOL[torch.float32][1]
    for mode in ("auto", "split"):
        with _bwd_mode(mode):
            got = _ring_blocks(fa, q, k, v, do, BLOCK_N, scale)
            o, lse = fa.flash_block_fwd(q, k, v, True, scale)
            full = (o, lse) + fa.flash_block_bwd(
                q, k, v, do, lse, (do * o).sum(-1), True, scale)
            dead = fa.flash_block_bwd(q[:, :128].contiguous(),
                                      k[:, :256].contiguous(),
                                      v[:, :256].contiguous(),
                                      do[:, :128].contiguous(),
                                      lse[:, :128].contiguous(),
                                      (do * o).sum(-1)[:, :128].contiguous(),
                                      True, scale)
        torch.cuda.synchronize()
        res = {n: flash_close(a, b, rel, frob) for n, a, b in
               zip(("o", "lse", "dq", "dk", "dv"), got, full)}
        zero = not dead[1][:, 128:].any() and not dead[2][:, 128:].any()
        print(f"blocks ({fa.ENV_FLASH_BWD}={mode}): "
              + "  ".join(f"{n} max_abs_err {r[3]:.3e} rel frob {r[2]:.3e}"
                          for n, r in res.items())
              + f"; unreached keys dK = dV = 0: {zero}")
        assert all(r[0] for r in res.values()), res
        assert zero


PAGED_READ_CASES = [(32, 32, 128, torch.bfloat16, PAGED_ATOL),  # row 3's
                    (32, 8, 128, torch.float32, 1e-5),
                    (8, 2, 64, torch.float32, 1e-5)]


def check_paged_read(dev, errs):
    """Row 2 against its plain version: at row 3's shape (lengths =
    positions + 1) and on f32 GQA cases with a length-0 row (output
    exactly 0); the pools are not written."""
    from paddle_tpu_torch.ops import paged_attention as pa
    phase("check read-only paged attention (row 2) against its plain "
          "version")
    for i, (nh, nkv, hd, dtype, atol) in enumerate(PAGED_READ_CASES):
        a = _paged_inputs(nh, nkv, PAGED_POSITIONS, SEED + 95 + i, dev, hd=hd)
        q, kp, vp = (a[n].to(dtype) for n in ("q", "k_pool", "v_pool"))
        lengths = a["positions"] + 1
        if dtype == torch.float32:
            lengths[0] = 0
        kp0, vp0 = kp.clone(), vp.clone()
        splits = pa.kernel_splits(a["tables"].shape[1], 128)
        got = pa.paged_attention(q, kp, vp, a["tables"], lengths, a["layer"])
        again = pa.paged_attention(q, kp, vp, a["tables"], lengths,
                                   a["layer"])
        ref = pa.paged_attention_plain(q, kp, vp, a["tables"], lengths,
                                       a["layer"], splits=splits)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        assert torch.isfinite(got).all() and err <= atol, err
        assert torch.equal(got, again), "paged_attention: bits differ"
        assert torch.equal(kp, kp0) and torch.equal(vp, vp0)
        zero = bool(lengths[0] > 0) or not got[0].any()
        assert zero
        print(f"paged_attention NH={nh} NKV={nkv} HD={hd} {str(dtype)[6:]} "
              f"lengths {lengths.tolist()} ({splits} splits): max_abs_err "
              f"{err:.3e} (tol {atol}), the same bits over two calls, pools "
              f"unchanged, length-0 row exactly 0: {zero}")
        errs["paged_attention"] = max(errs.get("paged_attention", 0.0), err)


LONG_S, LONG_STEPS = 16384, 2     # train-long: B = 1 at S = 16384


def train_long(dev):
    """build_train_step on llama_7b's width cut to 16 of its 32 layers
    (the train phase's cut: 42.0 GB of state) at Code Llama 7B's
    long-context setting (Roziere et al. 2023, "Code Llama", section 2.4:
    16,384-token sequences, RoPE base 10^6): B = 1, S = 16384, bf16, full
    remat, AdamW with f32 moments, seeded weights and ids. Under each
    backward mode, auto then split: one warm-up and LONG_STEPS timed
    steps, each step's launches asserted; then a profile of one step."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.ops import flash_attention as fa
    phase(f"train-long: llama_7b width, {TRAIN_LAYERS} layers (bf16, B=1, "
          f"S={LONG_S}, rope_theta 1e6, full remat, AdamW f32 moments), "
          f"{fa.ENV_FLASH_BWD} auto then split")
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=TRAIN_LAYERS,
                              max_position_embeddings=LONG_S,
                              rope_theta=1e6)
    par = tl.ParallelConfig(remat=True, remat_policy="full")
    t0 = time.perf_counter()
    step, params, opt = tl.build_train_step(cfg, par, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"weights and moments made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    L, heads = cfg.num_hidden_layers, cfg.num_attention_heads
    flops_tok = tl.train_flops_per_token(cfg, LONG_S)
    rng = np.random.RandomState(SEED + 8)
    out = {"layers": L, "batch": 1, "seq": LONG_S, "rope_theta": 1e6,
           "params": tl.count_params(cfg), "train_flops_per_token": flops_tok,
           "reduced": f"num_hidden_layers 32 -> {L} (state at 32 layers is "
                      f"80.9 GB, over the 80 GB card)", "modes": {}}
    torch.cuda.reset_peak_memory_stats()
    names = ("flash_fwd", "flash_bwd", "flash_bwd_dkv", "flash_bwd_dq")
    for mode in ("auto", "split"):
        split = mode == "split"
        want = {"flash_fwd": 2 * L, "flash_bwd": 0 if split else L,
                "flash_bwd_dkv": L if split else 0,
                "flash_bwd_dq": L if split else 0}
        batches = [rng.randint(0, cfg.vocab_size, size=(1, LONG_S + 1))
                   .astype(np.int32) for _ in range(1 + LONG_STEPS)]
        losses, step_ms, launches = [], [], {n: 0 for n in names}
        with _bwd_mode(mode):
            stats = fa.dense_bwd_schedule_stats(heads, LONG_S, LONG_S,
                                                cfg.head_dim, torch.bfloat16,
                                                True)
            print(f"dense_bwd_schedule_stats: {stats} (JAX: forward "
                  f"{stats['fwd_path']} = row "
                  f"{13 if stats['fwd_path'] == 'stream' else 14}, backward "
                  f"{stats['path']})")
            for i, x in enumerate(batches):
                _zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, loss = step(params, opt, x[:, :-1], x[:, 1:])
                losses.append(float(loss))       # waits for the step
                step_ms.append((time.perf_counter() - t0) * 1e3)
                counts = _counts()
                assert {n: counts[n] for n in names} == want, counts
                for n in names:
                    launches[n] += counts[n]
                print(f"step {i}{' (warm-up)' if i == 0 else ''}: loss "
                      f"{losses[-1]:.6f}  {step_ms[-1]:.1f} ms  launches "
                      f"{ {n: counts[n] for n in names} }")
        assert all(math.isfinite(v) for v in losses), losses
        ms = float(np.mean(step_ms[1:]))
        tps = LONG_S / (ms / 1e3)
        mfu = flops_tok * tps / BF16_OPS_PER_S
        print(f"{mode}: step ms mean {ms:.2f} over {LONG_STEPS} timed steps "
              f"{step_ms[1:]}; tokens/s {tps:.1f}; MFU {mfu:.4f} "
              f"(train_flops_per_token {flops_tok:.4e})")
        out["modes"][mode] = {"schedule_stats": stats, "losses": losses,
                              "step_ms": step_ms, "step_ms_mean": ms,
                              "tokens_per_sec": tps, "mfu": mfu,
                              "launches": launches}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak mem {out['peak_mem_gib']:.2f} GiB over both modes")
    out["profile"] = profile_train_step(params, opt, batches[0], cfg)
    del step, params, opt
    torch.cuda.empty_cache()
    return out


# bench.py's long_seq_flash_fwd rung (bench.py:2123-2170): (BH, S) at
# D = 128, causal, bf16
ATTN_LONG = [(8, 16384), (8, 32768), (4, 131072)]
ATTN_LONG_ITERS = 2


def _attn_long_check(fa, bh, s, dev, seed):
    """Rows 14 and 16 (auto) and rows 17 and 18 (split) against the plain
    versions on every element at one long shape; returns the errors."""
    d = 128
    qs, k, v, do, o_r, lse_r = _split_inputs(bh, s, s, d, torch.bfloat16,
                                             seed, dev)
    (rel_f, frob_f), (rel_b, frob_b) = FLASH_TOL[torch.bfloat16]
    o, lse = fa.flash_fwd(qs, k, v, True)
    res = {"o": flash_close(o, o_r, rel_f, frob_f)}
    err_lse = (lse - lse_r).abs().max().item()
    del o
    delta = (do.float() * o_r.float()).sum(-1)
    args = (qs, k, v, do, lse_r, delta, True, d ** -0.5)
    # flash_bwd_plain's dK/dV and dQ are the split pair's plain versions'
    # (one walk, the same bits)
    want = fa.flash_bwd_plain(*args)
    got = fa.flash_bwd(*args)
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        res[f"{n} (row 16)"] = flash_close(a, b, rel_b, frob_b)
    del got
    dk, dv = fa.flash_bwd_dkv(*args)
    dq = fa.flash_bwd_dq(*args)
    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        res[f"{n} (split)"] = flash_close(a, b, rel_b, frob_b)
    torch.cuda.synchronize()
    print(f"  BH={bh} S={s}: kernels against the plain versions on every "
          f"element (bf16 rel 2^-6, frob 2^-10; lse 1e-4): lse max_abs_err "
          f"{err_lse:.2e}")
    for n, (ok, excess, fro, err) in res.items():
        print(f"    {n}: max_abs_err {err:.3e}  worst excess {excess:.3e}  "
              f"rel frob {fro:.3e}  {'ok' if ok else 'FAILED'}")
    assert all(r[0] for r in res.values()) and err_lse <= 1e-4, res
    return {n: r[3] for n, r in res.items()}


def attn_long(dev):
    """bench.py's long_seq_flash_fwd shapes through the differentiable
    [BH, S, D] entry (flash_attention_op: raw q, causal, bf16, seeded):
    forward and backward of sum(o^2) with respect to q, k and v, under
    auto and under split. Per shape: the kernels held to the plain
    versions on every element (all heads), then per mode one warm-up
    step, one under sync debug mode (no host sync allowed) and timed
    steps: forward and backward ms from CUDA events, TFLOP/s over the
    causal half (forward 4 BH S^2 D / 2, backward 2.5 times that), peak
    memory and the launches of the mode's runs alone."""
    from paddle_tpu_torch.ops import flash_attention as fa
    phase("attn-long: flash fwd+bwd at bench.py's long_seq_flash_fwd shapes "
          "(D=128, causal, bf16), auto and split")
    out = {"shapes": {}}
    for i, (bh, s) in enumerate(ATTN_LONG):
        d, scale = 128, 128 ** -0.5
        torch.cuda.empty_cache()
        errs = _attn_long_check(fa, bh, s, dev, SEED + 100 + i)
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(SEED + 110 + i)
        q, k, v = (torch.randn((bh, s, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        flops = 4 * bh * s * s * d / 2
        r = {"bh": bh, "seq": s, "head_dim": d, "max_abs_err": errs,
             "modes": {}}
        for mode in ("auto", "split"):
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]

            def fwd():
                return fa.flash_attention_op(*xs, True, scale)[0]

            def step():
                for x in xs:
                    x.grad = None
                (fwd().float() ** 2).sum().backward()

            with _bwd_mode(mode):
                stats = fa.dense_bwd_schedule_stats(bh, s, s, d,
                                                    torch.bfloat16, True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                step()
                torch.cuda.synchronize()
                syncs = _host_syncs(step)
                assert not syncs, syncs
                ev = [[torch.cuda.Event(enable_timing=True)
                       for _ in range(3)] for _ in range(ATTN_LONG_ITERS)]
                for e0, e1, e2 in ev:
                    for x in xs:
                        x.grad = None
                    e0.record()
                    o = fwd()
                    e1.record()
                    (o.float() ** 2).sum().backward()
                    e2.record()
                torch.cuda.synchronize()
                launches = _counts()
            runs = ATTN_LONG_ITERS + 2
            split = mode == "split"
            want = {"flash_fwd": runs, "flash_bwd": 0 if split else runs,
                    "flash_bwd_dkv": runs if split else 0,
                    "flash_bwd_dq": runs if split else 0}
            assert all(launches[n] == c for n, c in want.items()), launches
            assert all(c == 0 for n, c in launches.items() if n not in want)
            assert all(bool(torch.isfinite(t).all())
                       for t in [o] + [x.grad for x in xs])
            fwd_ms = sum(a.elapsed_time(b) for a, b, _ in ev) / len(ev)
            bwd_ms = sum(b.elapsed_time(c) for _, b, c in ev) / len(ev)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            m = {"schedule_stats": stats, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                 "fwd_tflops": flops / fwd_ms / 1e9,
                 "bwd_tflops": 2.5 * flops / bwd_ms / 1e9,
                 "peak_mem_gib": peak, "host_syncs": len(syncs),
                 "launches": {n: launches[n] for n in want}}
            r["modes"][mode] = m
            print(f"  BH={bh} S={s} {mode}: JAX forward {stats['fwd_path']}, "
                  f"backward {stats['path']}; forward {fwd_ms:.3f} ms "
                  f"({m['fwd_tflops']:.1f} TFLOP/s), backward {bwd_ms:.3f} "
                  f"ms ({m['bwd_tflops']:.1f} TFLOP/s), peak mem "
                  f"{peak:.2f} GiB, host syncs {len(syncs)}, launches "
                  f"{m['launches']}")
            del xs, o
        out["shapes"][f"BH={bh},S={s}"] = r
    return out


def _library_dense_bwd(q4, k4, v4, do4, scale):
    """One PyTorch call for the whole dense causal backward, the
    yardstick the port never calls: aten's _flash_attention_backward
    ([B, S, H, D]) after its own forward; where torch refuses it, SDPA
    forward + backward minus forward. Returns (what, ms)."""
    A = torch.ops.aten
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in (q4, k4, v4, do4))
    s = q.shape[1]
    try:
        res = A._flash_attention_forward(q, k, v, None, None, s, s, 0.0,
                                         True, False, scale=scale)
        o, lse, rng, unused = res[0], res[1], res[2], res[3]

        def bwd():
            return A._flash_attention_backward(do, q, k, v, o, lse, None,
                                               None, s, s, 0.0, True, rng,
                                               unused, scale=scale)
        bwd()
        torch.cuda.synchronize()
        return "aten._flash_attention_backward", _timed(bwd, 5)["ms"]
    except RuntimeError as e:   # a refused call: recorded, then SDPA
        what = f"SDPA fwd+bwd - fwd (aten refused: {str(e)[:120]})"
    F = torch.nn.functional
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

    def both():
        o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o4, (qg, kg, vg), do4)
    return what, _timed(both, 5)["ms"] - _timed(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        5)["ms"]


def split_times(dev):
    """Rows 17 and 18 at the train phase's shape (B=4, NH=32, S=2048) and
    at train-long's (B=1, NH=32, S=16384), D=128, causal, bf16. Work
    counted for the live (query, key) pairs, S (S + 1) / 2 per head: the
    dK/dV pass does 4 products (S, dV, dP, dK), the dQ pass 3 (S, dP,
    dQ), 2 D operations per pair each. Bytes: q, k, v, do and the f32 lse
    and delta read once, dk and dv (dq) written once. Library yardstick:
    aten's whole flash backward, as for rows 22 and 23."""
    from paddle_tpu_torch.ops import flash_attention as fa
    out = {}
    for b, s in ((TRAIN_B, TRAIN_S), (1, LONG_S)):
        nh, d = 32, 128
        bh, scale = b * nh, d ** -0.5
        qs, k, v, do, o, lse = _split_inputs(bh, s, s, d, torch.bfloat16,
                                             SEED + 120, dev)
        delta = (do.float() * o.float()).sum(-1)
        args = (qs, k, v, do, lse, delta, True, scale)
        pairs, el = bh * s * (s + 1) // 2, bh * s * d
        what, lib = _library_dense_bwd(*(t.reshape(b, nh, s, d)
                                         for t in (qs, k, v, do)), scale)
        for name, fn, plain, n_prod, n_out in (
                ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain,
                 4, 2),
                ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain,
                 3, 1)):
            r = dict(_timed(lambda: fn(*args), 10),
                     plain_ms=_timed(lambda: plain(*args), 1)["ms"],
                     library_ms=lib, library=what,
                     **_bound((4 + n_out) * el * 2 + 2 * bh * s * 4,
                              n_prod * 2 * d * pairs, BF16_OPS_PER_S))
            key = f"{name}[B={b},NH=32,S={s},D=128,causal]"
            out[key] = r
            print(f"{key} bf16: {r}")
        del args, qs, k, v, do, o
        torch.cuda.empty_cache()
    return out


def long_times(dev):
    """Row 13's and row 15's covers at the shapes that select them in JAX
    (dense_bwd_schedule_stats): row 14's kernel at BH=8, S=16384 (JAX
    streams K/V) and row 16's at BH=4, S=131072 (JAX's dQ-partials
    backward), D=128, causal, bf16; work and bytes as flash_times counts
    them. Library yardsticks: SDPA's causal forward; SDPA forward +
    backward minus forward."""
    from paddle_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    out = {}
    for name, (bh, s) in (("flash_fwd", ATTN_LONG[0]),
                          ("flash_bwd", ATTN_LONG[2])):
        d, scale = 128, 128 ** -0.5
        qs, k, v, do, o, lse = _split_inputs(bh, s, s, d, torch.bfloat16,
                                             SEED + 130, dev)
        delta = (do.float() * o.float()).sum(-1)
        stats = fa.dense_bwd_schedule_stats(bh, s, s, d, torch.bfloat16,
                                            True)
        pairs, el = bh * s * (s + 1) // 2, bh * s * d
        q4, k4, v4, do4 = (t.reshape(1, bh, s, d) for t in (qs, k, v, do))
        lib_fwd = _timed(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 5)["ms"]
        if name == "flash_fwd":
            r = dict(_timed(lambda: fa.flash_fwd(qs, k, v, True), 10),
                     plain_ms=_timed(lambda: fa.flash_fwd_plain(
                         qs, k, v, True), 1)["ms"], library_ms=lib_fwd,
                     **_bound(4 * el * 2 + bh * s * 4, 2 * 2 * d * pairs,
                              BF16_OPS_PER_S))
            cover = f"row 13 (JAX forward {stats['fwd_path']})"
        else:
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q4, k4, v4))

            def both():
                o4 = F.scaled_dot_product_attention(qg, kg, vg,
                                                    is_causal=True)
                return torch.autograd.grad(o4, (qg, kg, vg), do4)
            args = (qs, k, v, do, lse, delta, True, scale)
            lib_both = _timed(both, 3)["ms"]
            r = dict(_timed(lambda: fa.flash_bwd(*args), 3),
                     plain_ms=_timed(lambda: fa.flash_bwd_plain(*args),
                                     1)["ms"],
                     library_ms=lib_both - lib_fwd,
                     library_fwd_bwd_ms=lib_both,
                     **_bound(7 * el * 2 + 2 * bh * s * 4, 5 * 2 * d * pairs,
                              BF16_OPS_PER_S))
            cover = f"row 15 (JAX backward {stats['path']})"
            del qg, kg, vg
        r["schedule_stats"] = stats
        key = f"{name}[BH={bh},S={s},D=128,causal]"
        out[key] = r
        print(f"{key} bf16, {cover}: {r}")
        del qs, k, v, do, o, q4, k4, v4, do4
        torch.cuda.empty_cache()
    return out


def paged_read_times(dev):
    """Row 2 at row 3's timing shape (B=8, NH=NKV=32, HD=128, bf16,
    lengths = row 3's positions + 1: 3,865 tokens). Bytes: q, the K and V
    of the context, the f32 output, tables and lengths once. Operations:
    2 products of 2 HD per (head, token). Library yardstick: SDPA over the
    context gathered beforehand, as for row 3. Beside the CUDA events'
    ms (with ``queued``: the host had queued every call before the device
    reached them), the profiler's kernel time of the same call."""
    from paddle_tpu_torch.ops import paged_attention as pa
    F = torch.nn.functional
    a = _paged_inputs(32, 32, PAGED_POSITIONS, SEED + 32, dev)
    b, nh, hd = a["q"].shape
    kvd, bs = a["k_pool"].shape[2], a["k_pool"].shape[3]
    lengths = a["positions"] + 1
    ctx = int(lengths.sum())
    nbytes = (b * nh * hd * 2 + 2 * ctx * kvd * 2 + b * nh * hd * 4
              + a["tables"].numel() * 4 + b * 4)
    call = (a["q"], a["k_pool"], a["v_pool"], a["tables"], lengths,
            a["layer"])
    tmax = int(lengths.max())
    nb = -(-tmax // bs)
    rows = a["tables"][:, :nb].long()
    kc, vc = (c[a["layer"]][rows].reshape(b, nb, nh, hd, bs)
              .permute(0, 2, 1, 4, 3).reshape(b, nh, nb * bs, hd)[:, :, :tmax]
              .contiguous() for c in (a["k_pool"], a["v_pool"]))
    mask = (torch.arange(tmax, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qd = a["q"][:, :, None, :]
    r = dict(_timed(lambda: pa.paged_attention(*call), 100),
             plain_ms=_timed(lambda: pa.paged_attention_plain(*call), 10)
             ["ms"],
             library_ms=_timed(lambda: F.scaled_dot_product_attention(
                 qd, kc, vc, attn_mask=mask), 50)["ms"],
             **_bound(nbytes, 4 * nh * hd * ctx, BF16_OPS_PER_S),
             profiler_ms=_profiled_ms(lambda: pa.paged_attention(*call),
                                      "paged_split_kernel"),
             bytes=nbytes, context_tokens=ctx)
    key = "paged_attention[B=8,NH=NKV=32]"
    print(f"{key} ctx {ctx} tokens: {r}")
    return {key: r}


# ---------------------------------------------------------------------------
# resume and fleet: checkpoint save/load, the CheckpointManager, and the
# FleetRouter over engine replicas on one card
# ---------------------------------------------------------------------------

# resume: build_train_step at llama_7b's width cut to 2 layers (667 M
# params: bf16 weights, f32 moments, 6.7 GB of state), bench.py
# bench_preempt_resume's readings at this shape
RESUME_LAYERS, RESUME_B, RESUME_S, RESUME_STEPS = 2, 4, 2048, 6
RESUME_INTERVAL = RESUME_STEPS // 2    # two saves a measured run (bench.py)
# fleet: bench.py bench_serve_fleet's on-chip trace (RandomState(20): a
# 512-token system prompt, tails of 16-95 tokens, 32 new tokens, arrival
# 2i on the iteration clock in deterministic mode)
FLEET_SERVE = dict(block_size=128, num_blocks=257, max_batch=8,
                   prefill_chunk=256, max_seq_len=2048, prefix_cache=True)
FLEET_REQUESTS, FLEET_NEW, FLEET_SYSTEM, FLEET_TAIL = 24, 32, 512, (16, 96)
FLEET_N = 2    # 2 x 17.2 GB of pools + 13.5 GB of weights; 4 do not fit


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _need_disk(path, nbytes, what):
    """Raise, naming the bytes, when ``path``'s file system has less than
    ``nbytes`` free."""
    free = shutil.disk_usage(path).free
    if free < nbytes:
        raise RuntimeError(
            f"{what} needs {nbytes / 1e9:.2f} GB free under {path}; "
            f"{free / 1e9:.2f} GB are")
    print(f"disk under {path}: {free / 1e9:.1f} GB free, {what} needs "
          f"{nbytes / 1e9:.2f} GB")


class _RssPeak:
    """The process's peak resident set over a block, sampled every 20 ms
    from /proc/self/status (VmHWM holds the peak since the process
    started, earlier phases included); ``mark(name)`` closes a stretch
    and keeps its own peak in ``marks``."""

    def __enter__(self):
        self.peak, self._stop = 0, threading.Event()
        self.marks, self._since = {}, self._rss()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def mark(self, name):
        self.marks[name] = round(self._since / 1e9, 2)
        self._since = self._rss()

    def _rss(self):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.is_set():
            now = self._rss()
            self.peak = max(self.peak, now)
            self._since = max(self._since, now)
            self._stop.wait(0.02)

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._rss())


def _fresh_train_state(cfg, seed, dev):
    from paddle_tpu_torch.models import llama as tl
    params = tl.init_llama_params(cfg, seed, device=dev)
    return {"params": params, "opt": tl._adamw_init(params), "step": 0}


def _train_run(step, state, batches, start, stop, on_step=None):
    """Steps start+1..stop on ``state`` (its leaves updated in place);
    ``on_step(i)`` after step i. Returns the losses."""
    losses = []
    for i in range(start, stop):
        x = batches[i]
        state["params"], state["opt"], loss = step(
            state["params"], state["opt"], x[:, :-1], x[:, 1:])
        losses.append(float(loss))
        state["step"] = i + 1
        if on_step is not None:
            on_step(i + 1)
    return losses


def check_tiny_checkpoint(dev, root):
    """A tiny fp32 Llama train state written from CUDA tensors restores
    bitwise into a CPU template, and one written from the CPU into a card
    template; both manifests equal."""
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    from paddle_tpu_torch.models import llama as tl
    cfg = tl.llama_tiny(vocab=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, seq=256)
    cpu = _fresh_train_state(cfg, 3, "cpu")
    cpu["opt"]["m"]["embed"].normal_(     # moments not all zero
        generator=torch.Generator().manual_seed(4))
    state = {"cpu": dict(cpu, step=1),
             "card": {"params": _to_device(cpu["params"], dev),
                      "opt": _to_device(cpu["opt"], dev), "step": 1}}
    for src, dst in (("card", "cpu"), ("cpu", "card")):
        path = os.path.join(root, f"tiny_{src}")
        sl.save_state_dict(state[src], path, manifest={"step": 1})
        tmpl = _fresh_train_state(cfg, 9, dev if dst == "card" else "cpu")
        sl.load_state_dict(tmpl, path)
        sums = sl.leaf_checksums(tmpl)
        assert sums == sl.load_manifest(path)["leaf_checksums"], (src, dst)
        where = torch.device(dev if dst == "card" else "cpu").type
        assert all(t.device.type == where for t in _leaves(tmpl["params"]))
    assert sl.load_manifest(os.path.join(root, "tiny_card")) == \
        sl.load_manifest(os.path.join(root, "tiny_cpu"))
    print(f"tiny fp32 checkpoint: card -> CPU and CPU -> card bitwise, "
          f"manifests equal ({len(sums)} leaves)")
    return len(sums)


def resume_phase(dev):
    """Checkpoint, preemption and resume on build_train_step at llama_7b's
    width cut to RESUME_LAYERS layers (B 4, S 2048, full remat), under
    PADDLE_TPU_TORCH_FLASH_BWD=split so that a step's bits repeat (row
    16's dQ reduce-adds are not order-deterministic): an uninterrupted
    run; a CheckpointManager run preempted by SIGTERM after step 5; a
    restore into a state of another seed, checked leaf by leaf against
    the manifest and by step 6's loss; a commit fault on a later save;
    bench.py bench_preempt_resume's readings; the tiny fp32 CUDA <-> CPU
    check. Every file lives under one tempfile.mkdtemp(), removed at the
    end whatever happens."""
    import dataclasses
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         Preempted)
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.testing import faults
    phase(f"resume: llama_7b width, {RESUME_LAYERS} layers (bf16, "
          f"B={RESUME_B}, S={RESUME_S}, AdamW f32 moments, "
          f"PADDLE_TPU_TORCH_FLASH_BWD=split): CheckpointManager, SIGTERM, "
          f"restore, a commit fault, bench_preempt_resume's readings")
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=RESUME_LAYERS)
    par = tl.ParallelConfig(remat=True, remat_policy="full")
    L, n = RESUME_LAYERS, RESUME_STEPS
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, cfg.vocab_size, size=(RESUME_B, RESUME_S + 1))
               .astype(np.int32) for _ in range(n + 1)]
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    old_faults = os.environ.get(faults.ENV_FAULTS)
    os.environ[faults.ENV_FAULTS] = "1"
    out = {"layers": L, "batch": RESUME_B, "seq": RESUME_S}
    try:
        with _bwd_mode("split"), _RssPeak() as rss:
            step, params, opt = tl.build_train_step(cfg, par, seed=SEED,
                                                    device=dev)
            state = {"params": params, "opt": opt, "step": 0}
            nbytes = _tree_bytes(state["params"]) + _tree_bytes(state["opt"])
            out["state_gb"] = nbytes / 1e9
            # the most on disk at once: keep 2, one more in flight, and a
            # failed save's dir
            _need_disk(root, 4 * nbytes, "the resume phase")
            _train_run(step, state, batches, 0, 1)    # warm-up
            del state, params, opt
            torch.cuda.empty_cache()

            # 1. the uninterrupted run (also bench's bare steps)
            state = _fresh_train_state(cfg, SEED, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = _train_run(step, state, batches, 0, n)
            t_plain = time.perf_counter() - t0
            ref.append(_train_run(step, state, batches, n, n + 1)[0])
            del state
            rss.mark("uninterrupted")
            print(f"uninterrupted losses {ref[:n]} ({t_plain / n * 1e3:.1f} "
                  f"ms a step); step {n + 1} {ref[n]}")

            # 2. the managed run, SIGTERM after step 5 (counts from here)
            state = _fresh_train_state(cfg, SEED, dev)
            mgr = CheckpointManager(os.path.join(root, "run"), keep=2,
                                    interval=2)
            _zero_counts()
            mgr.install_preemption_handler()
            try:
                def on_step(i):
                    if i == 5:
                        os.kill(os.getpid(), signal.SIGTERM)
                    mgr.on_step(i, lambda: state)
                try:
                    _train_run(step, state, batches, 0, n, on_step)
                    raise AssertionError("no Preempted after SIGTERM")
                except Preempted as e:
                    pre = e
            finally:
                mgr.uninstall_preemption_handler()
            assert pre.step == 5 and pre.checkpoint == mgr.step_dir(5), pre
            assert mgr.steps() == [4, 5] and mgr.save_errors == [], \
                (mgr.steps(), mgr.save_errors)
            del state
            torch.cuda.empty_cache()

            # 3. a fresh state of another seed, restored
            state = _fresh_train_state(cfg, SEED + 1, dev)
            t0 = time.perf_counter()
            assert mgr.verify_step(5)
            t_verify = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = mgr.restore(state, verify=False)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            assert got == 5 and int(state["step"]) == 5, got
            man = sl.load_manifest(mgr.step_dir(5))
            assert sl.leaf_checksums(state) == man["leaf_checksums"]
            loss6 = _train_run(step, state, batches, 5, 6)[0]
            launches = _counts()
            assert loss6 == ref[5], (loss6, ref[5])
            rss.mark("managed run and restore")
            print(f"preempted at step {pre.step}; restored step {got} into "
                  f"seed {SEED + 1}'s state: {man['n_leaves']} leaf "
                  f"checksums equal the manifest's; step 6 loss {loss6} "
                  f"bitwise the uninterrupted one; verify {t_verify:.2f} s, "
                  f"restore {t_restore:.2f} s")

            # 4. a commit fault on a later save: latest() stays on 5, and
            #    the restore from it continues bitwise
            with faults.scope("ckpt.commit.before_marker", "raise") as plan:
                mgr.save(state, 6)
                errs = mgr.wait()
            assert plan.fired == 1 and len(errs) == 1 and \
                isinstance(errs[0][1], faults.FaultError), errs
            assert mgr.latest() == 5 and \
                os.path.isdir(mgr.step_dir(6)), mgr.steps()
            assert mgr.restore(state) == 5
            again = _train_run(step, state, batches, 5, 6)[0]
            assert again == ref[5], (again, ref[5])
            rss.mark("commit fault")
            print(f"commit fault at step 6: latest() {mgr.latest()}, the "
                  f"restore from it gives step 6's loss again bitwise")
            del state
            shutil.rmtree(mgr.root)
            torch.cuda.empty_cache()
            # the split backward only: no flash_bwd (row 16)
            want = {"flash_fwd": 2 * L * 6,
                    "flash_bwd_dkv": L * 6, "flash_bwd_dq": L * 6,
                    "rms_norm": ((2 * L + 1) + 2 * L) * 6}
            ran = {k: v for k, v in launches.items() if v}
            assert ran == want, (ran, want)
            print(f"launches over the managed run and the restored step: "
                  f"{ran}")
            out.update({"losses": ref, "launches": ran,
                        "preempted_step": pre.step, "restored_step": got,
                        "verify_s": t_verify, "restore_s": t_restore,
                        "n_leaves": man["n_leaves"]})

            # 5. bench_preempt_resume's readings: interval-paced async
            #    saves and blocking saves against bare steps, resume to
            #    parity
            state = _fresh_train_state(cfg, SEED, dev)
            amgr = CheckpointManager(os.path.join(root, "async"), keep=2,
                                     interval=RESUME_INTERVAL)
            paced_ms = []

            def paced(i):
                # on_step's blocking time: the snapshot, after waiting out
                # the previous save's write
                t = time.perf_counter()
                if amgr.on_step(i, lambda: state) is not None:
                    paced_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _train_run(step, state, batches, 0, n, paced)
            t_async = time.perf_counter() - t0
            assert amgr.wait() == [] and amgr.steps() == [3, 6]
            l_ref = _train_run(step, state, batches, n, n + 1)[0]
            del state
            torch.cuda.empty_cache()
            state = _fresh_train_state(cfg, SEED, dev)
            bmgr = CheckpointManager(os.path.join(root, "block"), keep=2)
            snap_ms, write_s = [], []

            def blocking(i):
                # save(block=True) in two timed halves: the snapshot
                # (save returns) and the write (the handle resolves)
                if i % RESUME_INTERVAL == 0:
                    t = time.perf_counter()
                    h = bmgr.save(state, i)
                    snap_ms.append((time.perf_counter() - t) * 1e3)
                    h.wait()
                    write_s.append(time.perf_counter() - t - snap_ms[-1] / 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _train_run(step, state, batches, 0, n, blocking)
            t_block = time.perf_counter() - t0
            del state
            shutil.rmtree(bmgr.root)
            torch.cuda.empty_cache()
            tmpl = _fresh_train_state(cfg, SEED + 1, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = amgr.restore(tmpl)
            l_res = _train_run(step, tmpl, batches, n, n + 1)[0]
            resume_ms = (time.perf_counter() - t0) * 1e3
            assert got == n and l_res == l_ref == ref[n], (got, l_res, l_ref)
            del tmpl, step
            torch.cuda.empty_cache()
            bench = {
                "train_steps_timed": n, "saves_per_run": n // RESUME_INTERVAL,
                "step_time_plain_ms": t_plain / n * 1e3,
                "save_overlap_overhead_pct": (t_async / t_plain - 1) * 100,
                "blocking_save_overhead_pct": (t_block / t_plain - 1) * 100,
                "resume_to_parity_ms": resume_ms, "resume_step": got,
                "resume_loss_bitwise": l_res == l_ref,
                "snapshot_blocking_ms": snap_ms, "write_s": write_s,
                "on_step_blocking_ms": paced_ms,
                "gb_written_per_save": nbytes / 1e9}
            out["bench_preempt_resume"] = bench
            rss.mark("bench_preempt_resume")
            print(f"bench_preempt_resume: bare {t_plain / n * 1e3:.1f} ms a "
                  f"step; interval-paced async saves "
                  f"{bench['save_overlap_overhead_pct']:+.1f}%, blocking "
                  f"saves {bench['blocking_save_overhead_pct']:+.1f}% over "
                  f"{n} steps with {n // RESUME_INTERVAL} saves; "
                  f"resume_to_parity_ms {resume_ms:.1f}; snapshot blocking "
                  f"{[round(x, 1) for x in snap_ms]} ms (on_step with the "
                  f"async saves {[round(x, 1) for x in paced_ms]} ms); "
                  f"{nbytes / 1e9:.2f} GB a save, write "
                  f"{[round(x, 2) for x in write_s]} s")
            out["tiny_leaves"] = check_tiny_checkpoint(dev, root)
            rss.mark("tiny")
        out["peak_host_rss_gb"] = rss.peak / 1e9
        out["peak_host_rss_gb_by_stretch"] = rss.marks
        out["wall_s"] = time.perf_counter() - t_phase
        print(f"peak host RSS {rss.peak / 1e9:.2f} GB (GB by stretch: "
              f"{rss.marks}); resume phase {out['wall_s']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if old_faults is None:
            os.environ.pop(faults.ENV_FAULTS, None)
        else:
            os.environ[faults.ENV_FAULTS] = old_faults
    return out


def _fleet_requests(prompts):
    from paddle_tpu_torch import Request
    return [Request(list(p), max_new_tokens=FLEET_NEW, arrival=float(2 * i))
            for i, p in enumerate(prompts)]


def _fleet_run(name, make, prompts, **run_kw):
    """One deterministic fleet run with the kernel counts set to 0 just
    before it and read just after: RMSNorm (row 1) and the paged decode
    (row 3) launched, nothing else. Returns (fleet, stats, wall s)."""
    fleet = make()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    stats = fleet.run(_fleet_requests(prompts), deterministic=True, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {k: v for k, v in _counts().items() if v}
    assert set(ran) == {"rms_norm", "paged_attend_update"}, (name, ran)
    assert stats["lost"] == 0 and stats["requests"] == FLEET_REQUESTS, \
        (name, stats)
    assert all(fleet.engines[i].pool.used_blocks == 0
               for i in fleet._live()), name
    hits = sum(e.cache.hit_tokens for e in fleet.engines)
    print(f"  {name}: {wall:.2f} s, {stats['generated_tokens'] / wall:.1f} "
          f"tokens/s, routed {stats['routed_per_replica']}, affinity hit "
          f"rate {stats['affinity_hit_rate']}, cache hit tokens {hits}, "
          f"spills {stats['spills']}, migrations {stats['migrations']}, "
          f"launches {ran}")
    return fleet, stats, wall, ran


def _migrated_streams(fleet, ref):
    """The kill run's streams against the lone engine's: every request
    the dead replica did not hold is bitwise the reference; a migrated
    one keeps every token its journal holds verbatim (the reference's
    own), and its re-derived tokens are reported, not asserted: the
    survivor re-prefills prompt + history, whose bf16 KV rounds apart
    from the decode's (serve-ops' crash and recover shows the same)."""
    from paddle_tpu_torch import read_journal
    got = fleet.streams()
    moved = {rid for rid, _, kind, _ in fleet.routing_log
             if kind.startswith("migrate:")}
    journaled = read_journal(fleet.engines[fleet.dead[0]].journal_path).tokens
    assert set(got) == set(ref)
    for rid in ref:
        if rid not in moved:
            assert got[rid] == ref[rid], rid
        else:
            toks = journaled.get(rid, [])
            assert got[rid][:len(toks)] == toks == ref[rid][:len(toks)], rid
            assert len(got[rid]) == FLEET_NEW, rid
    same, first = _divergence({r: got[r] for r in moved}, ref)
    kept = {rid: len(journaled.get(rid, [])) for rid in moved}
    print(f"  kill: {len(ref) - len(moved)} streams not migrated, all "
          f"bitwise the lone engine's; {len(moved)} migrated, journaled "
          f"tokens kept verbatim {kept}; {len(same)} of them bitwise, first "
          f"divergent index of the others {first}")
    return {"migrated": sorted(moved), "journaled_tokens": kept,
            "migrated_streams_equal": len(same), "first_divergence": first}


def fleet_phase(dev):
    """bench.py bench_serve_fleet's on-chip trace on llama_7b (bf16, 32
    layers, seeded random weights), FLEET_N replicas of FLEET_SERVE
    sharing one weight tree: a lone engine as the reference, then the
    fleet under affinity and under random dispatch, with a replica killed
    mid-burst (journals on), and with a rolling swap whose source is a
    CheckpointManager root holding the same weights. Streams must equal
    the lone engine's, nothing may be lost or dropped."""
    from paddle_tpu_torch import (FleetRouter, InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    phase(f"fleet: FleetRouter over {FLEET_N} InferenceEngine replicas of "
          f"llama_7b (bf16, 32 layers), bench_serve_fleet's trace of "
          f"{FLEET_REQUESTS} requests; lone engine, affinity, random, a "
          f"kill, a rolling swap from a checkpoint root")
    t_phase = time.perf_counter()
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=SEED, device=dev)
    rng = np.random.RandomState(20)
    system = rng.randint(1, cfg.vocab_size, size=FLEET_SYSTEM).tolist()
    prompts = [system + rng.randint(1, cfg.vocab_size,
                                    size=rng.randint(*FLEET_TAIL)).tolist()
               for _ in range(FLEET_REQUESTS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    out = {"replicas": FLEET_N, "requests": FLEET_REQUESTS}
    try:
        nbytes = _tree_bytes(params)
        _need_disk(root, nbytes + (1 << 30), "the fleet phase")
        eng = InferenceEngine(params, cfg, ServeConfig(**FLEET_SERVE),
                              device=dev)
        reqs = _fleet_requests(prompts)
        for i, r in enumerate(reqs):
            r.request_id = i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs, deterministic=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = {s.req.request_id: list(s.generated) for s in eng.finished}
        assert len(ref) == FLEET_REQUESTS and \
            all(len(t) == FLEET_NEW for t in ref.values())
        out["lone"] = {"wall_s": wall, "tokens_per_sec":
                       FLEET_REQUESTS * FLEET_NEW / wall,
                       "cache_hit_tokens": eng.cache.hit_tokens}
        print(f"  lone engine: {wall:.2f} s, "
              f"{out['lone']['tokens_per_sec']:.1f} tokens/s, cache hit "
              f"tokens {eng.cache.hit_tokens}")
        del eng
        _release_card()

        def make(policy="affinity", journal=False):
            jd = None
            if journal:
                jd = tempfile.mkdtemp(dir=root, prefix="journals_")
            return lambda: FleetRouter(
                params, cfg, ServeConfig(**FLEET_SERVE), n_replicas=FLEET_N,
                journal_dir=jd, policy=policy, seed=5, device=dev)

        runs = {}
        for name, mk, kw in (
                ("affinity", make(), {}),
                ("random", make("random"), {}),
                ("kill", make(journal=True),
                 {"kill_at": (FLEET_REQUESTS, 0)})):
            fleet, stats, wall, ran = _fleet_run(name, mk, prompts, **kw)
            if name == "kill":
                killed = _migrated_streams(fleet, ref)
            else:
                assert fleet.streams() == ref, name
            runs[name] = {
                "wall_s": wall,
                "tokens_per_sec": stats["generated_tokens"] / wall,
                "affinity_hit_rate": stats["affinity_hit_rate"],
                "cache_hit_tokens": sum(e.cache.hit_tokens
                                        for e in fleet.engines),
                "routed_per_replica": stats["routed_per_replica"],
                "spills": stats["spills"],
                "migrations": stats["migrations"], "launches": ran}
            if name == "kill":
                assert stats["migrations"] > 0 and not fleet.alive[0]
                runs[name].update(killed)
            del fleet
            _release_card()

        # the rolling swap's source: a manager root holding the same
        # weights, saved once
        mgr = CheckpointManager(os.path.join(root, "weights"), keep=1)
        t0 = time.perf_counter()
        mgr.save({"params": params, "step": 0}, 0, block=True)
        save_s = time.perf_counter() - t0
        fleet, stats, wall, ran = _fleet_run(
            "rolling swap", make(), prompts, rolling_swap_at=3,
            swap_source=mgr.root)
        swaps = [e.last_swap for e in fleet.engines]
        assert stats["rolling_swaps"] == FLEET_N and \
            fleet.last_rolling_swap == {"swapped": list(range(FLEET_N))}
        assert all(s["source"] == mgr.step_dir(0) and
                   s["in_flight_running"] == 0 == s["in_flight_prefill"]
                   for s in swaps), swaps
        assert fleet.streams() == ref
        runs["rolling_swap"] = {
            "wall_s": wall, "tokens_per_sec": stats["generated_tokens"] / wall,
            "save_s": save_s, "gb": nbytes / 1e9,
            "swap_ms": [s["swap_ms"] for s in swaps],
            "launches": ran}
        print(f"  rolling swap: {nbytes / 1e9:.2f} GB saved in {save_s:.2f} "
              f"s; swap_ms per replica "
              f"{[round(s['swap_ms'], 1) for s in swaps]} (each reads the "
              f"checkpoint into the shared tree); no drops; streams equal")
        del fleet
        _release_card()
        out.update(runs)
        out["wall_s"] = time.perf_counter() - t_phase
        print(f"fleet phase {out['wall_s']:.1f} s; N = 4 is left out: 4 x "
              f"17.2 GB of pools and 13.5 GB of weights exceed the card")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del params
        _release_card()
    return out


# train-dp: dp, ZeRO sharding and tensor parallelism (mp) over ranks
# sharing the one card (gloo)
DP_LAYERS = 4
DP_STEPS = 2    # step 0 (a process's first also warms gloo's buffers), 1
# (name, world, ParallelConfig fields, layers, steps); stage 3 takes one
# step at DP_LAYERS for the script's time (it ran 16 layers, 21 s a step
# through the host, until serve-tp came: chip_smoke took 1091.8 s on an
# NVIDIA H100 80GB HBM3, 700.00 W with it there): dp2_sh2_stage3 holds
# stage 3's second step. mp2_overlap runs the
# fused FFN ring (DP_ENV, set in the rank for that run only). The two
# world-4 mp runs take one step for the script's time (1070.7 s on an
# NVIDIA H100 80GB HBM3, 700.00 W, with both at two steps): dp2_mp2 step
# 0, held to the single process's step-0 params, and mp2_sh2_stage3 step
# 1 from mp2's checkpoint (DP_RESTORE_INTO), held to its 2-step params;
# the CPU tests hold those compositions over three steps
DP_RUNS = [
    ("dp2", 2, dict(dp=2), DP_LAYERS, DP_STEPS),
    ("sh2_stage1", 2, dict(sharding=2, zero_stage=1), DP_LAYERS, DP_STEPS),
    ("sh2_stage2", 2, dict(sharding=2, zero_stage=2), DP_LAYERS, DP_STEPS),
    ("sh2_stage3", 2, dict(sharding=2, zero_stage=3), DP_LAYERS, 1),
    ("mp2", 2, dict(mp=2), DP_LAYERS, DP_STEPS),
    ("mp2_overlap", 2, dict(mp=2), DP_LAYERS, DP_STEPS),
    ("dp2_sh2_stage3", 4, dict(dp=2, sharding=2, zero_stage=3), DP_LAYERS,
     DP_STEPS),
    ("dp2_mp2", 4, dict(dp=2, mp=2), DP_LAYERS, 1),
    ("mp2_sh2_stage3", 4, dict(mp=2, sharding=2, zero_stage=3), DP_LAYERS,
     1),    # restored from mp2's checkpoint: its step is step 1
    # pipeline parallelism: pp 2 over 4 microbatches of one row, its
    # overlapped schedule (one step, bitwise pp2's step 0: DP_BITWISE), pp 4
    # (one layer a stage) and pp 2 x mp 2
    ("pp2", 2, dict(pp=2, microbatches=4), DP_LAYERS, DP_STEPS),
    ("pp2_overlap", 2, dict(pp=2, microbatches=4, overlap_p2p=True),
     DP_LAYERS, 1),
    ("pp4", 4, dict(pp=4, microbatches=4), DP_LAYERS, 1),
    ("pp2_mp2", 4, dict(pp=2, mp=2, microbatches=4), DP_LAYERS, 1),
]
# the pp 2 pair runs the split flash backward (rows 17, 18), whose sums
# take a fixed order, so the overlapped step can be held bitwise to the
# blocking one; pp4 and pp2_mp2 run the fused backward (row 16)
_SPLIT = {"PADDLE_TPU_TORCH_FLASH_BWD": "split"}
DP_ENV = {"mp2_overlap": {"PADDLE_TPU_TORCH_TP_OVERLAP": "1"},
          "pp2": _SPLIT, "pp2_overlap": _SPLIT}
# run -> (the run whose first step it must equal bit for bit)
DP_BITWISE = {"pp2_overlap": "pp2"}
# elastic resume: mp2 (world 2) saves its state after its first step with
# a CheckpointManager, and mp2_sh2_stage3 (world 4) restores it instead
# of starting from the seed and takes the remaining step (DP_SAVE_AT + 1
# of the single process's two): another world size, mp x sharding split
# and ZeRO stage-3 param shards
DP_SAVE_FROM, DP_RESTORE_INTO, DP_SAVE_AT = "mp2", "mp2_sh2_stage3", 1
# a rank's bf16 products run at B/W rows, and cuBLAS may round them apart
# from the single process's B rows: step 0's loss within 2^-10 relative,
# step 1's within 2^-12 (the sound runs read at most 1.15e-4; the
# control that skips step 0 moves step 1's loss by 4.4e-4 and must fail)
DP_STEP0_RTOL = 2 ** -10
DP_LATER_RTOL = 2 ** -12
# each rank's part of each param leaf after the steps against the single
# process's, relative Frobenius error of the worst leaf: the sound runs
# read 1.2e-3 to 1.4e-3 (bf16 params a rounding apart), the faulty
# controls (dp_references) 7.8e-3 to 2.2e-2, and each control must read
# above the limit
DP_PARAM_REL = 2 ** -8
DP_JOIN_S = 900


def bits_checksum(t):
    """An order-sensitive checksum of a tensor's bits, summed on the
    device in chunks of 2^26 elements."""
    bits = t.detach().reshape(-1).view(
        torch.int16 if t.element_size() == 2 else torch.int32)
    acc = 0
    for chunk in torch.split(bits, 1 << 26):
        pos = torch.arange(1, chunk.numel() + 1, device=t.device)
        acc = (acc * 1000003 + int((chunk.long() * pos).sum())) % (1 << 61)
    return acc


def pp_reckoning(cfg, kw, layers, stage):
    """Collective bytes a step of a pp rank at ``stage`` (dp and sharding
    1): T = M + S - 1 ticks (M + 2(S - 1) overlapped), each a hop of one
    microbatch [B/M, S, H] bf16 forward and its reverse in the backward;
    embed's, lm_head's (their mp blocks) and final_norm's gradients and
    the f32 loss all-reduced over pp. With mp, a layer's five [B, S, H]
    all-reduces of ``dp_reckoning`` over this stage's L/S layers (M
    microbatches of B/M rows), and the whole embed gathered on stage 0
    and the whole lm_head on the last (the pipeline's loss is the plain
    cross entropy)."""
    import collections
    c = cfg
    H, V, mp = c.hidden_size, c.vocab_size, kw.get("mp", 1)
    S = kw["pp"]
    M = max(kw.get("microbatches", 1), S)
    T = M + (2 if kw.get("overlap_p2p") else 1) * (S - 1)
    out = collections.Counter()
    out["ppermute.pp"] = 2 * T * 2 * (TRAIN_B // M) * TRAIN_S * H
    head = 0 if c.tie_word_embeddings else 2 * H * V // mp
    out["all_reduce.pp"] = 2 * V * H // mp + head + 2 * H + 4
    if mp > 1:
        out["all_reduce.mp"] = 5 * (layers // S) * 2 * TRAIN_B * TRAIN_S * H
        gathered = (2 * V * H if stage == 0 else 0) + (
            2 * V * H if stage == S - 1 and not c.tie_word_embeddings
            else 0)
        if gathered:
            out["all_gather.mp"] = gathered
    return out


def pp_launches(L, kw, stage, split):
    """Launches of rows 1, 14 and 16 (or 17 and 18 under ``split``) on a
    pp rank at ``stage`` in one step under full remat: its L/S layers run
    on its M active ticks, a layer's forward both norms and one flash
    forward, its recompute the same again, its backward one flash
    backward; the last stage also the final norm."""
    S = kw["pp"]
    n = (L // S) * max(kw.get("microbatches", 1), S)
    out = {"rms_norm": 4 * n + (stage == S - 1), "flash_fwd": 2 * n,
           "flash_bwd": 0 if split else n}
    if split:
        out.update(flash_bwd_dkv=n, flash_bwd_dq=n)
    return out


def dp_reckoning(cfg, kw, layers, env=None, stage=0):
    """Collective bytes a step of one rank, by "op.axis", from the shapes
    (bf16 params, each matrix, embed and lm_head 1/mp of it on a rank;
    the count and the loss are one f32 each, over the dp x sharding
    ranks): dp all-reduces every gradient; stage 1 all-reduces them over
    dp x sharding and all-gathers the updated params; stage 2 reduces
    each layer slice to its owner and reduce-scatters embed, lm_head and
    final_norm, then all-gathers the params; stage 3 all-gathers each
    layer twice under full remat (forward and recompute) and embed and
    lm_head once, reduce-scatters every sharded gradient once,
    all-reduces the norms' over dp x sharding and the shards' over dp.
    mp all-reduces [b, S, H] bf16 (b the rank's rows) for the embedding
    and lm_head's input gradient, and per layer twice forward, once in
    the recompute (it stops after the layer's last saved tensor, before
    down_proj's) and twice backward, plus the cross entropy's three
    [b, S] f32 reductions; with the rings (``env``
    PADDLE_TPU_TORCH_TP_OVERLAP) down_proj's all-reduce becomes
    2 (mp - 1) hops of [b S / mp, H] forward and again in the
    recompute. A pp run (``stage`` its rank's): :func:`pp_reckoning`."""
    import collections
    c = cfg
    L, H, I, V = layers, c.hidden_size, c.intermediate_size, c.vocab_size
    qd = c.num_attention_heads * c.head_dim
    kvd = c.num_key_value_heads * c.head_dim
    dp, sh, mp = kw.get("dp", 1), kw.get("sharding", 1), kw.get("mp", 1)
    mats = 2 * L * (2 * H * qd + 2 * H * kvd + 3 * H * I) // mp
    layer_norms = 2 * 2 * L * H
    emb = 2 * V * H // mp
    head = 0 if c.tie_word_embeddings else 2 * H * V // mp
    total = mats + layer_norms + emb + head + 2 * H
    world = "dp" if sh == 1 else "sharding" if dp == 1 else "dp,sharding"
    out = collections.Counter()
    if kw.get("pp", 1) > 1:
        return dict(pp_reckoning(c, kw, layers, stage))
    if mp > 1:
        rows = TRAIN_B // (dp * sh)
        act = 2 * rows * TRAIN_S * H
        overlap = (env or {}).get("PADDLE_TPU_TORCH_TP_OVERLAP") == "1"
        out["all_reduce.mp"] = (2 + (4 if overlap else 5) * L) * act \
            + 3 * 4 * rows * TRAIN_S
        if overlap:
            out["ppermute.mp"] = 4 * (mp - 1) * L * act // mp
    if dp * sh == 1:
        return dict(out)
    out[f"all_reduce.{world}"] += 8
    if sh == 1:
        out[f"all_reduce.{world}"] += total
        return dict(out)
    stage = kw.get("zero_stage", 3)
    if stage <= 1:
        out[f"all_reduce.{world}"] += total
        out["all_gather.sharding"] += total
    elif stage == 2:
        out["reduce.sharding"] += mats + layer_norms
        out["reduce_scatter.sharding"] += emb + head + 2 * H
        out["all_gather.sharding"] += total
        if dp > 1:
            out["all_reduce.dp"] += total // sh
    else:
        out["all_gather.sharding"] += 2 * mats + emb + head
        out["reduce_scatter.sharding"] += mats + emb + head
        out[f"all_reduce.{world}"] += layer_norms + 2 * H
        if dp > 1:
            out["all_reduce.dp"] += (mats + emb + head) // sh
    return dict(out)


def dp_state_reckoning(cfg, kw, layers):
    """Bytes a rank holds for params (bf16), gradients (bf16) and f32
    moments, 12 a param on one rank, of the params it holds (mp keeps
    1/mp of every matrix, embed and lm_head, and whole norms; a pp stage
    its L/S layers, embed, final_norm and lm_head): dp keeps
    all of it; stage 1 shards the moments, stage 2 also the gradients,
    stage 3 everything, plus the full bf16 weights (of its mp slice) of
    one gathered layer, embed and lm_head."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    c = dataclasses.replace(cfg, num_hidden_layers=layers)
    sh, stage = kw.get("sharding", 1), kw.get("zero_stage", 3)
    mp = kw.get("mp", 1)

    def held(layers):
        n = tl.count_params(dataclasses.replace(c, num_hidden_layers=layers))
        norms = (2 * layers + 1) * c.hidden_size
        return (n - norms) // mp + norms
    n = held(layers // kw.get("pp", 1))
    if sh == 1:
        return 12 * n
    if stage <= 1:
        return 4 * n + 8 * n // sh
    if stage == 2:
        return 2 * n + 10 * n // sh
    layer = held(1) - held(0)
    head = c.vocab_size * c.hidden_size * (
        1 if c.tie_word_embeddings else 2) // mp
    return 12 * n // sh + 2 * (layer + head)


def _at(tree, name):
    """The leaf of ``tree`` at path ``name`` ("layers/q_proj")."""
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _sq_sums(a, b):
    """(sum of (a - b)^2, sum of b^2) in f64, in chunks along dim 0 so the
    f64 temporaries stay small."""
    n = max(1, (1 << 24) // max(1, b[0].numel())) if b.ndim else 1
    d2 = r2 = torch.zeros((), dtype=torch.float64, device=b.device)
    for x, y in zip(a.split(n) if a.ndim else [a],
                    b.split(n) if b.ndim else [b]):
        y = y.double()
        d2 = d2 + (x.double() - y).square().sum()
        r2 = r2 + y.square().sum()
    return float(d2), float(r2)


def leaf_rel_errors(p, ref, cfg=None, par=None):
    """{leaf: relative Frobenius error of ``p`` against ``ref``}, both
    param trees on the card. With ``cfg`` and ``par`` (a rank's), ``p``
    holds this rank's shards and ``ref`` the full leaves: each leaf is
    held against the slice of ``ref`` that the rank holds."""
    from paddle_tpu_torch.models import llama as tl
    if par is not None:
        degrees, coord = tl._mesh_place(par)
        specs = tl.train_state_pspecs(cfg, par)[0]
        ref = tl.stage_layers(ref, cfg, par)    # a pp stage's layer slices
    out = {}
    for name, (t,) in _grad_items(p):
        r = _at(ref, name)
        if par is not None:
            for d, parts, index in tl._split_dims(_at(specs, name), degrees,
                                                  coord):
                n = r.shape[d] // parts
                r = r.narrow(d, index * n, n)
        d2, r2 = _sq_sums(t, r)
        out[name] = (d2 / r2) ** 0.5
    return out


def _worst(errs):
    name = max(errs, key=errs.get)
    return errs[name], name


def dp_references(dev):
    """The single process's runs that train-dp is held to (the same seed
    and batches): DP_STEPS steps at DP_LAYERS and its step 0 alone, their
    losses and params (kept on the card for the ranks). Three faulty runs are read as controls that the limits
    must fail: step 1 skipped (its params are step 0's), step 1 on half
    the batch (a rank's rows dropped), step 0 skipped (step 1 from the
    seeded params; its loss is read too). Returns ({(layers, steps):
    (losses, params)}, {control: (worst leaf's error, leaf)}, the skipped
    step 0's step-1 loss gap)."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    batches = train_batches(tl.llama_7b().vocab_size, DP_STEPS)
    x0, x1 = batches[0], batches[1]

    def clone(tree):
        return tl._tree_map(torch.clone, tree)
    cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=DP_LAYERS)
    step, p, o = tl.build_train_step(cfg, tl.ParallelConfig(), seed=SEED,
                                     device=dev)
    p0 = clone(p)
    p, o, l0 = step(p, o, x0[:, :-1], x0[:, 1:])
    p_step0, p1, o1 = clone(p), clone(p), clone(o)
    p, o, l1 = step(p, o, x1[:, :-1], x1[:, 1:])
    losses = [float(l0), float(l1)]
    controls = {"step 1 skipped": _worst(leaf_rel_errors(p1, p))}
    half = TRAIN_B // 2
    p1, _, _ = step(p1, o1, x1[:half, :-1], x1[:half, 1:])
    controls["step 1 on half the batch"] = _worst(leaf_rel_errors(p1, p))
    del p1, o1
    p0, _, skipped = step(p0, tl._adamw_init(p0), x1[:, :-1], x1[:, 1:])
    controls["step 0 skipped"] = _worst(leaf_rel_errors(p0, p))
    loss_gap = _rel(float(skipped), losses[1])
    del step, o, p0
    refs = {(DP_LAYERS, DP_STEPS): (losses, p),
            (DP_LAYERS, 1): (losses[:1], p_step0)}
    gc.collect()
    torch.cuda.empty_cache()
    return refs, controls, loss_gap


def _dp_start(name):
    """The step a train-dp run starts from: the restored run's is the
    step its checkpoint was saved at."""
    return DP_SAVE_AT if name == DP_RESTORE_INTO else 0


def train_dp_rank(rank, world, runs, dev, t_spawn, refs, ckpt_root,
                  moe_refs):
    """One rank of the train-dp phase (spawned; the process group is up):
    each run of ``runs`` at this world size on ``dev``, its losses, step
    ms, peak memory, state bytes, launches, collective calls and bytes a
    step, mesh coordinates, a checksum of each local param leaf and each
    leaf's error against the single process's params (``refs``, by
    (layers, steps): the parent's tensors on the card); and the seconds
    since ``t_spawn`` (the parent's clock) at which it began and ended.
    DP_SAVE_FROM saves its state after step DP_SAVE_AT under
    ``ckpt_root`` (the save's blocking and total seconds), and
    DP_RESTORE_INTO restores it there (the coordinator's verify and the
    load seconds, and the leaves whose bits differ from their saved
    slices) before its steps. Then the ERNIE runs of MOE_DP_RUNS at this
    world (:func:`moe_dp_rank_runs`, held to ``moe_refs``: the single
    process's params and first-batch gradients)."""
    began = time.time() - t_spawn
    import dataclasses
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.testing.dist import restored_mismatches
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = train_batches(tl.llama_7b().vocab_size,
                            max(r[4] for r in runs))
    out = {}
    for name, w, kw, layers, steps in runs:
        if w != world:
            continue
        cfg = dataclasses.replace(tl.llama_7b(), num_hidden_layers=layers)
        par = tl.ParallelConfig(remat=True, remat_policy="full", **kw)
        env = DP_ENV.get(name, {})
        os.environ.update(env)
        t0 = time.perf_counter()
        ckpt, start, first = {}, _dp_start(name), None
        if name == DP_RESTORE_INTO:
            mgr = CheckpointManager(ckpt_root)
            step, st, got = tl.restore_train_step(cfg, par, mgr, seed=SEED,
                                                  device=dev)
            p, o = st["params"], st["opt"]
            torch.cuda.synchronize()
            bad, n = restored_mismatches(st, mgr.step_dir(got),
                                         step.layout)
            ckpt = {"restored_step": got, "leaves_compared": n,
                    "leaves_differing": bad, **mgr.last_restore}
        else:
            step, p, o = tl.build_train_step(cfg, par, seed=SEED,
                                             device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t_run = t0
        state = _tree_bytes(p) + _tree_bytes({"m": o["m"], "v": o["v"]})
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        trace.reset_counters()
        losses, step_ms = [], []
        for i, x in enumerate(batches[start:start + steps], start):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, loss = step(p, o, x[:, :-1], x[:, 1:])
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and name in DP_BITWISE.values():
                first = {k: bits_checksum(ts[0])
                         for k, ts in _grad_items(p)}
            if name == DP_SAVE_FROM and i + 1 == DP_SAVE_AT:
                mgr = CheckpointManager(ckpt_root, layout=step.layout)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = mgr.save({"params": p, "opt": o, "step": i + 1}, i + 1)
                blocking = time.perf_counter() - t0
                h.wait()
                ckpt = {"saved_step": i + 1, "blocking_s": blocking,
                        "total_s": time.perf_counter() - t0,
                        "bytes": state}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for k in env:
            del os.environ[k]
        comm = {k[len("comm."):]: v / steps
                for k, v in trace.counters().items() if k.startswith("comm.")}
        out[name] = {
            "tp_plans": {k: v for k, v in trace.counters().items()
                         if k.startswith("tp.")},
            "losses": losses, "step_ms": step_ms, "build_s": build_s,
            "peak_bytes": peak, "state_bytes": state, "launches": _counts(),
            "comm_per_step": comm,
            "coord": step.hcg.topology().get_coord(step.hcg.global_rank),
            "checksums": {k: bits_checksum(ts[0])
                          for k, ts in _grad_items(p)},
            "param_rel": leaf_rel_errors(p, refs[(layers, start + steps)],
                                         cfg, par),
            "first_step_checksums": first,
            "checkpoint": ckpt, "run_s": time.perf_counter() - t_run}
        del step, p, o
        gc.collect()
        torch.cuda.empty_cache()
    refs.clear()    # releases the parent's tensors (their IPC handles)
    gc.collect()
    out.update(moe_dp_rank_runs(world, dev, *moe_refs))
    for held in moe_refs:
        held.clear()
    gc.collect()
    return {"runs": out, "began_s": began, "ended_s": time.time() - t_spawn}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def train_dp(dev):
    """build_train_step at llama_7b's width over dp, ZeRO sharding, mp
    (alone, with the fused FFN ring, and composed with dp and with
    sharding at stage 3) and pp (alone, overlapped, at 4 stages and
    composed with mp), W ranks (spawned processes) sharing cuda:0
    through gloo, which stages each CUDA tensor through the host: a
    check of correctness and memory per rank, not of collective speed.
    Losses and params are held to the single process's (dp_references),
    whose faulty controls must fail the same limits. The elastic check
    rides it: DP_SAVE_FROM's world-2 checkpoint (under a temp directory,
    removed whatever happens) is restored by DP_RESTORE_INTO's four ranks,
    each rank's restored shards held bitwise to its slices of the saved
    leaves."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    phase(f"train-dp llama_7b width (bf16, B={TRAIN_B}, S={TRAIN_S}, full "
          f"remat, AdamW f32 moments): dp, ZeRO stages 1-3, mp and pp over "
          f"2 and 4 ranks sharing the card (gloo)")
    refs, controls, skip_gap = dp_references(dev)
    fails, res = [], {}
    for c, (err, leaf) in controls.items():
        print(f"control ({c}, {DP_LAYERS} layers): worst leaf {leaf} "
              f"{err:.4e} against the limit {DP_PARAM_REL:.4e}")
        if err <= DP_PARAM_REL:
            fails.append(f"control {c}: params {err} within DP_PARAM_REL")
    print(f"control (step 0 skipped): step-1 loss gap {skip_gap:.4e} "
          f"against the limit {DP_LATER_RTOL:.4e}")
    if skip_gap <= DP_LATER_RTOL:
        fails.append(f"control step 0 skipped: step-1 loss gap {skip_gap} "
                     f"within DP_LATER_RTOL")
    res["controls"] = {c: {"param_rel": e, "leaf": leaf}
                       for c, (e, leaf) in controls.items()}
    res["controls"]["step 0 skipped"]["loss_rel_gap"] = skip_gap
    for (layers, steps), (losses, _) in refs.items():
        print(f"single process, {layers} layers, {steps} steps: losses "
              f"{losses}")
    t0 = time.perf_counter()
    moe_refs, moe_grads, moe_control = moe_dp_references(dev)
    for (cname, steps), (_, lm, losses, drops) in moe_refs.items():
        print(f"single process ERNIE {cname}, {steps} step(s): lm losses "
              f"{lm}, losses {losses}, drops {drops}")
    res["moe_references_s"] = time.perf_counter() - t0
    print(f"parent holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"(the references) before spawning")
    root = tempfile.mkdtemp(prefix="paddle_tpu_torch_train_dp_")
    try:
        n = tl.count_params(dataclasses.replace(tl.llama_7b(),
                                                num_hidden_layers=DP_LAYERS))
        # bf16 params and f32 moments, and a tenth for the file system
        _need_disk(root, int(1.1 * 10 * n), "train-dp's checkpoint")
        runs = _train_dp_spawns(refs, dev, root, res, moe_refs, moe_grads)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    moe_info = {k: v[1:] for k, v in moe_refs.items()}
    moe_refs.clear()
    moe_grads.clear()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    res["moe"] = _moe_dp_checks(runs, moe_info, moe_control, fails)
    return _train_dp_checks(runs, res, fails)


def _train_dp_spawns(refs, dev, root, res, moe_refs, moe_grads):
    """The spawns of worlds 2 and 4: {run: every rank's report}."""
    from paddle_tpu_torch.testing.dist import spawn
    runs = {}
    for world in (2, 4):
        keep = {(r[3], _dp_start(r[0]) + r[4]) for r in DP_RUNS
                if r[1] >= world}
        for key in [k for k in refs if k not in keep]:
            del refs[key]       # no run of this world or later needs it
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        # small arguments (the references go as CUDA handles): a start
        # waits until its rank has read them
        ranks = spawn(train_dp_rank, world,
                      (DP_RUNS, dev, t0, {k: v[1] for k, v in refs.items()},
                       root, ({k: v[:1] for k, v in moe_refs.items()
                               if any(r[1] == world and (r[4], r[6]) == k
                                      for r in MOE_DP_RUNS)},
                              {k: g for k, g in moe_grads.items()
                               if any(r[1] == world and r[4] == k
                                      and r[0] in MOE_GRAD_RUNS
                                      for r in MOE_DP_RUNS)})),
                      timeout=DP_JOIN_S)
        joined = time.time() - t0
        print(f"world {world}: ranks began at "
              f"{[round(r['began_s'], 1) for r in ranks]} s, ended at "
              f"{[round(r['ended_s'], 1) for r in ranks]} s, joined at "
              f"{joined:.1f} s")
        res[f"world{world}_s"] = {"began": [r["began_s"] for r in ranks],
                                  "ended": [r["ended_s"] for r in ranks],
                                  "joined": joined}
        for name in ranks[0]["runs"]:
            runs[name] = [r["runs"] for r in ranks]
        for name, w, _, layers, steps in DP_RUNS:
            start = _dp_start(name)
            if w == world:
                res[name] = {"single_process_losses":
                             refs[(layers, start + steps)][0][start:]}
    refs.clear()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    return runs


def _train_dp_checks(runs, res, fails):
    """train-dp's checks and prints of every run's ranks."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    for name, world, kw, layers, steps in DP_RUNS:
        per = [r[name] for r in runs[name]]
        c = dataclasses.replace(tl.llama_7b(), num_hidden_layers=layers)
        losses = per[0]["losses"]
        if any(r["losses"] != losses for r in per):
            fails.append(f"{name}: ranks report different losses "
                         f"{[r['losses'] for r in per]}")
        # dp replicas (the same sharding and mp coordinates) hold the
        # same bits; stage 3's other shards and the other mp ranks agree
        # on the replicated norms only; pp stages hold other layers and
        # the same embed, final_norm and lm_head
        stage3 = kw.get("sharding", 1) > 1 and kw.get("zero_stage", 3) >= 3
        for a in per:
            for b in per:
                same = a["coord"][4] == b["coord"][4] and (
                    a["coord"][2] == b["coord"][2] or not stage3)
                bad = [k for k in a["checksums"] if (same or "norm" in k)
                       and (a["coord"][1] == b["coord"][1]
                            or not k.startswith("layers/"))
                       and a["checksums"][k] != b["checksums"][k]]
                if bad:
                    fails.append(f"{name}: ranks {a['coord']} and "
                                 f"{b['coord']} differ in {bad}")
        if name in DP_BITWISE:
            ref = [r[DP_BITWISE[name]] for r in runs[DP_BITWISE[name]]]
            if losses != ref[0]["losses"][:1] or any(
                    a["checksums"] != b["first_step_checksums"]
                    for a, b in zip(per, ref)):
                fails.append(f"{name}: not bitwise {DP_BITWISE[name]}'s "
                             f"first step (losses {losses}, "
                             f"{ref[0]['losses'][:1]})")
        single = res[name]["single_process_losses"]
        gaps = [_rel(x, y) for x, y in zip(losses, single)]
        limits = [DP_STEP0_RTOL if _dp_start(name) + k == 0 else
                  DP_LATER_RTOL for k in range(len(gaps))]
        if any(g > lim for g, lim in zip(gaps, limits)):
            fails.append(f"{name}: losses {losses} against one process's "
                         f"{single}: gaps {gaps}")
        worst = max((_worst(r["param_rel"]) + (rank,)
                     for rank, r in enumerate(per)))
        if worst[0] > DP_PARAM_REL:
            fails.append(f"{name}: rank {worst[2]}'s {worst[1]} is "
                         f"{worst[0]} off the single process's params")
        env = DP_ENV.get(name, {})
        split = env.get("PADDLE_TPU_TORCH_FLASH_BWD") == "split"

        def want_of(r):     # launches a rank's steps, by its pp stage
            if kw.get("pp", 1) == 1:
                once = step_launches(layers, "full")
            else:
                once = pp_launches(layers, kw, r["coord"][1], split)
            return {k: v * steps for k, v in once.items()}
        state_gb = dp_state_reckoning(c, kw, layers) / 1e9
        if env.get("PADDLE_TPU_TORCH_TP_OVERLAP") and not all(
                r["tp_plans"].get("tp.fused_ffn.plans", 0) >= 1 for r in per):
            fails.append(f"{name}: the fused FFN plan did not apply: "
                         f"{[r['tp_plans'] for r in per]}")
        for rank, r in enumerate(per):
            want = want_of(r)
            r["launches"] = {k: r["launches"][k] for k in want}
            if r["launches"] != want:
                fails.append(f"{name} rank {rank}: launches "
                             f"{r['launches']}, want {want}")
            r["reckoned"] = dp_reckoning(c, kw, layers, env, r["coord"][1])
            comm = {k[:-len(".bytes")]: v for k, v in
                    r["comm_per_step"].items() if k.endswith(".bytes")}
            if comm != r["reckoned"]:
                fails.append(f"{name} rank {rank}: collective bytes a step "
                             f"{comm}, reckoned {r['reckoned']}")
        res[name].update({
            "world": world, "parallel": kw, "layers": layers,
            "steps": steps, "losses": losses, "loss_rel_gaps": gaps,
            "param_rel_worst": {"err": worst[0], "leaf": worst[1],
                                "rank": worst[2]},
            "reduced": (f"num_hidden_layers 32 -> {layers}"
                        + ("" if layers == TRAIN_LAYERS else
                           f" (two {TRAIN_LAYERS}-layer replicas would need "
                           f"2 x 42.0 GB)")
                        + f", {steps} step{'s' * (steps > 1)}"),
            "state_gb_reckoned": state_gb,
            "run_s": max(r["run_s"] for r in per),
            "ranks": [{k: r[k] for k in ("coord", "peak_bytes",
                                         "state_bytes", "step_ms",
                                         "build_s", "comm_per_step",
                                         "param_rel", "tp_plans",
                                         "checkpoint", "launches",
                                         "reckoned", "run_s")}
                      for r in per]})
        print(f"{name} (world {world}, {layers} layers, {kw}"
              f"{', ' + str(env) if env else ''}): losses "
              f"{losses}; rel gaps to one process {gaps}; params: worst "
              f"leaf {worst[1]} {worst[0]:.4e} (rank {worst[2]}); "
              f"{res[name]['run_s']:.1f} s (the slowest rank's build and "
              f"steps)")
        for rank, r in enumerate(per):
            calls = {k[:-len(".calls")]: v for k, v in
                     r["comm_per_step"].items() if k.endswith(".calls")}
            print(f"  rank {rank} {tuple(r['coord'])}: peak "
                  f"{r['peak_bytes'] / 1e9:.2f} GB, state (params and "
                  f"moments) {r['state_bytes'] / 1e9:.2f} GB; step ms "
                  f"(gloo through the host) {r['step_ms']}; launches "
                  f"{r['launches']}; a step: calls {calls}, bytes "
                  f"{ {k: v for k, v in r['comm_per_step'].items() if k.endswith('.bytes')} }"
                  f" (reckoned {r['reckoned']})")
        print(f"  reckoned: state a rank {state_gb:.2f} GB (params, "
              f"gradients, f32 moments"
              f"{', a gathered layer, embed and lm_head' if stage3 else ''})")
    stage_losses = {n: res[n]["losses"] for n in
                    ("sh2_stage1", "sh2_stage2", "dp2_sh2_stage3")}
    base = stage_losses["sh2_stage1"]
    for n, ls in stage_losses.items():
        gaps = [_rel(x, y) for x, y in zip(ls, base)]
        res[n]["stage1_rel_gaps"] = gaps
        if gaps[0] > DP_STEP0_RTOL or max(gaps) > DP_LATER_RTOL:
            fails.append(f"{n} against sh2_stage1: gaps {gaps}")
    print(f"stages 1, 2, 3 against stage 1 (rel gaps): "
          f"{ {n: res[n]['stage1_rel_gaps'] for n in stage_losses} }")
    res["elastic"] = _elastic_report(runs, fails)
    assert not fails, "\n".join(fails)
    return res


def _elastic_report(runs, fails):
    """The elastic check's seconds (save: blocking and total, the
    slowest rank; restore: the coordinator's verify and each rank's load)
    with the card, and its failures: a restored step other than
    DP_SAVE_AT, or a rank whose restored shards differ in a bit from its
    slices of the saved leaves."""
    saves = [r[DP_SAVE_FROM]["checkpoint"] for r in runs[DP_SAVE_FROM]]
    loads = [r[DP_RESTORE_INTO]["checkpoint"]
             for r in runs[DP_RESTORE_INTO]]
    for rank, c in enumerate(loads):
        if c.get("restored_step") != DP_SAVE_AT or c["leaves_differing"] \
                or not c["leaves_compared"]:
            fails.append(f"{DP_RESTORE_INTO} rank {rank}: restored step "
                         f"{c.get('restored_step')}, {c['leaves_compared']}"
                         f" leaves compared, differing: "
                         f"{c['leaves_differing']}")
    out = {"card": _card_line(), "state_bytes": sum(c["bytes"] for c in saves),
           "save_blocking_s": max(c["blocking_s"] for c in saves),
           "save_total_s": max(c["total_s"] for c in saves),
           "restore_verify_s": max(c["verify_s"] for c in loads),
           "restore_load_s": max(c["load_s"] for c in loads),
           "leaves_compared": [c["leaves_compared"] for c in loads]}
    print(f"elastic ({out['card']}): {DP_SAVE_FROM} (world 2) saved step "
          f"{DP_SAVE_AT}, {out['state_bytes'] / 1e9:.2f} GB of shards, "
          f"blocking {out['save_blocking_s']:.2f} s, total "
          f"{out['save_total_s']:.2f} s; {DP_RESTORE_INTO} (world 4) "
          f"restored it: verify {out['restore_verify_s']:.2f} s (the "
          f"coordinator), load {out['restore_load_s']:.2f} s (the slowest "
          f"rank); each rank's shards bitwise its saved slices "
          f"({out['leaves_compared']} leaves)")
    return out


# ERNIE-MoE over ranks, riding train-dp's spawns: (name, world, ep, dp,
# config, flags, steps, env), all at B = MOE_B, S = MOE_S and full depth.
# moe_ep2 and moe_ep2_overlap run the split flash backward (rows 17, 18),
# whose sums take a fixed order, so the overlapped step can be held
# bitwise to moe_ep2's step 0 (MOE_DP_BITWISE); moe_dp2_capacity is
# ernie-capacity's model (E 8, top-2, capacity dispatch) at dp 2, where
# many pairs drop under the global capacity
_MOE_OVERLAP = {"PADDLE_TPU_TORCH_MOE_A2A_OVERLAP": "1"}
MOE_DP_RUNS = [
    ("moe_ep2", 2, 2, 1, "fine", "a2a", 2, _SPLIT),
    ("moe_ep2_overlap", 2, 2, 1, "fine", "a2a", 1, {**_SPLIT,
                                                     **_MOE_OVERLAP}),
    ("moe_dp2_capacity", 2, 1, 2, "bench", "capacity", 1, {}),
    ("moe_dp2_ep2", 4, 2, 2, "fine", "a2a", 1, {}),
    ("moe_ep4_ragged", 4, 4, 1, "fine", "ragged", 1, {}),
]
MOE_DP_FLAGS = {"a2a": MOE_FLAGS,
                "ragged": dict(MOE_FLAGS, dispatch_mode="ragged"),
                "capacity": dict(with_stats=True)}
MOE_DP_BITWISE = {"moe_ep2_overlap": "moe_ep2"}
MOE_DP_LR = 1e-4
# one run of each dispatch mode also holds its gradients of the first
# batch, before AdamW, to the single process's: each rank's part of each
# leaf (its experts' slice), relative Frobenius error of the worst leaf.
# Adam's first step is nearly blind to a gradient's scale, so a gradient
# counted twice passes the param limit but not this one. In bf16 the
# ranks' partial sums round apart from one process's, and at a later MoE
# layer that breaks some near-ties of top-k apart: the sound runs read
# 6.6e-3 (moe_dp2_capacity, pos), 4.1e-2 (moe_ep4_ragged, e_w1) and
# 0.100 (moe_ep2, the gate, whose function also differs: JAX's aux per
# token shard under ragged_a2a); the control (moe_ep2's expert gradients
# summed over ep as well) 0.876 (tools/moe_dp_runs.py, NVIDIA H100 80GB
# HBM3, 700.00 W). The limit lies 2.5x over the worst sound reading and
# 3.5x under the control
MOE_GRAD_RUNS = ("moe_ep2", "moe_dp2_capacity", "moe_ep4_ragged")
MOE_GRAD_CONTROL = "moe_ep2"
MOE_GRAD_REL = 2 ** -2


def _moe_dp_config(name):
    from paddle_tpu_torch.models import ernie_moe as tm
    return tm.ernie_moe_fine() if name == "fine" else \
        tm.ErnieMoEConfig(**MOE_BENCH)


def moe_dp_batches(vocab):
    """The ERNIE runs' seeded [MOE_B, MOE_S + 1] batches (two)."""
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=(MOE_B, MOE_S + 1)).astype(np.int32)
            for _ in range(2)]


def moe_dp_references(dev):
    """The single process's ERNIE runs the ranks are held to (same seed,
    batches and flags, lr MOE_DP_LR): ernie_moe_fine under MOE_FLAGS for
    two steps (ragged_a2a at ep 1 is the ragged path, so its step 0 also
    holds moe_ep4_ragged) and MOE_BENCH under capacity for one. Returns
    ({(config, steps): (params on the card, lm losses, losses, drops)},
    {config: the gradients of the first batch at the seeded params, on
    the card}, the control's (worst leaf's error, leaf)): step 0 of
    ernie_moe_fine with each layer's expert gradients summed over the
    two ep halves as well (rank e's slice given both ranks' sum: a
    gradient summed over ep as well as dp), which the limits must
    fail."""
    from paddle_tpu_torch.models import ernie_moe as tm
    from paddle_tpu_torch.models.llama import _adamw_update, _tree_map
    refs, grads = {}, {}
    for cname, fname, steps in (("fine", "a2a", 2),
                                ("bench", "capacity", 1)):
        cfg = _moe_dp_config(cname)
        step, p, o = tm.build_train_step(cfg, lr=MOE_DP_LR, seed=SEED,
                                         device=dev, **MOE_DP_FLAGS[fname])
        x = moe_dp_batches(cfg.vocab_size)[0]
        grads[cname] = tm.moe_loss_and_grads(
            p, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (x[:, :-1], x[:, 1:])), cfg,
            dispatch_mode=MOE_DP_FLAGS[fname].get("dispatch_mode",
                                                  "capacity"))[2]
        if cname == "fine":
            p0, o0 = _tree_map(torch.clone, p), _tree_map(torch.clone, o)
        lm, losses, drops = [], [], []
        for i, x in enumerate(moe_dp_batches(cfg.vocab_size)[:steps]):
            p, o, loss, st = step(p, o, x[:, :-1], x[:, 1:])
            losses.append(float(loss))
            lm.append(float(st["lm_loss"]))
            drops.append(float(st["moe_dropped_tokens"]))
            refs[(cname, i + 1)] = (_tree_map(torch.clone, p), lm[:],
                                    losses[:], drops[:])
        del step, p, o
    # the control: step 0 with the expert gradients summed over ep halves
    cfg = _moe_dp_config("fine")
    x = moe_dp_batches(cfg.vocab_size)[0]
    ids = torch.from_numpy(np.ascontiguousarray(x[:, :-1])).to(dev)
    labels = torch.from_numpy(np.ascontiguousarray(x[:, 1:])).to(dev)
    _, aux, g = tm.moe_loss_and_grads(p0, ids, labels, cfg, True,
                                      "ragged_a2a", True)
    half = cfg.num_experts // 2
    for name in ("e_w1", "e_w2"):
        g["layers"]["moe"][name] = [torch.cat([t[:half] + t[half:]] * 2)
                                    for t in g["layers"]["moe"][name]]
    _adamw_update(p0, g, o0, MOE_DP_LR,
                  masks=tm._expert_row_masks(p0, aux[1]))
    control = _worst(leaf_rel_errors(p0, refs[("fine", 1)][0]))
    del p0, o0, g
    gc.collect()
    torch.cuda.empty_cache()
    return refs, grads, control


def _whole(v):
    return torch.stack(v) if isinstance(v, list) else v


def moe_leaf_rel_errors(p, ref, cfg, mesh):
    """{leaf: relative Frobenius error of this rank's ``p`` against its
    slice of the full ``ref``} (e_w1/e_w2 sliced by the ep coordinate):
    param or gradient trees (a stacked leaf's per-layer slices
    stacked)."""
    from paddle_tpu_torch.models import ernie_moe as tm
    specs = tm.param_pspecs(cfg, mesh.ep.nranks, mesh.dp.nranks)
    out = {}
    for name, _ in _grad_items(p):
        t, r = _whole(_at(p, name)), _whole(_at(ref, name))
        for d, axis in enumerate(_at(specs, name)):
            if axis == "ep":
                n = r.shape[d] // mesh.ep.nranks
                r = r.narrow(d, mesh.ep.rank * n, n)
        d2, r2 = _sq_sums(t, r)
        out[name] = (d2 / r2) ** 0.5
    return out


def moe_state_reckoning(cfg, ep, multi_precision):
    """Bytes a rank holds for params and AdamW moments: every weight whole
    but the experts (E/ep of them), the router gate in f32, the rest in
    the model dtype; moments f32 (``multi_precision``) or in each param's
    dtype."""
    H, I, E, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                  cfg.vocab_size)
    n = cfg.num_hidden_layers // 2          # split stacks
    attn = 4 * H * H + 2 * H
    half = (V * H + cfg.max_position_embeddings * H + H
            + n * (attn + 2 * H * I)                        # dense layers
            + n * (attn + 2 * (E // ep) * H * I
                   + 2 * H * cfg.num_shared_experts * I))
    gate = n * H * E
    size = torch.finfo(cfg.dtype).bits // 8
    return half * (size + (8 if multi_precision else 2 * size)) \
        + gate * (4 + 8)


def moe_exchange_reckoning(cfg, ep, dp, fname, overlap):
    """The exchange a step of one rank, {span: (calls, bytes)}: under
    ragged_a2a (n = ep ranks, T = B S / (dp ep) tokens a rank, chunks of
    ragged_buffer_rows(T, k, E/n) rows of H in the model dtype, bf16) each
    MoE layer makes
    n - 1 hops out and n - 1 back, each again in the backward, and one
    exchange of the [n, E/n] int32 counts; the ragged path's local form
    one [B S / dp, H] all-reduce a layer forward; capacity at ep 1
    none."""
    from paddle_tpu_torch.parallel.moe import ragged_buffer_rows
    n_moe, H, k = cfg.num_hidden_layers // 2, cfg.hidden_size, cfg.moe_topk
    size = torch.finfo(cfg.dtype).bits // 8
    out = {}
    if fname == "a2a" and ep > 1:
        T = MOE_B * MOE_S // (dp * ep)
        chunk = ragged_buffer_rows(T, k, cfg.num_experts // ep, 128)
        hop = (n_moe * (ep - 1), n_moe * (ep - 1) * chunk * H * size)
        for name in ("hop", "ret_hop", "hop.grad", "ret_hop.grad"):
            out[f"moe.ragged_a2a.{name}"] = hop
        out["moe.ragged_a2a.counts"] = (n_moe, n_moe * cfg.num_experts * 4)
        out["moe.a2a.hops_total"] = n_moe * (ep - 1)
        if overlap:
            out["moe.a2a.hops_overlapped"] = n_moe * (ep - 1)
    elif fname == "ragged" and ep > 1:
        out["moe.combine_psum"] = (n_moe,
                                   n_moe * MOE_B * MOE_S // dp * H * size)
    return out


def moe_launch_reckoning(cfg, ep, fname, split):
    """Launches a step of one rank: each MoE layer runs rows 24-26 twice a
    chunk (ragged_a2a: n = ep chunks, the local ragged path one buffer,
    capacity none); each layer one flash forward and one backward (row
    16, or rows 17 and 18 under the ``split`` backward); the norms
    2L + 1 (split stacks: no recompute)."""
    L, n_moe = cfg.num_hidden_layers, cfg.num_hidden_layers // 2
    chunks = {"a2a": ep, "ragged": 1, "capacity": 0}[fname]
    gmm = 2 * chunks * n_moe
    bwd = {"flash_bwd": 0, "flash_bwd_dkv": L, "flash_bwd_dq": L} if split \
        else {"flash_bwd": L, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    return {"gmm_fwd": gmm, "gmm_dx": gmm, "gmm_dw": gmm, "flash_fwd": L,
            **bwd, "rms_norm": 2 * L + 1}


def moe_grad_errors(step, p, x, grads, cfg, control):
    """The first batch's gradients of a run of MOE_GRAD_RUNS before any
    update: {leaf: error against the single process's ``grads``}, and
    with ``control`` those of the faulty control (the expert gradients
    summed over ep as well, as the parent's param control), else None."""
    from paddle_tpu_torch.distributed import communication as comm
    _, _, g = step.loss_and_grads(p, *step.local_batch(x[:, :-1],
                                                       x[:, 1:]))
    errs = moe_leaf_rel_errors(g, grads, cfg, step.mesh)
    ctrl = None
    if control:
        moe = g["layers"]["moe"]
        for name in ("e_w1", "e_w2"):
            moe[name] = [comm.all_reduce(t.clone(), step.mesh.ep)
                         for t in moe[name]]
        ctrl = moe_leaf_rel_errors(g, grads, cfg, step.mesh)
    return errs, ctrl


def moe_dp_rank_runs(world, dev, refs, grads):
    """This rank's ERNIE runs of MOE_DP_RUNS at ``world``: losses, lm
    losses and drops a step, step ms, peak memory, state bytes, launches,
    the moe exchange's and every comm span's calls and bytes a step,
    coordinates, checksums of each local leaf (and after step 0) and each
    leaf's error against the single process's (``refs``); for
    MOE_GRAD_RUNS the first batch's gradients' errors against the single
    process's (``grads``, by config) before the steps."""
    from paddle_tpu_torch.models import ernie_moe as tm
    from paddle_tpu_torch.observability import trace
    out = {}
    for name, w, ep, dp, cname, fname, steps, env in MOE_DP_RUNS:
        if w != world:
            continue
        cfg = _moe_dp_config(cname)
        batches = moe_dp_batches(cfg.vocab_size)
        os.environ.update(env)
        t0 = t_run = time.perf_counter()
        step, p, o = tm.build_train_step(cfg, ep_degree=ep, dp_degree=dp,
                                         lr=MOE_DP_LR, seed=SEED, device=dev,
                                         **MOE_DP_FLAGS[fname])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        state = _tree_bytes(p) + _tree_bytes({"m": o["m"], "v": o["v"]})
        grad_rel = grad_ctrl = None
        if name in MOE_GRAD_RUNS:
            grad_rel, grad_ctrl = moe_grad_errors(
                step, p, batches[0], grads[cname], cfg,
                name == MOE_GRAD_CONTROL)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        trace.reset_counters()
        losses, lm, drops, step_ms, first = [], [], [], [], None
        for i, x in enumerate(batches[:steps]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, loss, st = step(p, o, x[:, :-1], x[:, 1:])
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            lm.append(float(st["lm_loss"]))
            drops.append(float(st["moe_dropped_tokens"]))
            if i == 0 and name in MOE_DP_BITWISE.values():
                first = {k: bits_checksum(ts[0]) for k, ts in _grad_items(p)}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for k in env:
            del os.environ[k]
        counters = trace.counters()
        out[name] = {
            "losses": losses, "lm_losses": lm, "drops": drops,
            "step_ms": step_ms, "build_s": build_s, "peak_bytes": peak,
            "state_bytes": state, "launches": _counts(),
            "moe_per_step": {k: v / steps for k, v in counters.items()
                             if k.startswith("moe.")},
            "comm_per_step": {k[len("comm."):]: v / steps
                              for k, v in counters.items()
                              if k.startswith("comm.")},
            "coord": step.mesh.coord,
            "checksums": {k: bits_checksum(ts[0])
                          for k, ts in _grad_items(p)},
            "first_step_checksums": first,
            "param_rel": moe_leaf_rel_errors(p, refs[(cname, steps)][0],
                                             cfg, step.mesh),
            "grad_rel": grad_rel, "grad_control_rel": grad_ctrl,
            "run_s": time.perf_counter() - t_run}
        del step, p, o
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _moe_dp_checks(runs, refs_info, control, fails):
    """The ERNIE runs' checks and prints (``runs``: train-dp's {run: every
    rank's {run: report}}): every rank the same losses; dp
    replicas the same bits; moe_ep2_overlap bitwise moe_ep2's step 0; lm
    losses and each rank's leaves against the single process's; the
    launches, the exchange and the state bytes against their reckonings.
    Returns the runs' record."""
    out = {"control": {"case": "expert gradients summed over ep as well",
                       "param_rel": control[0], "leaf": control[1]}}
    print(f"ERNIE control (expert gradients summed over ep as well as dp, "
          f"step 0): worst leaf {control[1]} {control[0]:.4e} against the "
          f"limit {DP_PARAM_REL:.4e}")
    if control[0] <= DP_PARAM_REL:
        fails.append(f"ERNIE control: params {control[0]} within "
                     f"DP_PARAM_REL")
    for name, world, ep, dp, cname, fname, steps, env in MOE_DP_RUNS:
        per = [r[name] for r in runs[name]]
        cfg = _moe_dp_config(cname)
        r0 = per[0]
        if any(r["losses"] != r0["losses"] for r in per):
            fails.append(f"{name}: ranks report different losses "
                         f"{[r['losses'] for r in per]}")
        ep_split = 0       # leaves ep does not split: one array in JAX
        for a in per:
            for b in per:
                same_ep = a["coord"][1] == b["coord"][1]
                bad = [k for k in a["checksums"] if same_ep and
                       a["checksums"][k] != b["checksums"][k]]
                if bad:
                    fails.append(f"{name}: dp replicas {a['coord']} and "
                                 f"{b['coord']} differ in {bad}")
                ep_split += sum(a["checksums"][k] != b["checksums"][k]
                                for k in a["checksums"]
                                if not same_ep and "e_w" not in k)
        if ep_split:
            fails.append(f"{name}: {ep_split} (rank pair, leaf) checksums "
                         f"of leaves ep does not split differ across ep "
                         f"ranks")
        grad = None
        if name in MOE_GRAD_RUNS:
            grad = max(_worst(r["grad_rel"]) + (rank,)
                       for rank, r in enumerate(per))
            if grad[0] > MOE_GRAD_REL:
                fails.append(f"{name}: rank {grad[2]}'s gradient of "
                             f"{grad[1]} is {grad[0]} off the single "
                             f"process's")
        if name == MOE_GRAD_CONTROL:
            ctrl = min(_worst(r["grad_control_rel"]) + (rank,)
                       for rank, r in enumerate(per))
            out["grad_control"] = {
                "case": "expert gradients summed over ep as well",
                "run": name, "grad_rel": ctrl[0], "leaf": ctrl[1],
                "rank": ctrl[2]}
            print(f"ERNIE gradient control ({name}'s expert gradients "
                  f"summed over ep as well as dp): worst leaf {ctrl[1]} "
                  f"{ctrl[0]:.4e} (the least over ranks) against the limit "
                  f"{MOE_GRAD_REL:.4e}")
            if ctrl[0] <= MOE_GRAD_REL:
                fails.append(f"ERNIE gradient control: {ctrl[0]} within "
                             f"MOE_GRAD_REL")
        if name in MOE_DP_BITWISE:
            base = MOE_DP_BITWISE[name]
            ref = [r[base] for r in runs[base]]
            if r0["losses"] != ref[0]["losses"][:1] or any(
                    a["checksums"] != b["first_step_checksums"]
                    for a, b in zip(per, ref)):
                fails.append(f"{name}: not bitwise {MOE_DP_BITWISE[name]}'s"
                             f" first step (losses {r0['losses']}, "
                             f"{ref[0]['losses'][:1]})")
        s_lm, s_loss, s_drops = refs_info[(cname, steps)]
        gaps = [_rel(x, y) for x, y in zip(r0["lm_losses"], s_lm)]
        limits = [DP_STEP0_RTOL if i == 0 else DP_LATER_RTOL
                  for i in range(len(gaps))]
        if any(g > lim for g, lim in zip(gaps, limits)):
            fails.append(f"{name}: lm losses {r0['lm_losses']} against one "
                         f"process's {s_lm}: gaps {gaps}")
        worst = max(_worst(r["param_rel"]) + (rank,)
                    for rank, r in enumerate(per))
        if worst[0] > DP_PARAM_REL:
            fails.append(f"{name}: rank {worst[2]}'s {worst[1]} is "
                         f"{worst[0]} off the single process's params")
        flags = MOE_DP_FLAGS[fname]
        overlap = "PADDLE_TPU_TORCH_MOE_A2A_OVERLAP" in env
        want_x = moe_exchange_reckoning(cfg, ep, dp, fname, overlap)
        split = env.get("PADDLE_TPU_TORCH_FLASH_BWD") == "split"
        want_l = {k: v * steps for k, v in
                  moe_launch_reckoning(cfg, ep, fname, split).items()}
        want_s = moe_state_reckoning(cfg, ep,
                                     flags.get("multi_precision", True))
        for rank, r in enumerate(per):
            got_x = {}
            for k, v in r["moe_per_step"].items():
                if k.endswith(".calls"):
                    got_x.setdefault(k[:-6], [0, 0])[0] = v
                elif k.endswith(".bytes"):
                    got_x.setdefault(k[:-6], [0, 0])[1] = v
                else:
                    got_x[k] = v
            got_x = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in got_x.items()}
            if got_x != want_x:
                fails.append(f"{name} rank {rank}: exchange a step {got_x},"
                             f" reckoned {want_x}")
            got_l = {k: r["launches"][k] for k in want_l}
            if got_l != want_l:
                fails.append(f"{name} rank {rank}: launches {got_l}, want "
                             f"{want_l}")
            if r["state_bytes"] != want_s:
                fails.append(f"{name} rank {rank}: state {r['state_bytes']} "
                             f"bytes, reckoned {want_s}")
            r["exchange"], r["reckoned_exchange"] = got_x, want_x
            r["reckoned_launches"] = want_l
        grad_txt = "" if grad is None else (
            f"first-batch gradients: worst leaf {grad[1]} {grad[0]:.4e} "
            f"(rank {grad[2]}, limit {MOE_GRAD_REL:.4e}); ")
        aux_port = (r0["losses"][0] - r0["lm_losses"][0]) / cfg.aux_loss_weight
        aux_one = (s_loss[0] - s_lm[0]) / cfg.aux_loss_weight
        total_gap = _rel(r0["losses"][0], s_loss[0])
        out[name] = {
            "world": world, "ep": ep, "dp": dp, "config": cname,
            "flags": {k: v for k, v in flags.items()}, "env": env,
            "steps": steps, "losses": r0["losses"],
            "lm_losses": r0["lm_losses"], "single_process_lm": s_lm,
            "single_process_losses": s_loss, "lm_rel_gaps": gaps,
            "total_rel_gap_step0": total_gap,
            "aux_sum_step0": {"ranks": aux_port, "single_process": aux_one},
            "drops": r0["drops"], "single_process_drops": s_drops,
            "param_rel_worst": {"err": worst[0], "leaf": worst[1],
                                "rank": worst[2]},
            "replicated_leaves_differing_across_ep": ep_split,
            "grad_rel_worst": None if grad is None else {
                "err": grad[0], "leaf": grad[1], "rank": grad[2]},
            "state_bytes_reckoned": want_s,
            "run_s": max(r["run_s"] for r in per),
            "ranks": [{k: r[k] for k in (
                "coord", "peak_bytes", "state_bytes", "step_ms", "build_s",
                "launches", "exchange", "comm_per_step", "run_s",
                "grad_rel", "grad_control_rel")}
                for r in per]}
        print(f"{name} (world {world}, ep {ep} x dp {dp}, {cname}, {fname}"
              f"{', ' + str(env) if env else ''}): lm losses "
              f"{r0['lm_losses']} against one process's {s_lm} (rel gaps "
              f"{gaps}); total {r0['losses']} against {s_loss} (step 0 gap "
              f"{total_gap:.3e}: aux summed over the MoE layers "
              f"{aux_port:.6f} on the ranks, JAX's per-shard mean under ep, "
              f"against {aux_one:.6f} over the global batch, times "
              f"aux_loss_weight {cfg.aux_loss_weight}); drops "
              f"{r0['drops']} (one process {s_drops}); params: worst leaf "
              f"{worst[1]} {worst[0]:.4e} (rank {worst[2]}); {grad_txt}"
              f"replicated "
              f"leaf checksums differing across ep ranks: {ep_split}; "
              f"{out[name]['run_s']:.1f} s (the slowest rank)")
        for rank, r in enumerate(per):
            print(f"  rank {rank} {tuple(r['coord'])}: peak "
                  f"{r['peak_bytes'] / 1e9:.2f} GB, state "
                  f"{r['state_bytes'] / 1e9:.3f} GB (reckoned "
                  f"{want_s / 1e9:.3f}); step ms {r['step_ms']}; launches "
                  f"{ {k: r['launches'][k] for k in want_l} } (reckoned "
                  f"{want_l}); exchange a step {r['exchange']}; other "
                  f"collectives a step {r['comm_per_step']}")
    return out


# ---------------------------------------------------------------------------
# serve-tp: tensor-parallel serving, InferenceEngine(ServeConfig(mp=2)) over
# two ranks (spawned processes) sharing cuda:0 through gloo
# ---------------------------------------------------------------------------

# the tiny check: check_tiny_spec_streams's model (damped) and trace, each
# run at mp 1 in this process and at mp 2 in the ranks, through the card
# kernels: rows 1 and 3 (plain), 5 (int8), 6 and 8 (speculation), 7 and 9
# (speculation over int8), each at the rank's heads (2, over 1 kv head)
TINY_TP_SERVE = dict(block_size=128, num_blocks=10, max_batch=2,
                     prefill_chunk=64, max_seq_len=512, draft_k=4)
TINY_TP_RUNS = {"plain": {},
                "int8-prefix": dict(kv_dtype="int8", prefix_cache=True),
                "spec-prefix": dict(speculative=True, prefix_cache=True),
                "spec-int8-prefix": dict(speculative=True, prefix_cache=True,
                                         kv_dtype="int8")}
TINY_TP_ROWS = {"plain": ("paged_attend_update",),
                "int8-prefix": ("paged_attend_update_quant",),
                "spec-prefix": ("paged_attention_verify",
                                "paged_verify_commit"),
                "spec-int8-prefix": ("paged_attention_verify_quant",
                                     "paged_verify_commit_quant")}
# the 7B runs: the serve phase's ServeConfig and the first
# SERVE_TP_REQUESTS requests of its trace, wall mode, at mp 2 on the first
# SERVE_TP_LAYERS layers of llama_7b. Cut for time: gloo stages each of a
# step's 65 all-reduces through the host (a decode step took 357 ms at 32
# layers on an NVIDIA H100 80GB HBM3, 700.00 W), so 8 requests at 32
# layers took 106 s of the phase's 133; the requests went first (8 -> 4),
# then the depth (32 -> 16)
SERVE_TP = dict(block_size=128, num_blocks=129, max_batch=8,
                prefill_chunk=256, max_seq_len=2048)
SERVE_TP_RUNS = {"bf16": {},
                 "int8-spec-prefix": dict(kv_dtype="int8", prefix_cache=True,
                                          speculative=True, draft_k=SPEC_K)}
SERVE_TP_REQUESTS = 4
SERVE_TP_LAYERS = 16
SERVE_TP_JOIN_S = 600
# One teacher-forced decode step (llama_7b at all 32 layers, B 8 at row
# 3's positions, random bf16 pools): the relative Frobenius error of the
# mp 2 step's gathered logits against the mp 1 step's on the same pools
# and inputs. Sound, the o_proj and down_proj partial sums are rounded to
# bf16 on each rank and added in bf16 where one process rounds once:
# 4.61e-2 (NVIDIA H100 80GB HBM3, 700.00 W); the two faulty controls
# (rank 1 drops its o_proj reduce; rank 1's k_proj holds rank 0's heads)
# read 1.28 and 0.600. The limit lies 2.7x over the sound reading and
# 4.8x under the nearer control.
SERVE_TP_LOGIT_REL = 2 ** -3


def _tiny_tp_model():
    from paddle_tpu_torch import init_llama_params, llama_tiny
    cfg = llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                     seq=512)
    params = init_llama_params(cfg, seed=3, device="cpu")
    for name in ("o_proj", "down_proj"):
        params["layers"][name].mul_(SPEC_DAMP)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (7, 130, 300)]
    return params, cfg, prompts


def _tiny_tp_runs(params, cfg, prompts, dev, mp):
    """The TINY_TP_RUNS on ``dev`` at ``mp``: {run: (streams, events,
    launches, used blocks)}."""
    from paddle_tpu_torch import InferenceEngine, Request, ServeConfig
    out = {}
    for name, kw in TINY_TP_RUNS.items():
        eng = InferenceEngine(_to_device(params, dev), cfg, ServeConfig(
            **TINY_TP_SERVE, **kw, mp=mp), record_events=True, device=dev)
        _zero_counts()
        eng.run([Request(pr, max_new_tokens=8, arrival=float(i))
                 for i, pr in enumerate(prompts)], deterministic=True)
        out[name] = ({s.req.request_id: s.tokens for s in eng.finished},
                     eng.events, _counts(), eng.pool.used_blocks)
    return out


def _tp_comm(trace):
    """The collective counters since the last reset: calls and bytes by
    comm op and by serve.tp_ring site (host ms left out)."""
    return {k: v for k, v in trace.counters().items()
            if k.startswith(("comm.", "serve.tp_ring"))
            and not k.endswith(".ms")}


def _tp_reckoning(cfg, rows, vocab_rows):
    """The collective calls and bytes one rank makes in one decode step
    (``rows`` = B, ``vocab_rows`` = B) or prefill chunk (``rows`` = C,
    ``vocab_rows`` = 1) at mp 2, from the shapes: the embedding's
    all-reduce and two row-parallel all-reduces a layer of [rows, H] bf16,
    and the all-gather of [vocab_rows, V/2] f32 logits (counted at the
    gathered [vocab_rows, V])."""
    L, H, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    act = rows * H * 2
    return {"comm.all_reduce.mp.calls": 1 + 2 * L,
            "comm.all_reduce.mp.bytes": (1 + 2 * L) * act,
            "comm.all_gather.mp.calls": 1,
            "comm.all_gather.mp.bytes": vocab_rows * V * 4,
            "serve.tp_ring.embed.calls": 1,
            "serve.tp_ring.embed.bytes": act,
            "serve.tp_ring.o_proj.calls": L,
            "serve.tp_ring.o_proj.bytes": L * act,
            "serve.tp_ring.down_proj.calls": L,
            "serve.tp_ring.down_proj.bytes": L * act}


def _tf_rel(step, params, refs, cfg, tp, dev):
    """One teacher-forced decode step at mp 2 on this rank's heads of the
    parent's pools: the rel frob error of its gathered logits against the
    parent's mp 1 logits."""
    n, r = tp.nranks, tp.rank
    kvd = refs["k"].shape[2] // n
    kp, vp = (refs[x][:, :, r * kvd:(r + 1) * kvd].clone() for x in "kv")
    got = step(params, kp, vp, refs["tables"], refs["positions"],
               refs["ids"], cfg, tp=tp)[0]
    ref = refs["logits"]
    rel = ((got - ref).norm() / ref.norm()).item()
    del kp, vp, got
    return rel


def serve_tp_rank(rank, world, dev, t_spawn, refs, tiny, reqs):
    """One rank of serve-tp (spawned; the process group is up): the tiny
    check's four runs at mp 2; then on llama_7b, from the parent's full
    weights and pools (CUDA handles): the teacher-forced decode step and
    its two faulty controls, one decode step's and one prefill chunk's
    collectives, and the SERVE_TP_RUNS over ``reqs`` in wall mode."""
    began = time.time() - t_spawn
    from paddle_tpu_torch import InferenceEngine, Request, ServeConfig
    from paddle_tpu_torch.inference.engine import serving_group
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.observability import trace
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = serving_group(world)
    out = {"tiny": _tiny_tp_runs(*tiny, dev, world)}
    t_tiny = time.time() - t_spawn
    cfg = tl.llama_7b()
    full = refs["params"]
    shards = tl.shard_for_serving(full, cfg, tp)
    step = tl.llama_paged_decode_step
    tf = {}
    trace.reset_counters()
    tf["sound"] = _tf_rel(step, shards, refs, cfg, tp, dev)
    out["decode_comm"] = _tp_comm(trace)
    real = tl._tp_o_proj

    def skip_o_proj(a, w, tp_):
        summed = real(a, w, tp_)        # the peer's all-reduce still runs
        return tl._mat(a, w) if tp_.rank == 1 else summed
    tl._tp_o_proj = skip_o_proj
    try:
        tf["rank 1 skips its o_proj reduce"] = _tf_rel(step, shards, refs,
                                                       cfg, tp, dev)
    finally:
        tl._tp_o_proj = real
    bad = shards
    if tp.rank == 1:
        kvd = shards["layers"]["k_proj"].shape[2]
        bad = dict(shards, layers=dict(
            shards["layers"],
            k_proj=full["layers"]["k_proj"][..., :kvd].contiguous()))
    tf["rank 1's k_proj holds rank 0's heads"] = _tf_rel(step, bad, refs,
                                                         cfg, tp, dev)
    del bad
    kvd = refs["k"].shape[2] // world
    kp, vp = (refs[x][:, :, rank * kvd:(rank + 1) * kvd].clone()
              for x in "kv")
    trace.reset_counters()
    tl.llama_paged_prefill_chunk(shards, kp, vp, refs["table_row"], 0,
                                 refs["chunk"], refs["chunk"].numel(), cfg,
                                 tp=tp)
    torch.cuda.synchronize()
    out["prefill_comm"] = _tp_comm(trace)
    out["teacher_forced"] = tf
    del kp, vp, shards
    gc.collect()
    torch.cuda.empty_cache()
    # the serving runs' weights: views of the first SERVE_TP_LAYERS layers
    full, cfg = tl.make_draft_model(full, cfg, SERVE_TP_LAYERS)
    # a warm-up on a small pool (cuBLAS handles, allocator, gloo buffers)
    warm = InferenceEngine(full, cfg, ServeConfig(
        block_size=128, num_blocks=9, max_batch=2, prefill_chunk=256,
        max_seq_len=1024, mp=world), device=dev)
    warm.run([Request(list(range(1, 200)), max_new_tokens=3)])
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for name, kw in SERVE_TP_RUNS.items():
        eng = InferenceEngine(full, cfg, ServeConfig(**SERVE_TP, **kw,
                                                     mp=world),
                              record_events=True, device=dev)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        trace.reset_counters()
        t0 = time.perf_counter()
        stats = eng.run([Request(**r) for r in reqs])
        wall = time.perf_counter() - t0
        comm = _tp_comm(trace)
        runs[name] = {
            "stats": {k: stats[k] for k in (
                "requests", "unfinished", "generated_tokens", "iterations",
                "decode_steps", "prefill_chunks", "tokens_per_sec",
                "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                "decode_step_ms_mean", "prefill_chunk_ms_mean",
                "pool_bytes_per_rank", "failed", "mp", "speculative",
                "prefix_cache")},
            "wall_s": wall, "launches": _counts(), "comm": comm,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "streams": {s.req.request_id: s.generated for s in eng.finished},
            "new_tokens": [len(s.generated) for s in eng.finished],
            "events": eng.events, "used_blocks": eng.pool.used_blocks}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["runs"] = runs
    refs.clear()    # releases the parent's tensors (their IPC handles)
    del full
    gc.collect()
    out.update(began_s=began, tiny_done_s=t_tiny,
               ended_s=time.time() - t_spawn)
    return out


# the times of rows 3 and 5-9 at a rank's shapes (tp_rank_times' keys)
TP_RANK_TIMES = {
    "paged_attend_update": "paged_attend_update[B=8,NH=NKV=16]",
    "paged_attend_update_quant": "paged_attend_update_quant[B=8,NH=NKV=16]",
    "paged_attention_verify": "paged_attention_verify[B=8,T=5,NH=NKV=16]",
    "paged_attention_verify_quant":
        "paged_attention_verify_quant[B=8,T=5,NH=NKV=16]",
    "paged_verify_commit": "paged_verify_commit[L=32,B=8,T=5,KVD=2048]",
    "paged_verify_commit_quant":
        "paged_verify_commit_quant[L=32,B=8,T=5,KVD=2048]"}


def serve_tp(dev):
    """InferenceEngine at mp 2: two ranks (spawned processes) share cuda:0
    through gloo, which stages each CUDA tensor through the host: a check
    of the path, the streams, the bytes and the memory a rank, not of
    collective speed. First the tiny check (check_tiny_tp_streams), then
    llama_7b (bf16, the serve phase's seed): the weights are made here
    once and handed to the ranks as CUDA handles, each keeping its
    shards; the teacher-forced step runs all 32 layers, the serving runs
    the first SERVE_TP_LAYERS. Asserted: the tiny streams equal mp 1's on
    the card, every rank's streams and events the same,
    pool_bytes_per_rank half the mp 1 engine's, the collective bytes
    their reckoning, the teacher-forced logits within SERVE_TP_LOGIT_REL
    and both controls over it. Reported: each request's first divergence
    from an mp 1 engine's streams on the same weights and trace (bf16
    partial sums round apart)."""
    from paddle_tpu_torch import (InferenceEngine, Request, ServeConfig,
                                  init_llama_params)
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.testing.dist import spawn
    phase(f"serve-tp: InferenceEngine at mp 2, two ranks on cuda:0 (gloo): "
          f"the tiny check, then llama_7b (bf16; one teacher-forced step at "
          f"32 layers, serving at {SERVE_TP_LAYERS} layers, the serve "
          f"trace's first {SERVE_TP_REQUESTS} requests)")
    t_phase = time.perf_counter()
    fails, res = [], {}
    tiny = _tiny_tp_model()
    tiny_ref = _tiny_tp_runs(*tiny, dev, 1)
    cfg = tl.llama_7b()
    params = init_llama_params(cfg, seed=SEED, device=dev)
    sparams, scfg = tl.make_draft_model(params, cfg, SERVE_TP_LAYERS)
    reqs = [dict(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                 arrival=r.arrival, request_id=r.request_id)
            for r in _serve_requests(cfg)[:SERVE_TP_REQUESTS]]
    # mp 1 on the same weights and trace: the pool bytes of each
    # ServeConfig, and the bf16 run's streams for the divergence report
    one, mp1_streams = {}, None
    for name, kw in SERVE_TP_RUNS.items():
        eng = InferenceEngine(sparams, scfg, ServeConfig(**SERVE_TP, **kw),
                              device=dev)
        one[name] = eng.stats()["pool_bytes_per_rank"]
        if mp1_streams is None:
            eng.run([Request(**r) for r in reqs])
            mp1_streams = {s.req.request_id: s.generated
                           for s in eng.finished}
        del eng
        _release_card()
    a = _paged_inputs(cfg.num_attention_heads, cfg.num_key_value_heads,
                      PAGED_POSITIONS, SEED + 90, dev, hd=cfg.head_dim,
                      layers=cfg.num_hidden_layers)
    g = torch.Generator(device=dev).manual_seed(SEED + 91)
    ids = torch.randint(1, cfg.vocab_size, (len(PAGED_POSITIONS),),
                        generator=g, device=dev, dtype=torch.int32)
    chunk = torch.randint(1, cfg.vocab_size, (SERVE_TP["prefill_chunk"],),
                          generator=g, device=dev, dtype=torch.int32)
    logits = tl.llama_paged_decode_step(
        params, a["k_pool"].clone(), a["v_pool"].clone(), a["tables"],
        a["positions"], ids, cfg)[0]
    refs = {"params": params, "k": a["k_pool"], "v": a["v_pool"],
            "tables": a["tables"], "positions": a["positions"], "ids": ids,
            "logits": logits, "table_row": a["tables"][-1], "chunk": chunk}
    del a
    torch.cuda.synchronize()
    t0 = time.time()
    ranks = spawn(serve_tp_rank, 2, (dev, t0, refs, tiny, reqs),
                  timeout=SERVE_TP_JOIN_S)
    joined = time.time() - t0
    del refs, params, sparams, logits
    _release_card()
    torch.cuda.ipc_collect()
    print(f"ranks began at {[round(r['began_s'], 1) for r in ranks]} s, "
          f"finished the tiny check at "
          f"{[round(r['tiny_done_s'], 1) for r in ranks]} s, ended at "
          f"{[round(r['ended_s'], 1) for r in ranks]} s, joined at "
          f"{joined:.1f} s")
    res["spawn_s"] = {"began": [r["began_s"] for r in ranks],
                      "tiny_done": [r["tiny_done_s"] for r in ranks],
                      "ended": [r["ended_s"] for r in ranks],
                      "joined": joined}
    # -- the tiny check
    for name in TINY_TP_RUNS:
        want = tiny_ref[name]
        for rank, r in enumerate(ranks):
            got = r["tiny"][name]
            if got[0] != want[0]:
                fails.append(f"tiny {name} rank {rank}: streams differ from "
                             f"mp 1's")
            if got[1] != ranks[0]["tiny"][name][1]:
                fails.append(f"tiny {name} rank {rank}: events differ from "
                             f"rank 0's")
            if got[3] != 0:
                fails.append(f"tiny {name} rank {rank}: pool leaked")
            for k in ("rms_norm",) + TINY_TP_ROWS[name]:
                if got[2][k] <= 0:
                    fails.append(f"tiny {name} rank {rank}: {k} not "
                                 f"launched")
        print(f"tiny {name}: mp 2 streams equal mp 1's on the card on "
              f"every rank {all(r['tiny'][name][0] == want[0] for r in ranks)};"
              f" launches a rank "
              f"{ {k: ranks[0]['tiny'][name][2][k] for k in ('rms_norm',) + TINY_TP_ROWS[name]} }")
    res["tiny"] = {name: {"launches": [
        {k: r["tiny"][name][2][k] for k in ("rms_norm",) + TINY_TP_ROWS[name]}
        for r in ranks]} for name in TINY_TP_RUNS}
    # -- teacher-forced step and controls
    tf = ranks[0]["teacher_forced"]
    for c, rel in tf.items():
        ok = rel <= SERVE_TP_LOGIT_REL
        print(f"teacher-forced decode step, {c}: logits rel frob {rel:.4e} "
              f"against the limit {SERVE_TP_LOGIT_REL:.4e} "
              f"({'within' if ok else 'over'}); rank 1 "
              f"{ranks[1]['teacher_forced'][c]:.4e}")
        if (c == "sound") != ok:
            fails.append(f"teacher-forced {c}: rel {rel} "
                         f"{'over' if c == 'sound' else 'within'} the limit")
    res["teacher_forced"] = [r["teacher_forced"] for r in ranks]
    # -- collectives of one decode step and one prefill chunk
    for what, want in (("decode_comm", _tp_reckoning(cfg, 8, 8)),
                       ("prefill_comm", _tp_reckoning(
                           cfg, SERVE_TP["prefill_chunk"], 1))):
        for rank, r in enumerate(ranks):
            got = {k: v for k, v in r[what].items()
                   if not k.startswith("site.")}
            if got != want:
                fails.append(f"{what} rank {rank}: {got}, reckoned {want}")
        print(f"{what.split('_')[0]} step, a rank: {ranks[0][what]} "
              f"(reckoned {want})")
        res[what] = {"ranks": [r[what] for r in ranks], "reckoned": want}
    # -- the serving runs
    L = scfg.num_hidden_layers
    for name in SERVE_TP_RUNS:
        per = [r["runs"][name] for r in ranks]
        st = per[0]["stats"]
        if any(p["streams"] != per[0]["streams"] for p in per):
            fails.append(f"{name}: ranks emit different streams")
        if any(p["events"] != per[0]["events"] for p in per):
            fails.append(f"{name}: ranks log different events")
        for rank, p in enumerate(per):
            if 2 * p["stats"]["pool_bytes_per_rank"] != one[name]:
                fails.append(f"{name} rank {rank}: pool_bytes_per_rank "
                             f"{p['stats']['pool_bytes_per_rank']}, mp 1's "
                             f"{one[name]}")
            if p["stats"]["unfinished"] or p["stats"]["failed"] or \
                    p["used_blocks"] or \
                    p["new_tokens"] != [64] * SERVE_TP_REQUESTS:
                fails.append(f"{name} rank {rank}: not every request "
                             f"finished its 64 tokens leak-free")
        lc = per[0]["launches"]
        if name == "bf16":
            want = {"paged_attend_update": L * st["decode_steps"],
                    "rms_norm": (2 * L + 1) * (st["decode_steps"]
                                               + st["prefill_chunks"])}
        else:
            want = {"paged_attention_verify_quant": L * st["decode_steps"],
                    "paged_verify_commit_quant": st["decode_steps"]}
        for rank, p in enumerate(per):
            got = {k: p["launches"][k] for k in want}
            if got != want or p["launches"]["rms_norm"] <= 0 or (
                    name != "bf16"
                    and p["launches"]["paged_attend_update"] <= 0):
                fails.append(f"{name} rank {rank}: launches "
                             f"{p['launches']}, want {want}")
        same, first = _divergence(mp1_streams, per[0]["streams"])
        shown = ("rms_norm", "paged_attend_update",
                 "paged_attend_update_quant", "paged_attention_verify",
                 "paged_attention_verify_quant", "paged_verify_commit",
                 "paged_verify_commit_quant")
        print(f"{name}: tokens/s {st['tokens_per_sec']}  TTFT p50 "
              f"{st['ttft_p50_s']} s  decode step mean "
              f"{st['decode_step_ms_mean']} ms  prefill chunk mean "
              f"{st['prefill_chunk_ms_mean']} ms  ({st['decode_steps']} "
              f"steps, {st['prefill_chunks']} chunks, wall "
              f"{[round(p['wall_s'], 2) for p in per]} s)")
        print(f"  pool_bytes_per_rank {st['pool_bytes_per_rank']} (mp 1: "
              f"{one[name]}); peak a rank "
              f"{[round(p['peak_bytes'] / 2 ** 30, 2) for p in per]} GiB; "
              f"launches a rank { {k: lc[k] for k in shown} }")
        print(f"  collectives a rank over the run: "
              f"{ {k: v for k, v in per[0]['comm'].items() if not k.startswith('site.')} }")
        print(f"  streams equal on both ranks; against mp 1's bf16 "
              f"streams: {len(same)} of {len(per[0]['streams'])} equal, "
              f"first divergent index of the others {first} (reported, "
              f"not asserted)")
        res[name] = {
            "stats": st, "pool_bytes_mp1": one[name],
            "peak_bytes": [p["peak_bytes"] for p in per],
            "wall_s": [p["wall_s"] for p in per],
            "launches": [{k: p["launches"][k] for k in shown} for p in per],
            "comm": per[0]["comm"], "streams_equal_mp1": len(same),
            "first_divergence_mp1": first,
            "reduced": (f"requests 8 -> {SERVE_TP_REQUESTS}, "
                        f"num_hidden_layers 32 -> {SERVE_TP_LAYERS} (the "
                        f"teacher-forced step runs 32)")}
    # rank 0's launches by row: rows 3, 7, 9 from the llama_7b runs (3 in
    # both: the bf16 run's decode and the speculative run's draft), 5, 6, 8
    # from the tiny check
    r0 = ranks[0]
    res["launches_rank0"] = {
        "paged_attend_update": sum(r0["runs"][n]["launches"]
                                   ["paged_attend_update"]
                                   for n in SERVE_TP_RUNS),
        **{k: r0["runs"]["int8-spec-prefix"]["launches"][k]
           for k in ("paged_attention_verify_quant",
                     "paged_verify_commit_quant")},
        **{k: sum(r0["tiny"][n][2][k] for n in TINY_TP_RUNS)
           for k in ("paged_attend_update_quant", "paged_attention_verify",
                     "paged_verify_commit")}}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"serve-tp seconds {res['seconds']:.1f}; launches of rank 0 "
          f"{res['launches_rank0']}")
    assert not fails, "\n".join(fails)
    return res


def main():
    t_start = time.perf_counter()
    smi = probe()
    dev = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)
    build_s = build()
    from paddle_tpu_torch import _build
    errs = check_kernels(dev)
    check_paged_read(dev, errs)
    check_verify(dev, errs)
    check_quant(dev, errs)
    check_commit(dev, errs)
    dead = check_dead_columns(dev)
    check_flash(dev, errs)
    check_split(dev, errs)
    check_blocks(dev)
    check_gmm(dev, errs)
    check_tiny_streams(dev)
    check_tiny_spec_streams(dev)
    check_tiny_streams(dev, "int8")
    check_tiny_spec_streams(dev, "int8")
    check_tiny_train(dev)
    check_tiny_train(dev, "split")
    check_tiny_ernie(dev)
    check_tiny_ernie_capacity(dev)
    check_decode(dev, errs)
    check_tiny_generate(dev)
    check_varlen(dev, errs)
    serve = serve_7b(dev)
    serve_tp_res = serve_tp(dev)
    spec = serve_spec(dev)
    serve13 = serve_13b(dev)
    train = train_7b(dev)
    policies = train_policies(dev)
    ce = chunked_ce(dev)
    train13 = train_13b(dev)
    tlong = train_long(dev)
    along = attn_long(dev)
    ernie = train_ernie(dev)
    ernie_cap = ernie_capacity(dev)
    gen = generate_tinyllama(dev)
    varlen = varlen_phase(dev)
    resume = resume_phase(dev)
    fleet = fleet_phase(dev)
    train_dp_res = train_dp(dev)
    tm = times(dev, errs)
    tm_tp = tp_rank_times(dev)
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
        {"name": "paged_attention_verify", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:924",
         "launches": spec["launches"]["paged_attention_verify"],
         "max_abs_err": errs["paged_attention_verify"],
         **{k: tm["paged_attention_verify[B=8,T=5,NH=NKV=32]"][k]
            for k in cols}},
        {"name": "paged_verify_commit", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:1183",
         "launches": spec["launches"]["paged_verify_commit"],
         "max_abs_err": errs["paged_verify_commit"],
         **{k: tm["paged_verify_commit[L=32,B=8,T=5,KVD=4096]"][k]
            for k in cols}},
        {"name": "paged_attend_update_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:716",
         "launches": serve["int8"]["launches"]["paged_attend_update_quant"],
         "max_abs_err": errs["paged_attend_update_quant"],
         **{k: tm["paged_attend_update_quant[B=8,NH=NKV=32]"][k]
            for k in cols}},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:552",
         "launches": serve["int8"]["launches"]["paged_attention_quant"],
         "max_abs_err": errs["paged_attention_quant"],
         **{k: tm["paged_attention_quant[B=8,NH=NKV=32]"][k] for k in cols}},
        {"name": "paged_attention_verify_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:1046",
         "launches": spec["launches_int8"]["paged_attention_verify_quant"],
         "max_abs_err": errs["paged_attention_verify_quant"],
         **{k: tm["paged_attention_verify_quant[B=8,T=5,NH=NKV=32]"][k]
            for k in cols}},
        {"name": "paged_verify_commit_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:1279",
         "launches": spec["launches_int8"]["paged_verify_commit_quant"],
         "max_abs_err": errs["paged_verify_commit_quant"],
         **{k: tm["paged_verify_commit_quant[L=32,B=8,T=5,KVD=4096]"][k]
            for k in cols}},
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
    kernels.append(
        {"name": "paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:191",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": errs["paged_attention"],
         **{k: tm["paged_attention[B=8,NH=NKV=32]"][k] for k in cols}})
    long_key = f"[B=1,NH=32,S={LONG_S},D=128,causal]"
    for name, line in (("flash_bwd_dkv", 1337), ("flash_bwd_dq", 1373)):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "paddle_tpu_torch/csrc/flash_attention.cu",
             "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
             "launches": tlong["modes"]["split"]["launches"][name],
             "max_abs_err": max([errs[name]] + [
                 r["max_abs_err"][f"{n} (split)"]
                 for r in along["shapes"].values()
                 for n in (("dq",) if name == "flash_bwd_dq"
                           else ("dk", "dv"))]),
             **{k: tm[name + long_key][k] for k in cols}})
    # rows 13 and 15: their functions run by rows 14's and 16's kernels at
    # the shapes that select them in JAX
    f13, f15 = along["shapes"][f"BH=8,S={LONG_S}"], \
        along["shapes"]["BH=4,S=131072"]
    kernels.append(
        {"name": "flash_fwd (row 13 cover: _flash_fwd_stream)",
         "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:498",
         "launches": tlong["modes"]["auto"]["launches"]["flash_fwd"],
         "max_abs_err": f13["max_abs_err"]["o"],
         **{k: tm[f"flash_fwd[BH=8,S={LONG_S},D=128,causal]"][k]
            for k in cols}})
    kernels.append(
        {"name": "flash_bwd (row 15 cover: _bwd_fused_stream_chunk)",
         "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:937",
         "launches": f15["modes"]["auto"]["launches"]["flash_bwd"],
         "max_abs_err": max(f15["max_abs_err"][f"{n} (row 16)"]
                            for n in ("dq", "dk", "dv")),
         **{k: tm["flash_bwd[BH=4,S=131072,D=128,causal]"][k]
            for k in cols}})
    # rows 12 and 19: their functions run by rows 11's and 20's kernels
    # (tests/test_torch_generate.py::test_pair_kernel_function_is_row_11,
    # tests/test_torch_varlen.py::test_stacked_row_19_function_is_row_20)
    slab_key = "[B=8,NH=32,NKV=4,HD=64,pos=1023]"
    kernels.append(
        {"name": "decode_attention_slab (row 12 cover: "
                 "_decode_attention_slab_pair)", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/decode_attention.cu",
         "replaces": "paddle_tpu/ops/decode_attention.py:569",
         "launches": gen["launches"]["decode_attention_slab"],
         "max_abs_err": errs["decode_attention_slab"],
         **{k: tm["decode_attention_slab" + slab_key][k] for k in cols}})
    short = sum(VARLEN_SHORT)
    kernels.append(
        {"name": "varlen_fwd (row 19 cover: _flash_varlen_fwd_stacked)",
         "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_varlen.cu",
         "replaces": "paddle_tpu/ops/flash_varlen.py:523",
         "launches": varlen["launches"]["varlen_fwd"],
         "max_abs_err": errs["varlen_fwd"],
         **{k: tm[f"varlen_fwd[short pack,T={short},H={VARLEN_H},"
                  f"D={VARLEN_D},causal]"][k] for k in cols}})
    # rows 3 and 5-9 also at a rank's shapes under serve-tp (NH = NKV =
    # 16, KVD 2048), with their launches in its ranks: rows 3, 7 and 9 in
    # the llama_7b runs, 5, 6 and 8 in the tiny check (at its heads)
    tp_runs = serve_tp_res["launches_rank0"]
    for kk in kernels:
        key = TP_RANK_TIMES.get(kk["name"])
        if key is None:
            continue
        kk["mp2_rank"] = {"shape": key, **{k: tm_tp[key][k] for k in cols},
                          "launches": tp_runs[kk["name"]]}
    # every kernel ran on its main path (rows 11, 12, 4 and 2 have no
    # caller)
    assert all(kk["launches"] > 0 for kk in kernels
               if kk["name"].split()[0] not in (
                   "decode_attention_slab", "paged_attention_quant",
                   "paged_attention")), kernels
    assert len(kernels) == 26, len(kernels)
    wall_s = time.perf_counter() - t_start
    record = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "build_nvcc_s": _build.BUILD_SECONDS,
              "max_abs_err": errs, "dead_columns": dead, "serve": serve,
              "serve_spec": spec,
              "serve_13b": serve13, "train": train,
              "train_policies": policies, "chunked_ce": ce,
              "train_13b": train13, "train_long": tlong, "attn_long": along,
              "ernie": ernie, "ernie_capacity": ernie_cap, "generate": gen,
              "varlen": varlen, "resume": resume, "fleet": fleet,
              "train_dp": train_dp_res, "serve_tp": serve_tp_res,
              "times": tm, "times_tp_rank": tm_tp,
              "phases": _PHASES, "wall_s": wall_s}
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
