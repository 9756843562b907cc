"""Times the design choices of the bf16 varlen split backward (rows 22 and
23, csrc/flash_varlen.cu) against each other on one card.

    python3 tools/varlen_choices.py

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, edited as its entry in FORMS says: the shipped form, and the forms
it was chosen over. Row 22 (varlen_bwd_wg_kernel): Q and dO stages filled
by a TMA producer warpgroup, against the consumers' own two-stage cp.async
ring (the dense row 16's form, with dK and dV stored as 4-byte pairs; its
kernel and launch are kept whole below); dV and dK as one m64n128k16
product each against one m64n64k16 product a 64-column block of D; the
consumer warpgroups running freely against taking turns to issue S^T and
dP^T. Row 23 (varlen_dq_wg_kernel): 128-key against 64-key K/V stages;
dQ staged through shared memory into 16-byte stores against 4-byte pairs
stored from the accumulator; one CTA a q tile (the last first) against
persistent CTAs that walk the same items in the same order (their kernel
and launch kept whole below). One more form runs the fused backward
(row 21, which ships on varlen_bwd_kernel) on row 22's body with its DQ
flag on, for the later PR that switches it.
Every copy builds at once, in a process of its own; then each copy runs
alone, in the order of FORMS and again in reverse, so that a drift of the
card over the call shows. A run holds rows 22 and 23 to their plain
versions (chip_smoke's ``varlen_case``, every output of every varlen
kernel: the short pack, and [127, 129, 1, 255] at D = 64 and 128 in both
layouts, causal and not), times them (device ms per call, 20 calls
queued ahead, chip_smoke's ``_time_ms``) at the long pack (16 x 4,096,
32 heads x 128, causal) and row 21 at the short pack, and reads their drift
along an f64 product (chip_smoke's ``varlen_split_drifts``). ptxas's
registers and spills of each form's split kernels are printed too. Needs
one CUDA device and nvcc; exits non-zero if a form fails its check;
writes chiprun_out/varlen_choices.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# row 22 with a two-stage cp.async ring filled by its own 256 threads (a
# strided form of load_sw128 with it): the kernel and its launch, each
# replacing the shipped one whole
CP_ASYNC_KERNEL = r"""// wgmma_common.cuh's load_sw128 for a matrix whose rows lie ld elements
// apart (a view such as [H, T, D] over a packed [T, H, D]: ld = H D)
template <int C, int ROWS, int NT>
__device__ __forceinline__ void load_sw128(__nv_bfloat16* s, const __nv_bfloat16* g, int r0, int n,
                                           size_t ld) {
  constexpr int CPR = C / 8;
  char* sb = reinterpret_cast<char*>(s);
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool live = r0 + r < n;
    cp_async16(sb + (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               live ? g + (size_t)(r0 + r) * ld + c * 8 : g, live ? 16 : 0);
  }
}

template <int D>
struct WgBwdCfg {
  static constexpr int BK = 128, BQ = 64, NT = 256;  // keys, q rows a step, threads
  static constexpr int NB = D / 64;                   // 64-column blocks of D
  static constexpr int KV_BYTES = BK * D * 2;         // K or V, resident
  static constexpr int QT_BYTES = BQ * D * 2;         // one stage of Q or dO
  static constexpr int DS_BYTES = BK * BQ * 2;        // dS^T [keys][q rows] (DQ)
  static constexpr int OFF_V = KV_BYTES, OFF_Q = 2 * KV_BYTES, OFF_DO = OFF_Q + 2 * QT_BYTES,
                       OFF_DS = OFF_DO + 2 * QT_BYTES, OFF_STAT = OFF_DS + DS_BYTES;
  // two stages of (lse, delta), and slack to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_STAT + 2 * 2 * BQ * 4 + 1024;
};

// q, dout [H, Tq, D], k, v [H, Tk, D] bf16 in the layouts lq, lk; lse
// (natural log), delta [H, Tq] f32; dk, dv in k's layout, written whole.
// DQ: dq_acc f32 in q's layout, zero on entry, gets dQ by float2 atomics.
// 256 threads, grid (ceil(Tk / 128), H).
template <int D, bool DQ>
__global__ void __launch_bounds__(256, 1)
    varlen_bwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         Seqs S, Lay lq, Lay lk, float c2, float scale) {
  using C = WgBwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lo[8], s_hi[8];
  unsigned char* sm = align1024(smem_raw);
  float* stat = reinterpret_cast<float*>(sm + C::OFF_STAT);  // stage st: lse, then delta
  const uint32_t ka = smem_u32(sm), va = ka + C::OFF_V, qa0 = ka + C::OFF_Q,
                 doa0 = ka + C::OFF_DO;
  [[maybe_unused]] const uint32_t dsa = ka + C::OFF_DS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, wiw = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;  // low keys of a segment have the most live q tiles
  const size_t h = blockIdx.y;
  const bf16* qg = q + h * lq.hs;
  const bf16* dog = dout + h * lq.hs;
  const float* lseg = lse + h * S.tq;
  const float* dlg = delta + h * S.tq;

  // this warpgroup owns keys k0 + 64 wg ..; this warp 16 of them, this
  // lane key0 and key1 with their live query intervals
  const int krow = 64 * wg + 16 * wiw + g;  // key0's row of the CTA's tile
  const int key0 = k0 + krow, key1 = key0 + 8;
  int lo0, hi0, lo1, hi1;
  query_range(S, key0, lo0, hi0);
  query_range(S, key1, lo1, hi1);
  const WarpSpan w = warp_span(lo0, hi0, lo1, hi1);
  if (lane == 0) {
    s_lo[warp] = w.lo;
    s_hi[warp] = w.hi;
  }

  auto load_stage = [&](int st, int i) {
    load_sw128<D, BQ, NT>(reinterpret_cast<bf16*>(sm + C::OFF_Q + st * C::QT_BYTES), qg, i * BQ,
                          S.tq, lq.rs);
    load_sw128<D, BQ, NT>(reinterpret_cast<bf16*>(sm + C::OFF_DO + st * C::QT_BYTES), dog,
                          i * BQ, S.tq, lq.rs);
    for (int x = tid; x < 2 * BQ; x += NT) {
      const int r = i * BQ + (x % BQ);
      const float* src = x < BQ ? lseg : dlg;
      cp_async4(stat + st * 2 * BQ + x, src + (r < S.tq ? r : 0), r < S.tq ? 4 : 0);
    }
  };

  // K and V stay for the CTA's life
  load_sw128<D, BK, NT>(reinterpret_cast<bf16*>(sm), k + h * lk.hs, k0, S.tk, lk.rs);
  load_sw128<D, BK, NT>(reinterpret_cast<bf16*>(sm + C::OFF_V), v + h * lk.hs, k0, S.tk, lk.rs);
  __syncthreads();  // every warp's span is in s_lo, s_hi
  // the CTA walks the union of its keys' live q tiles; a warpgroup skips
  // a tile that none of its keys sees
  int clo, chi, glo[2], ghi[2];
  span_of(s_lo, s_hi, 0, 8, clo, chi);
  span_of(s_lo, s_hi, 0, 4, glo[0], ghi[0]);
  span_of(s_lo, s_hi, 4, 4, glo[1], ghi[1]);
  const int i0 = chi > clo ? clo / BQ : 0;
  const int ni = chi > clo ? (chi - 1) / BQ - i0 + 1 : 0;

  float dkc[NB][32], dvc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) dkc[b][e] = dvc[b][e] = 0.f;

  // q tile i + 1 is in flight while tile i is used
  if (ni > 0) load_stage(0, i0);
  cp_commit();
  for (int ii = 0; ii < ni; ++ii) {
    const int st = ii & 1, r0 = (i0 + ii) * BQ;
    cp_wait<0>();
    fence_async_smem();
    // q tile ii is in place for every thread; every warpgroup is done with
    // tile ii - 1, whose stage the next copy refills
    __syncthreads();
    if (ii + 1 < ni) {
      load_stage(st ^ 1, i0 + ii + 1);
      cp_commit();
    }
    const bool on0 = r0 < ghi[0] && r0 + BQ > glo[0], on1 = r0 < ghi[1] && r0 + BQ > glo[1];
    const bool on = wg ? on1 : on0;
    [[maybe_unused]] uint32_t dsf[16];
    if (on) {
      const uint32_t qa = qa0 + st * C::QT_BYTES, doa = doa0 + st * C::QT_BYTES;
      const float* lse_s = stat + st * 2 * BQ;
      const float* dl_s = lse_s + BQ;

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int x = 0; x < D / 16; ++x) {
        const uint32_t ko = (x >> 2) * (BK * 128) + wg * 64 * 128 + (x & 3) * 32;
        const uint32_t qo = (x >> 2) * (BQ * 128) + (x & 3) * 32;
        wgmma_ss<0, 0>(s, sw128_desc(ka + ko, 16, 1024), sw128_desc(qa + qo, 16, 1024), x);
      }
#pragma unroll
      for (int x = 0; x < D / 16; ++x) {
        const uint32_t ko = (x >> 2) * (BK * 128) + wg * 64 * 128 + (x & 3) * 32;
        const uint32_t qo = (x >> 2) * (BQ * 128) + (x & 3) * 32;
        wgmma_ss<0, 0>(dp, sw128_desc(va + ko, 16, 1024), sw128_desc(doa + qo, 16, 1024), x);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P^T = exp2(S^T c2 - lse2), 0 outside each key's live query
      // interval, rounded for dV; dS^T = P^T (dP^T - delta) scale, rounded
      // for dK (and dQ). Only a tile that crosses an end of one of the
      // warp's intervals is masked (a warp-uniform branch).
      const bool masked = !(r0 >= w.lo_max && r0 + BQ <= w.hi_min);
      uint32_t pf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1), qrow = r0 + ql;
          const bool live = e < 2 ? (qrow >= lo0 && qrow < hi0) : (qrow >= lo1 && qrow < hi1);
          pe[e] = masked && !live ? 0.f : exp2f(s[4 * j + e] * c2 - lse_s[ql] * kLog2e);
          de[e] = pe[e] * (dp[4 * j + e] - dl_s[ql]) * scale;
        }
        pf[2 * j] = pack_bf16(pe[0], pe[1]);
        pf[2 * j + 1] = pack_bf16(pe[2], pe[3]);
        dsf[2 * j] = pack_bf16(de[0], de[1]);
        dsf[2 * j + 1] = pack_bf16(de[2], de[3]);
      }

      // dV += round(P^T) dO and dK += round(dS^T) Q: each q tile's product
      // in a zeroed accumulator, 64 columns at a time, added to the running
      // f32 sums with IEEE adds (the tensor cores' own f32 sums round
      // toward zero, and a sum carried in them over a long segment drifts)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float pr[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                      sw128_desc(doa + b * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(pr);
#pragma unroll
        for (int e = 0; e < 32; ++e) dvc[b][e] += pr[e];
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float pr[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                      sw128_desc(qa + b * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(pr);
#pragma unroll
        for (int e = 0; e < 32; ++e) dkc[b][e] += pr[e];
      }
    }

    if constexpr (DQ) {
      // dQ tile += dS K over this CTA's keys, from dS^T in shared memory
      // (MN-major A) and K (MN-major B), summed across CTAs by float2
      // atomics (a zero pair sends none). D = 128: warpgroup wg takes
      // columns 64 wg.. over all 128 keys (a warpgroup that skipped the
      // tile writes zero rows); D = 64: all columns over its own keys.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow, 8 * j + 2 * t)) =
            on ? dsf[2 * j] : 0u;
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow + 8, 8 * j + 2 * t)) =
            on ? dsf[2 * j + 1] : 0u;
      }
      fence_async_smem();
      if constexpr (D == 128)
        __syncthreads();
      else
        wg_bar(1 + wg);
      if (D == 128 ? on0 || on1 : on) {
        float dqp[32];
        wg_fence();
        if constexpr (D == 128) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss<1, 1>(dqp, sw128_desc(dsa + kk * 2048, BK * 128, 1024),
                           sw128_desc(ka + wg * (BK * 128) + kk * 2048, BK * 128, 1024), kk);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1, 1>(dqp, sw128_desc(dsa + wg * 8192 + kk * 2048, BK * 128, 1024),
                           sw128_desc(ka + wg * 8192 + kk * 2048, BK * 128, 1024), kk);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence(dqp);
        const int qa_row = r0 + 16 * wiw + g, qb_row = qa_row + 8;
        float* dqg = dq_acc + h * lq.hs;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (D == 128 ? 64 * wg : 0) + 8 * j + 2 * t;
          if (qa_row < S.tq && (dqp[4 * j] != 0.f || dqp[4 * j + 1] != 0.f))
            atomicAdd(reinterpret_cast<float2*>(dqg + qa_row * lq.rs + col),
                      make_float2(dqp[4 * j], dqp[4 * j + 1]));
          if (qb_row < S.tq && (dqp[4 * j + 2] != 0.f || dqp[4 * j + 3] != 0.f))
            atomicAdd(reinterpret_cast<float2*>(dqg + qb_row * lq.rs + col),
                      make_float2(dqp[4 * j + 2], dqp[4 * j + 3]));
        }
      }
    }
  }

  cp_wait<0>();  // no copy outlives the CTA
  bf16* dkg = dk + h * lk.hs;
  bf16* dvg = dv + h * lk.hs;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * b + 8 * j + 2 * t;
      if (key0 < S.tk) {
        st_pair(dkg + key0 * lk.rs + col, dkc[b][4 * j], dkc[b][4 * j + 1]);
        st_pair(dvg + key0 * lk.rs + col, dvc[b][4 * j], dvc[b][4 * j + 1]);
      }
      if (key1 < S.tk) {
        st_pair(dkg + key1 * lk.rs + col, dkc[b][4 * j + 2], dkc[b][4 * j + 3]);
        st_pair(dvg + key1 * lk.rs + col, dvc[b][4 * j + 2], dvc[b][4 * j + 3]);
      }
    }
}

"""
CP_ASYNC_LAUNCH = r"""// bf16 split dK/dV on wgmma
template <int D>
cudaError_t launch_bwd_dkv_wg(const Args& a, cudaStream_t stream) {
  using C = WgBwdCfg<D>;
  cudaError_t e = allow_smem(varlen_bwd_wg_kernel<D, false>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S.tk + C::BK - 1) / C::BK, a.h);
  if (grid.x == 0) return cudaSuccess;
  varlen_bwd_wg_kernel<D, false><<<grid, C::NT, C::kSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), nullptr, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, lay(a.packed, a.h, a.S.tq, D),
      lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e, a.scale);
  return cudaGetLastError();
}

"""
_KERNEL = ("template <int D>\nstruct WgBwdCfg",
           "// ---------------------------------------------------------------"
           "------------\n// split dQ for bf16 on wgmma (row 23)")
_LAUNCH = ("// bf16 split dK/dV on wgmma", "// bf16 split dQ on wgmma")
_DQ_STORE = ("  // dQ rounded to bf16 and staged", "template <typename T>\n"
             "__global__ void dq_cast_kernel")
PAIR_STORE = """  // dQ rounded to bf16, stored as 4-byte pairs from the accumulator
  bf16* dqg = dq + (size_t)h * lq.hs;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < S.tq) st_pair(dqg + row0 * lq.rs + col, acc[4 * j], acc[4 * j + 1]);
    if (row1 < S.tq) st_pair(dqg + row1 * lq.rs + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

"""
# row 22: dV and dK as one m64n64k16 product a 64-column block of D
_DKV_PRODUCTS = ("      // dV += round(P^T) dO and dK += round(dS^T) Q over all D columns",
                 "    if constexpr (DQ) {\n      // dQ tile += dS K")
N64_PRODUCTS = """      // dV and dK, one 64-column block of D at a time
#pragma unroll
      for (int b = 0; b < D / 64; ++b) {
        float pr[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                      sw128_desc(doa + b * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(pr);
#pragma unroll
        for (int e = 0; e < 32; ++e) dvc[32 * b + e] += pr[e];
      }
#pragma unroll
      for (int b = 0; b < D / 64; ++b) {
        float pr[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                      sw128_desc(qa + b * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(pr);
#pragma unroll
        for (int e = 0; e < 32; ++e) dkc[32 * b + e] += pr[e];
      }
    }

"""
# row 22: the two consumer warpgroups take turns issuing S^T and dP^T
# (named barriers 5 and 6), as the dense forward does with S
_DKV_LOOP = ("  if (ni > 0) mbar_wait(kvbar, 0);\n"
             "  for (int ii = 0; ii < ni; ++ii) {\n"
             "    const int st = ii % NS, r0 = (i0 + ii) * BQ;\n"
             "    mbar_wait(&full[st], (ii / NS) & 1);\n")
_DKV_ISSUED = "      wg_commit();\n    }\n    [[maybe_unused]] uint32_t dsf[16];\n"
TURNS = [
    (_DKV_LOOP, "  if (wg == 1 && ni > 0) bar_arrive(5, 256);  // warpgroup 0 first\n"
     + _DKV_LOOP + "    bar_sync(5 + wg, 256);\n"),
    (_DKV_ISSUED, "      wg_commit();\n    }\n"
     "    if (wg == 0 || ii + 1 < ni) bar_arrive(6 - wg, 256);\n"
     "    [[maybe_unused]] uint32_t dsf[16];\n"),
]
# row 23 in persistent CTAs (min(SMs, items) of them, the same item order):
# the kernel and its launch, each replacing the shipped one whole
PERSISTENT_DQ = r"""template <int D>
struct WgDqCfg {
  static constexpr int BQ = 128, BK = 128;        // q rows a CTA, keys a stage
  static constexpr int NB = D / 64;               // 64-column blocks of D
  static constexpr int QT_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int NS = 131072 / (2 * KV_BYTES);  // ring stages: 128 KB of K and V
  static constexpr int OFF_DO = QT_BYTES, OFF_KV = 2 * QT_BYTES;  // stage st: K, then V
  static constexpr int OFF_BAR = OFF_KV + NS * 2 * KV_BYTES;
  // barriers (Q and dO landed, Q and dO free, NS stages full, NS stages
  // empty), and slack to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * (2 + 2 * NS) + 1024;
};

// Persistent CTAs: CTA b takes items b, b + gridDim.x, ... of the
// ceil(Tq / 128) x nh items (head-major, the last q tile of a head first);
// the producer computes each item's key span itself, loads up to NS of its
// stages while the consumers finish the item before, then its Q and dO
// once they have stored that item's dQ.
template <int D>
__global__ void __launch_bounds__(384, 1)
    varlen_dq_wg_kernel(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap dom,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, Seqs S, Lay lq,
                        float c2, float scale, int nh) {
  using C = WgDqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lo[2][8], s_hi[2][8], p_lo[2][4], p_hi[2][4], s_j[2][2];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qempty + 1;
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, wiw = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ntiles = (S.tq + BQ - 1) / BQ, items = ntiles * nh;
  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 256);  // every consumer thread has stored the item's dQ
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    const int pt = tid - 256;
    int c = 0;  // the ring's stage count
    for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
      const int h = it / ntiles, q0 = (ntiles - 1 - it % ntiles) * BQ;
      // the item's key span, one row a thread
      int lo, hi;
      key_range(S, q0 + pt, lo, hi);
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        p_lo[k & 1][pt >> 5] = lo;
        p_hi[k & 1][pt >> 5] = hi;
      }
      bar_sync(3, 128);
      int clo, chi;
      span_of(p_lo[k & 1], p_hi[k & 1], 0, 4, clo, chi);
      const int j0 = chi > clo ? clo / BK : 0;
      const int nj = chi > clo ? (chi - 1) / BK - j0 + 1 : 0;
      if (pt != 0) continue;
      s_j[k & 1][0] = j0;
      s_j[k & 1][1] = nj;
      auto stage = [&](int jj) {
        const int st = c % NS;
        if (c >= NS) mbar_wait(&empty[st], ((c / NS) & 1) ^ 1);
        unsigned char* ks = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(ks + b * (BK * 128), &km, &full[st], 64 * b, (j0 + jj) * BK, h);
          tma_load_3d(ks + C::KV_BYTES + b * (BK * 128), &vm, &full[st], 64 * b,
                      (j0 + jj) * BK, h);
        }
        ++c;
      };
      int jj = 0;
      for (; jj < min(nj, NS); ++jj) stage(jj);
      if (k > 0) mbar_wait(qempty, (k - 1) & 1);  // the item before is stored
      if (nj > 0) {
        mbar_expect_tx(qfull, 2 * C::QT_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(sm + b * (BQ * 128), &qm, qfull, 64 * b, q0, h);
          tma_load_3d(sm + C::OFF_DO + b * (BQ * 128), &dom, qfull, 64 * b, q0, h);
        }
      } else {
        mbar_arrive(qfull);
      }
      for (; jj < nj; ++jj) stage(jj);
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int rloc = 64 * wg + 16 * wiw + g;  // row0's row of the CTA's tile
  const uint32_t qa = smem_u32(sm) + wg * 64 * 128, doa = qa + C::OFF_DO;
  int c = 0;
  for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
    const int h = it / ntiles, q0 = (ntiles - 1 - it % ntiles) * BQ;
    // consumer warpgroup wg owns q rows q0 + 64 wg ..; this warp 16 of
    // them, this lane row0 and row1 with their live key intervals
    const int row0 = q0 + rloc, row1 = row0 + 8;
    int lo0, hi0, lo1, hi1;
    key_range(S, row0, lo0, hi0);
    key_range(S, row1, lo1, hi1);
    const WarpSpan w = warp_span(lo0, hi0, lo1, hi1);
    if (lane == 0) {
      s_lo[k & 1][warp] = w.lo;
      s_hi[k & 1][warp] = w.hi;
    }
    wg_bar(1 + wg);
    int glo, ghi;
    span_of(s_lo[k & 1], s_hi[k & 1], 4 * wg, 4, glo, ghi);
    const float lse0 = row0 < S.tq ? lse[(size_t)h * S.tq + row0] * kLog2e : 0.f;
    const float lse1 = row1 < S.tq ? lse[(size_t)h * S.tq + row1] * kLog2e : 0.f;
    const float dl0 = row0 < S.tq ? delta[(size_t)h * S.tq + row0] : 0.f;
    const float dl1 = row1 < S.tq ? delta[(size_t)h * S.tq + row1] : 0.f;
    float acc[D / 2];  // m64nD accumulator layout
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    mbar_wait(qfull, k & 1);
    const int j0 = s_j[k & 1][0], nj = s_j[k & 1][1];
    for (int jj = 0; jj < nj; ++jj, ++c) {
      const int st = c % NS, c0 = (j0 + jj) * BK;
      mbar_wait(&full[st], (c / NS) & 1);
      if (c0 < ghi && c0 + BK > glo) {
        const uint32_t ka = smem_u32(sm + C::OFF_KV + st * 2 * C::KV_BYTES), va = ka + C::KV_BYTES;
        float s[BK / 2], dp[BK / 2];
        wg_fence();
#pragma unroll
        for (int x = 0; x < D / 16; ++x)
          wgmma_ss<0, 0, BK>(s, sw128_desc(qa + (x >> 2) * (BQ * 128) + (x & 3) * 32, 16, 1024),
                             sw128_desc(ka + (x >> 2) * (BK * 128) + (x & 3) * 32, 16, 1024), x);
#pragma unroll
        for (int x = 0; x < D / 16; ++x)
          wgmma_ss<0, 0, BK>(dp, sw128_desc(doa + (x >> 2) * (BQ * 128) + (x & 3) * 32, 16, 1024),
                             sw128_desc(va + (x >> 2) * (BK * 128) + (x & 3) * 32, 16, 1024), x);
        wg_commit();
        wg_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        const bool masked = !(c0 >= w.lo_max && c0 + BK <= w.hi_min);
        uint32_t dsf[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          float de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            const bool live = e < 2 ? (col >= lo0 && col < hi0) : (col >= lo1 && col < hi1);
            const float p =
                masked && !live ? 0.f : exp2f(s[4 * j + e] * c2 - (e < 2 ? lse0 : lse1));
            de[e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1)) * scale;
          }
          dsf[2 * j] = pack_bf16(de[0], de[1]);
          dsf[2 * j + 1] = pack_bf16(de[2], de[3]);
        }
        float pr[D / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<1, D>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                         sw128_desc(ka + kk * 2048, BK * 128, 1024), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(pr);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] += pr[e];
      }
      mbar_arrive(&empty[st]);
    }

    // dQ staged in this warpgroup's own rows of the Q tile, then stored
    wg_bar(1 + wg);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc, col)) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc + 8, col)) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    wg_bar(1 + wg);
    bf16* dqg = dq + (size_t)h * lq.hs;
    for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
      const int rr = 64 * wg + i / (D / 8), cc = 8 * (i % (D / 8)), row = q0 + rr;
      if (row < S.tq)
        *reinterpret_cast<uint4*>(dqg + row * lq.rs + cc) =
            *reinterpret_cast<const uint4*>(sm + sw128_offset<BQ>(rr, cc));
    }
    fence_async_smem();
    mbar_arrive(qempty);  // the next item's Q and dO may land here
  }
}

"""
PERSISTENT_DQ_LAUNCH = r"""// bf16 split dQ on wgmma, the K/V ring filled by TMA; persistent CTAs
template <int D>
cudaError_t launch_dq_wg(const Args& a, cudaStream_t stream) {
  using C = WgDqCfg<D>;
  const int ntiles = (a.S.tq + C::BQ - 1) / C::BQ;
  if (ntiles == 0) return cudaSuccess;
  CUtensorMap maps[4] = {};
  int dev = 0, sms = 0;
  cudaError_t e = varlen_maps(a, D, C::BQ, C::BK, maps);
  if (e == cudaSuccess) e = allow_smem(varlen_dq_wg_kernel<D>, C::kSmem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int items = ntiles * a.h;
  varlen_dq_wg_kernel<D><<<items < sms ? items : sms, 384, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.S,
      lay(a.packed, a.h, a.S.tq, D), a.scale * kLog2e, a.scale, a.h);
  return cudaGetLastError();
}

"""
_DQ_KERNEL = ("template <int D>\nstruct WgDqCfg", "template <typename T>\n"
              "__global__ void dq_cast_kernel")
_DQ_LAUNCH = ("// bf16 split dQ on wgmma, the K/V ring", "template <typename T, int D>\n"
              "cudaError_t launch_dq(")
# row 21 (the fused backward) on row 22's body with DQ on: dQ by float2
# atomics into the wrapper's zeroed f32 scratch, then its cast pass (row
# 21 itself stays on varlen_bwd_kernel; this form measures the switch)
FUSED_LAUNCH = """// bf16 fused backward on row 22's wgmma body
template <int D>
cudaError_t launch_bwd_fused_wg(const Args& a, cudaStream_t stream) {
  using C = WgBwdCfg<D>;
  const dim3 grid((a.S.tk + C::BK - 1) / C::BK, a.h);
  cudaError_t e = cudaSuccess;
  if (grid.x > 0) {
    CUtensorMap maps[4] = {};
    e = varlen_maps(a, D, C::BQ, C::BK, maps);
    if (e == cudaSuccess) e = allow_smem(varlen_bwd_wg_kernel<D, true>, C::kSmem);
    if (e != cudaSuccess) return e;
    varlen_bwd_wg_kernel<D, true><<<grid, 384, C::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.dq_acc),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, lay(a.packed, a.h, a.S.tq, D),
        lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e, a.scale);
    e = cudaGetLastError();
  }
  const size_t n = (size_t)a.h * a.S.tq * D;
  if (e != cudaSuccess || n == 0) return e;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  dq_cast_kernel<bf16><<<blocks, 256, 0, stream>>>(static_cast<const float*>(a.dq_acc),
                                                   static_cast<bf16*>(a.dq), n);
  return cudaGetLastError();
}

"""
_LAUNCH_DQ_F32 = "template <typename T, int D>\ncudaError_t launch_dq(const Args& a"
FUSED = [
    (_LAUNCH_DQ_F32, FUSED_LAUNCH + _LAUNCH_DQ_F32),
    ("    case 1: return launch_bwd<T, D, true>(a, s);\n",
     "    case 1:\n      if constexpr (wg) return launch_bwd_fused_wg<D>(a, s);\n"
     "      else return launch_bwd<T, D, true>(a, s);\n"),
]
# name -> [((start, end) of the span to replace, or the text itself), new]
FORMS = {
    "shipped": [],
    "dkv_cp_async": [(_KERNEL, CP_ASYNC_KERNEL), (_LAUNCH, CP_ASYNC_LAUNCH)],
    "dkv_n64_products": [(_DKV_PRODUCTS, N64_PRODUCTS)],
    "dkv_turns": TURNS,
    "dq_64_key_stages": [
        ("  static constexpr int BQ = 128, BK = 128;        // q rows a CTA, "
         "keys a stage\n",
         "  static constexpr int BQ = 128, BK = 64;         // q rows a CTA, "
         "keys a stage\n")],
    "dq_pair_store": [(_DQ_STORE, PAIR_STORE)],
    "dq_persistent": [(_DQ_KERNEL, PERSISTENT_DQ),
                      (_DQ_LAUNCH, PERSISTENT_DQ_LAUNCH)],
    "fused_on_row_22_body": FUSED,
}


def edited(src, edits, name):
    """src with a form's edits: a (start, end) pair replaces the text from
    start up to end (end kept); a string replaces itself. Each is met once."""
    for old, new in edits:
        if isinstance(old, tuple):
            assert src.count(old[0]) == 1 and src.count(old[1]) == 1, (name, old)
            i, j = src.index(old[0]), src.index(old[1])
            assert i < j, (name, old)
            old = src[i:j]
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    return src


def _chip_smoke():
    sys.path.append(ROOT)
    import chip_smoke
    return chip_smoke


def build_one():
    """In a copy's process: build, print ptxas's lines as JSON."""
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch import _build
    _build.build_all(["flash_varlen"])
    lines = [ln for ln in chip_smoke.ptxas_lines(
        _build.BUILD_LOGS.get("flash_varlen", ""))
        if ln.startswith(("varlen_bwd_wg", "varlen_dq_wg"))]
    print(json.dumps(lines))


def run_one():
    """In a copy's process: check, time, drift, as one JSON line."""
    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.ops import flash_varlen as fv
    assert not fv.__file__.startswith(ROOT), fv.__file__
    dev = torch.device("cuda", 0)
    h, d, scale = cs.VARLEN_H, cs.VARLEN_D, cs.VARLEN_D ** -0.5
    check = []
    cases = [("short pack", cs.VARLEN_SHORT, h, d, True, True)]
    cases += [(f"[127, 129, 1, 255] D={dd} {'packed' if p else 'contiguous'}"
               f" causal={c}", [127, 129, 1, 255], 3, dd, p, c)
              for dd in (64, 128) for p in (True, False) for c in (True, False)]
    for i, (name, lens, hh, dd, packed, causal) in enumerate(cases):
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, hh,
                                        dd, cs.SEED + 80 + i)
        if not packed:      # [T, H, D] views of contiguous [H, T, D]
            q, k, v, do = (x.transpose(0, 1).contiguous().transpose(0, 1)
                           for x in (q, k, v, do))
        cu = cs._cu_dev(lens, dev)
        res = cs.varlen_case(fv, q, k, v, do, cu, cu, causal,
                             torch.bfloat16)[0]
        check.append({"case": name, "ok": all(r[0] for r in res.values()),
                      "rel_frob": {n: r[2] for n, r in res.items()}})
        del q, k, v, do
    ms = {}
    for pack, lens in (("short", cs.VARLEN_SHORT), ("long", cs.VARLEN_LONG)):
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, h,
                                        d, cs.SEED + 60)
        cu = cs._cu_dev(lens, dev)
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        o, lse = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        delta = (doh.float() * o.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        calls = ({"varlen_bwd": fv.varlen_bwd} if pack == "short" else
                 {"varlen_bwd_dkv": fv.varlen_bwd_dkv,
                  "varlen_bwd_dq": fv.varlen_bwd_dq})
        for name, fn in calls.items():
            ms[name] = cs._time_ms(lambda: fn(*args), 20)[0]
        del o, args, qh, kh, vh, doh
    torch.cuda.empty_cache()
    drift = cs.varlen_split_drifts(fv, q, k, v, do, lens)
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
    tmp = tempfile.mkdtemp(prefix="varlen_choices_")
    copies, procs = {}, []
    record = {"nvidia_smi": smi, "ptxas": {}, "runs": []}
    good = True
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "flash_varlen.cu")).read()
    try:
        for name, edits in FORMS.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            with open(os.path.join(pkg, "csrc", "flash_varlen.cu"), "w") as f:
                f.write(edited(src, edits, name))
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
            good &= run["ok"] and all(x["ok"] for x in run["drift"].values())
            print(json.dumps({"form": name, "ok": run["ok"], "ms": run["ms"],
                              "drift_excess": {n: x["excess"] for n, x in
                                               run["drift"].items()}}))
            if not run["ok"]:
                print(f"{name} FAILED its check: "
                      f"{[c for c in run['check'] if not c['ok']]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "varlen_choices.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one()
    elif sys.argv[1:2] == ["--dry"]:   # the edits apply (no card needed)
        text = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                                 "flash_varlen.cu")).read()
        for n, e in FORMS.items():
            edited(text, e, n)
        print(f"{len(FORMS)} forms: every edit applies once")
    else:
        main()
