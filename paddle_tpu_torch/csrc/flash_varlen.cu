// Packed varlen flash attention (flash_attn_unpadded) for Hopper (sm_90a).
//
// Replaces four TPU kernels of paddle_tpu/ops/flash_varlen.py:
//   varlen_fwd     <- _flash_varlen_fwd_impl (kernel _fwd_kernel_varlen); its
//                     function at another TPU tiling, _flash_varlen_fwd_stacked
//                     (_fwd_kernel_varlen_stacked), is covered by the same kernel;
//   varlen_bwd     <- _bwd_fused_call (_bwd_fused_kernel_varlen): dQ, dK, dV in
//                     one pass;
//   varlen_bwd_dkv <- _flash_varlen_bwd's split dK/dV (_bwd_dkv_flat_kernel);
//   varlen_bwd_dq  <- _flash_varlen_bwd's split dQ (_bwd_dq_flat_kernel).
//
// Function. Sequences are packed along the token axis; cu_q and cu_k
// [n_seq + 1] int32 hold their offsets (cu[0] = 0, cu[n_seq] = total). Query
// row r of segment s (pos = r - cu_q[s]) attends keys [cu_k[s], cu_k[s + 1]),
// and under causal only those with key - cu_k[s] <= pos (top-left within the
// segment, also for cross-attention with unequal lengths). Scores are
// dot(q, k) * scale in f32 (scale folded into the f32 score, never into q);
// the softmax runs in the log2 domain (score * scale * log2 e, exp2). A row
// with no live key gets o = 0 and lse = 0. Tokens at or past cu[n_seq] belong
// to no segment and are dead in the same way.
//
// Layout. Every [H, T, D] operand is read where it lies: either head-major
// (head stride T D, row stride D) or the packed [T, H, D] of the public API
// (head stride D, row stride H D), chosen by one flag for all operands, so
// the packed tensors of flash_attn_unpadded need no transposed copies. lse
// and delta are [H, T] f32 (lse in the natural log).
//
// What bounds them on this card: operations. At Llama-2-7B's attention width
// (32 heads x 128, bf16, causal) over bench.py's 16-sequence pack (16,000
// tokens, sum L^2 / 2 = 2.05e7 live pairs a head) the forward does 2
// products of 2 D operations per live pair (2.1e11, 0.21 ms at 989 TFLOP/s)
// over 0.13 GB (0.16 ms at 3.35 TB/s); the backward does 5 (0.53 ms).
//
// Design (the port's dense flash kernels, csrc/flash_attention.cu, not the
// TPU's flat grid). mma.sync m16n8k16 warp tiles from csrc/mma_common.cuh,
// 16-byte cp.async in a two-stage pipeline, one barrier per tile.
// - No schedule arrays and no host sync: each thread finds the segment of
//   its own rows (or keys) by binary search of cu in device memory and keeps
//   the row's live key interval [lo, hi) (or the key's live query interval)
//   in registers. The CTA's live tile range is the union of its rows'
//   intervals (warp and block min/max), which is _live_col_tiles with the
//   causal diagonal clamp of _fwd_bounds / _bwd_bounds, at this kernel's
//   tiles. A warp skips a tile that holds no live pair of its rows (an exact
//   no-op of the online softmax), and masks only where a tile crosses one of
//   its rows' interval ends.
// - Masking to -inf with a guarded rescale: a running max still at -inf uses
//   0 as its base, so exp2(-inf - base) = 0 and no NaN arises where a q tile
//   spans segments and a row sees k tiles that are wholly masked for it. The
//   backward masks P to 0 itself (it does not rely on lse, which is 0 for a
//   dead row).
// - Forward: one CTA of 4 warps per (64-row q tile, head); 64-key tiles; P
//   rounded to the input dtype before P.V, the normaliser summing the
//   unrounded P.
// - Fused backward: one CTA per (64-key tile, head) over its live q tiles
//   (32 rows at D = 128, 64 at D = 64); dK and dV in f32 registers; dS =
//   P (dP - delta) scale rounded to the input dtype; dQ += dS K summed across
//   CTAs by f32 atomicAdd into a zeroed scratch (pairs that are exactly zero,
//   such as rows with no live key, send no atomic), then a cast pass. The
//   summation order of dQ varies from run to run.
// - Split backward: varlen_bwd_dkv is the fused CTA without dQ;
//   varlen_bwd_dq is one CTA per (64-row q tile, head) over its live k tiles,
//   recomputing S and dP (7 products across the pair), dQ in registers, no
//   atomics: the same bits every run.
//
// Types f32 and bf16, head_dim 64 and 128. The kernels allocate nothing and
// do not synchronise; they launch on the caller's stream.
#include <math.h>
#include <limits.h>

#include "mma_common.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct Seqs {
  const int* cu_q;
  const int* cu_k;
  int n_seq, tq, tk, causal;
};

// element offsets of an [H, T, D] operand: head h, row r at h * hs + r * rs
struct Lay {
  size_t hs, rs;
};

// the segment of token t: the last s with cu[s] <= t (searchsorted, side
// "right", minus one); n_seq for a token at or past cu[n_seq]
__device__ __forceinline__ int seg_of(const int* cu, int n_seq, int t) {
  int lo = 0, hi = n_seq + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu + mid) <= t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

// live keys [lo, hi) of query row `row`; a dead row gets lo = INT_MAX, hi = 0
__device__ __forceinline__ void key_range(const Seqs& S, int row, int& lo, int& hi) {
  lo = INT_MAX;
  hi = 0;
  if (row >= S.tq) return;
  const int s = seg_of(S.cu_q, S.n_seq, row);
  if (s < 0 || s >= S.n_seq) return;
  const int a = __ldg(S.cu_k + s);
  int b = __ldg(S.cu_k + s + 1);
  if (S.causal) b = min(b, a + (row - __ldg(S.cu_q + s)) + 1);
  if (b > a) {
    lo = a;
    hi = b;
  }
}

// live query rows [lo, hi) of key `key`; a dead key gets lo = INT_MAX, hi = 0
__device__ __forceinline__ void query_range(const Seqs& S, int key, int& lo, int& hi) {
  lo = INT_MAX;
  hi = 0;
  if (key >= S.tk) return;
  const int s = seg_of(S.cu_k, S.n_seq, key);
  if (s < 0 || s >= S.n_seq) return;
  const int a = __ldg(S.cu_q + s) + (S.causal ? key - __ldg(S.cu_k + s) : 0);
  const int b = __ldg(S.cu_q + s + 1);
  if (b > a) {
    lo = a;
    hi = b;
  }
}

// Bounds of one warp's two intervals per lane: union [lo, hi) and the
// intersection's ends (lo_max, hi_min: a tile inside them needs no mask).
struct WarpSpan {
  int lo, hi, lo_max, hi_min;
};

__device__ __forceinline__ WarpSpan warp_span(int lo0, int hi0, int lo1, int hi1) {
  WarpSpan w;
  w.lo = __reduce_min_sync(0xffffffffu, min(lo0, lo1));
  w.hi = __reduce_max_sync(0xffffffffu, max(hi0, hi1));
  w.lo_max = __reduce_max_sync(0xffffffffu, max(lo0, lo1));
  w.hi_min = __reduce_min_sync(0xffffffffu, min(hi0, hi1));
  return w;
}

// The CTA's union [lo, hi) from each warp's (after the barrier that follows
// the writes to s_lo, s_hi)
__device__ __forceinline__ void cta_span(const int* s_lo, const int* s_hi, int& lo, int& hi) {
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD, LDP = BK + PAD;
  // q tile, two stages of (K tile, V tile), P
  static constexpr size_t kSmem = sizeof(T) * ((size_t)BQ * LD + 4 * BK * LD + BQ * LDP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, Seqs S, Lay lq, Lay lk,
                      float c2) {
  using C = FwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTS = BK / 8, NTO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BQ * LD;  // stage st: K at kv_s + 2 st BK LD, V after it
  T* p_s = kv_s + 4 * BK * LD;

  const int q0 = blockIdx.x * BQ;
  const size_t h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* kg = k + h * lk.hs;
  const T* vg = v + h * lk.hs;

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  int lo0, hi0, lo1, hi1;
  key_range(S, row0, lo0, hi0);
  key_range(S, row1, lo1, hi1);
  const WarpSpan w = warp_span(lo0, hi0, lo1, hi1);
  if (lane == 0) {
    s_lo[warp] = w.lo;
    s_hi[warp] = w.hi;
  }
  load_rows<T, D, BQ, LD>(q_s, q + h * lq.hs, q0, S.tq, lq.rs);
  __syncthreads();
  int clo, chi;
  cta_span(s_lo, s_hi, clo, chi);
  const int j0 = chi > clo ? clo / BK : 0;
  const int nj = chi > clo ? (chi - 1) / BK - j0 + 1 : 0;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const T* qw = q_s + warp * 16 * LD;
  T* pw = p_s + warp * 16 * LDP;

  if (nj > 0) {
    load_rows<T, D, BK, LD>(kv_s, kg, j0 * BK, S.tk, lk.rs);
    load_rows<T, D, BK, LD>(kv_s + BK * LD, vg, j0 * BK, S.tk, lk.rs);
  }
  cp_commit();
  for (int jj = 0; jj < nj; ++jj) {
    const int c0 = (j0 + jj) * BK;
    cp_wait<0>();
    // tile jj has landed for every thread, and every warp is done with
    // tile jj - 1, whose stage the next copy refills
    __syncthreads();
    if (jj + 1 < nj) {
      T* nxt = kv_s + ((jj + 1) & 1) * 2 * BK * LD;
      load_rows<T, D, BK, LD>(nxt, kg, c0 + BK, S.tk, lk.rs);
      load_rows<T, D, BK, LD>(nxt + BK * LD, vg, c0 + BK, S.tk, lk.rs);
      cp_commit();
    }
    // no live key of this warp's rows here: an exact no-op, skipped
    if (c0 >= w.hi || c0 + BK <= w.lo) continue;
    const T* k_s = kv_s + (jj & 1) * 2 * BK * LD;
    const T* v_s = k_s + BK * LD;

    float s[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_mm<NTS, true, true>(s, qw, LD, k_s, LD, D);  // S = Q K^T

    // only a tile that crosses an end of one of the warp's intervals is masked
    const bool masked = !(c0 >= w.lo_max && c0 + BK <= w.hi_min);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const bool live = e < 2 ? (col >= lo0 && col < hi0) : (col >= lo1 && col < hi1);
        s[n][e] = masked && !live ? -INFINITY : s[n][e] * c2;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no live key yet keeps m = -inf; base 0 keeps exp2 finite
    const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - b0), al1 = exp2f(m1 - b1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      const float p0 = exp2f(s[n][0] - b0), p1 = exp2f(s[n][1] - b0);
      const float p2 = exp2f(s[n][2] - b1), p3 = exp2f(s[n][3] - b1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      st_pair(pw + g * LDP + n * 8 + 2 * t, p0, p1);
      st_pair(pw + (g + 8) * LDP + n * 8 + 2 * t, p2, p3);
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
#pragma unroll
    for (int n = 0; n < NTO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    m0 = mn0;
    m1 = mn1;
    __syncwarp();  // P of this warp's rows is in p_s
    warp_mm<NTO, true, false>(acc, pw, LDP, v_s, LD, BK);  // acc += round(P) V
  }
  cp_wait<0>();  // no copy outlives the CTA

  // a row with no live key (l = 0) gets o = 0 and lse = 0
  const float d0 = l0 > 0.f ? 1.f / l0 : 0.f, d1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* og = o + h * lq.hs;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S.tq) st_pair(og + row0 * lq.rs + col, acc[n][0] * d0, acc[n][1] * d0);
    if (row1 < S.tq) st_pair(og + row1 * lq.rs + col, acc[n][2] * d1, acc[n][3] * d1);
  }
  if (t == 0) {
    float* lg = lse + h * S.tq;
    if (row0 < S.tq) lg[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : 0.f;
    if (row1 < S.tq) lg[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// fused backward (WITH_DQ) and split dK/dV (!WITH_DQ)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct BwdCfg {
  static constexpr int BK = 64, BQ = D == 128 ? 32 : 64;  // BQ bounds registers
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD, LDP = BQ + PAD;
  // K and V tiles, two stages of (Q tile, dO tile), dS^T, lse and delta
  static constexpr size_t kSmem =
      sizeof(T) * ((size_t)2 * BK * LD + 4 * BQ * LD + BK * LDP) + sizeof(float) * 2 * BQ;
};

// dq_acc (WITH_DQ) has dq's layout in f32 and must be zero on entry.
template <typename T, int D, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq_acc,
                      T* __restrict__ dk, T* __restrict__ dv, Seqs S, Lay lq, Lay lk, float c2,
                      float scale) {
  using C = BwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTQ = BQ / 8, NTO = D / 8;
  // dQ tile [BQ, D] split over the warps: MT m-tiles of 16 rows, each
  // m-tile's D / 8 n-tiles shared by WPM warps
  constexpr int MT = BQ / 16, WPM = kWarps / MT, NTW = NTO / WPM;
  static_assert(kWarps % MT == 0 && NTO % WPM == 0, "dQ split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BK * LD;
  T* qd_s = v_s + BK * LD;  // stage st: Q at qd_s + 2 st BQ LD, dO after it
  T* ds_s = qd_s + 4 * BQ * LD;  // P^T, then dS^T: [BK keys][BQ q rows]
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * LDP);
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const size_t h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* qg = q + h * lq.hs;
  const T* dog = dout + h * lq.hs;
  const float* lseg = lse + h * S.tq;
  const float* dlg = delta + h * S.tq;

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  int lo0, hi0, lo1, hi1;
  query_range(S, key0, lo0, hi0);
  query_range(S, key1, lo1, hi1);
  const WarpSpan w = warp_span(lo0, hi0, lo1, hi1);
  if (lane == 0) {
    s_lo[warp] = w.lo;
    s_hi[warp] = w.hi;
  }
  load_rows<T, D, BK, LD>(k_s, k + h * lk.hs, k0, S.tk, lk.rs);
  load_rows<T, D, BK, LD>(v_s, v + h * lk.hs, k0, S.tk, lk.rs);
  __syncthreads();
  int clo, chi;
  cta_span(s_lo, s_hi, clo, chi);
  const int i0 = chi > clo ? clo / BQ : 0;
  const int ni = chi > clo ? (chi - 1) / BQ - i0 + 1 : 0;

  float dkc[NTO][4], dvc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkc[n][e] = dvc[n][e] = 0.f;
  const T* kw = k_s + warp * 16 * LD;
  const T* vw = v_s + warp * 16 * LD;
  T* dsw = ds_s + warp * 16 * LDP;
  const int mt = warp % MT, nt0 = (warp / MT) * NTW;

  // two-stage pipeline: q tile i + 1 is in flight while tile i is used
  if (ni > 0) {
    load_rows<T, D, BQ, LD>(qd_s, qg, i0 * BQ, S.tq, lq.rs);
    load_rows<T, D, BQ, LD>(qd_s + BQ * LD, dog, i0 * BQ, S.tq, lq.rs);
  }
  cp_commit();
  for (int ii = 0; ii < ni; ++ii) {
    const int r0 = (i0 + ii) * BQ;
    cp_wait<0>();
    // every warp has passed the previous tile's mid-tile barrier, so its
    // lse/delta and its q stage are free
    for (int x = threadIdx.x; x < BQ; x += kThreads) {
      const bool live = r0 + x < S.tq;
      lse_s[x] = live ? lseg[r0 + x] * kLog2e : 0.f;
      dl_s[x] = live ? dlg[r0 + x] : 0.f;
    }
    __syncthreads();  // q tile, lse and delta are in place for every thread
    if (ii + 1 < ni) {
      T* nxt = qd_s + ((ii + 1) & 1) * 2 * BQ * LD;
      load_rows<T, D, BQ, LD>(nxt, qg, r0 + BQ, S.tq, lq.rs);
      load_rows<T, D, BQ, LD>(nxt + BQ * LD, dog, r0 + BQ, S.tq, lq.rs);
      cp_commit();
    }
    const T* q_s = qd_s + (ii & 1) * 2 * BQ * LD;
    const T* do_s = q_s + BQ * LD;

    if (r0 < w.hi && r0 + BQ > w.lo) {  // a live pair of this warp's keys
      // P^T = exp2(K Q^T c2 - lse2), 0 where masked
      float s[NTQ][4];
#pragma unroll
      for (int n = 0; n < NTQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      warp_mm<NTQ, true, true>(s, kw, LD, q_s, LD, D);
      const bool masked = !(r0 >= w.lo_max && r0 + BQ <= w.hi_min);
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1), qrow = r0 + ql;
          const bool live = e < 2 ? (qrow >= lo0 && qrow < hi0) : (qrow >= lo1 && qrow < hi1);
          s[n][e] = masked && !live ? 0.f : exp2f(s[n][e] * c2 - lse_s[ql]);
        }
        st_pair(dsw + g * LDP + n * 8 + 2 * t, s[n][0], s[n][1]);
        st_pair(dsw + (g + 8) * LDP + n * 8 + 2 * t, s[n][2], s[n][3]);
      }
      __syncwarp();
      warp_mm<NTO, true, false>(dvc, dsw, LDP, do_s, LD, BQ);  // dV += round(P^T) dO

      float dp[NTQ][4];
#pragma unroll
      for (int n = 0; n < NTQ; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      warp_mm<NTQ, true, true>(dp, vw, LD, do_s, LD, D);  // dP^T = V dO^T
      __syncwarp();  // every lane has read P^T
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        const int ql = n * 8 + 2 * t;
        st_pair(dsw + g * LDP + ql, s[n][0] * (dp[n][0] - dl_s[ql]) * scale,
                s[n][1] * (dp[n][1] - dl_s[ql + 1]) * scale);
        st_pair(dsw + (g + 8) * LDP + ql, s[n][2] * (dp[n][2] - dl_s[ql]) * scale,
                s[n][3] * (dp[n][3] - dl_s[ql + 1]) * scale);
      }
      __syncwarp();
      warp_mm<NTO, true, false>(dkc, dsw, LDP, q_s, LD, BQ);  // dK += round(dS^T) Q
    } else if (WITH_DQ) {
      // the dQ product reads every warp's dS^T rows: this warp's are zero
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        st_pair(dsw + g * LDP + n * 8 + 2 * t, 0.f, 0.f);
        st_pair(dsw + (g + 8) * LDP + n * 8 + 2 * t, 0.f, 0.f);
      }
    }
    __syncthreads();  // every warp's dS^T rows are in ds_s (and lse/delta are free)

    if (WITH_DQ) {
      // dQ tile += dS K over this CTA's 64 keys, summed across CTAs by atomics
      float dqc[NTW][4];
#pragma unroll
      for (int n = 0; n < NTW; ++n) dqc[n][0] = dqc[n][1] = dqc[n][2] = dqc[n][3] = 0.f;
      warp_mm<NTW, false, false>(dqc, ds_s + mt * 16, LDP, k_s + nt0 * 8, LD, BK);
      const int qa = r0 + mt * 16 + g, qb = qa + 8;
      float* dqg = dq_acc + h * lq.hs;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int col = (nt0 + n) * 8 + 2 * t;
        // float2 atomics (compute capability 9.x); a zero pair sends none
        if (qa < S.tq && (dqc[n][0] != 0.f || dqc[n][1] != 0.f))
          atomicAdd(reinterpret_cast<float2*>(dqg + qa * lq.rs + col),
                    make_float2(dqc[n][0], dqc[n][1]));
        if (qb < S.tq && (dqc[n][2] != 0.f || dqc[n][3] != 0.f))
          atomicAdd(reinterpret_cast<float2*>(dqg + qb * lq.rs + col),
                    make_float2(dqc[n][2], dqc[n][3]));
      }
    }
  }

  cp_wait<0>();  // no copy outlives the CTA
  T* dkg = dk + h * lk.hs;
  T* dvg = dv + h * lk.hs;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < S.tk) {
      st_pair(dkg + key0 * lk.rs + col, dkc[n][0], dkc[n][1]);
      st_pair(dvg + key0 * lk.rs + col, dvc[n][0], dvc[n][1]);
    }
    if (key1 < S.tk) {
      st_pair(dkg + key1 * lk.rs + col, dkc[n][2], dkc[n][3]);
      st_pair(dvg + key1 * lk.rs + col, dvc[n][2], dvc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// split dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD, LDP = BK + PAD;
  // Q and dO tiles, two stages of (K tile, V tile), dS
  static constexpr size_t kSmem = sizeof(T) * ((size_t)2 * BQ * LD + 4 * BK * LD + BQ * LDP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    varlen_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, Seqs S, Lay lq, Lay lk,
                     float c2, float scale) {
  using C = DqCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTS = BK / 8, NTO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * LD;
  T* kv_s = do_s + BQ * LD;  // stage st: K at kv_s + 2 st BK LD, V after it
  T* ds_s = kv_s + 4 * BK * LD;

  const int q0 = blockIdx.x * BQ;
  const size_t h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* kg = k + h * lk.hs;
  const T* vg = v + h * lk.hs;

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  int lo0, hi0, lo1, hi1;
  key_range(S, row0, lo0, hi0);
  key_range(S, row1, lo1, hi1);
  const WarpSpan w = warp_span(lo0, hi0, lo1, hi1);
  if (lane == 0) {
    s_lo[warp] = w.lo;
    s_hi[warp] = w.hi;
  }
  const float lse0 = row0 < S.tq ? lse[h * S.tq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < S.tq ? lse[h * S.tq + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S.tq ? delta[h * S.tq + row0] : 0.f;
  const float dl1 = row1 < S.tq ? delta[h * S.tq + row1] : 0.f;
  load_rows<T, D, BQ, LD>(q_s, q + h * lq.hs, q0, S.tq, lq.rs);
  load_rows<T, D, BQ, LD>(do_s, dout + h * lq.hs, q0, S.tq, lq.rs);
  __syncthreads();
  int clo, chi;
  cta_span(s_lo, s_hi, clo, chi);
  const int j0 = chi > clo ? clo / BK : 0;
  const int nj = chi > clo ? (chi - 1) / BK - j0 + 1 : 0;

  float dqc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) dqc[j][0] = dqc[j][1] = dqc[j][2] = dqc[j][3] = 0.f;
  const T* qw = q_s + warp * 16 * LD;
  const T* dow = do_s + warp * 16 * LD;
  T* dsw = ds_s + warp * 16 * LDP;

  if (nj > 0) {
    load_rows<T, D, BK, LD>(kv_s, kg, j0 * BK, S.tk, lk.rs);
    load_rows<T, D, BK, LD>(kv_s + BK * LD, vg, j0 * BK, S.tk, lk.rs);
  }
  cp_commit();
  for (int jj = 0; jj < nj; ++jj) {
    const int c0 = (j0 + jj) * BK;
    cp_wait<0>();
    __syncthreads();
    if (jj + 1 < nj) {
      T* nxt = kv_s + ((jj + 1) & 1) * 2 * BK * LD;
      load_rows<T, D, BK, LD>(nxt, kg, c0 + BK, S.tk, lk.rs);
      load_rows<T, D, BK, LD>(nxt + BK * LD, vg, c0 + BK, S.tk, lk.rs);
      cp_commit();
    }
    if (c0 >= w.hi || c0 + BK <= w.lo) continue;  // dS is zero here
    const T* k_s = kv_s + (jj & 1) * 2 * BK * LD;
    const T* v_s = k_s + BK * LD;

    float s[NTS][4], dp[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_mm<NTS, true, true>(s, qw, LD, k_s, LD, D);    // S = Q K^T
    warp_mm<NTS, true, true>(dp, dow, LD, v_s, LD, D);  // dP = dO V^T
    const bool masked = !(c0 >= w.lo_max && c0 + BK <= w.hi_min);
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const bool live = e < 2 ? (col >= lo0 && col < hi0) : (col >= lo1 && col < hi1);
        const float p = masked && !live ? 0.f : exp2f(s[n][e] * c2 - (e < 2 ? lse0 : lse1));
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * scale;
      }
      st_pair(dsw + g * LDP + n * 8 + 2 * t, s[n][0], s[n][1]);
      st_pair(dsw + (g + 8) * LDP + n * 8 + 2 * t, s[n][2], s[n][3]);
    }
    __syncwarp();  // dS of this warp's rows is in ds_s
    warp_mm<NTO, true, false>(dqc, dsw, LDP, k_s, LD, BK);  // dQ += round(dS) K
  }
  cp_wait<0>();  // no copy outlives the CTA

  T* dqg = dq + h * lq.hs;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S.tq) st_pair(dqg + row0 * lq.rs + col, dqc[n][0], dqc[n][1]);
    if (row1 < S.tq) st_pair(dqg + row1 * lq.rs + col, dqc[n][2], dqc[n][3]);
  }
}

template <typename T>
__global__ void dq_cast_kernel(const float* __restrict__ acc, T* __restrict__ dq, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(acc[i]);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq_acc, *dq, *dk, *dv;
  Seqs S;
  int h, d, packed;
  float scale;
};

Lay lay(int packed, int h, int t, int d) {
  return packed ? Lay{(size_t)d, (size_t)h * d} : Lay{(size_t)t * d, (size_t)d};
}

template <typename T, int D>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  using C = FwdCfg<T, D>;
  cudaError_t e = allow_smem(varlen_fwd_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S.tq + C::BQ - 1) / C::BQ, a.h);
  if (grid.x == 0) return cudaSuccess;
  varlen_fwd_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.S,
      lay(a.packed, a.h, a.S.tq, D), lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D, bool WITH_DQ>
cudaError_t launch_bwd(const Args& a, cudaStream_t stream) {
  using C = BwdCfg<T, D>;
  cudaError_t e = allow_smem(varlen_bwd_kernel<T, D, WITH_DQ>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S.tk + C::BK - 1) / C::BK, a.h);
  if (grid.x > 0) {  // no keys: dQ stays the zeroed scratch
    varlen_bwd_kernel<T, D, WITH_DQ><<<grid, kThreads, C::kSmem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.dq_acc),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, lay(a.packed, a.h, a.S.tq, D),
        lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e, a.scale);
    e = cudaGetLastError();
  }
  const size_t n = (size_t)a.h * a.S.tq * D;
  if (e != cudaSuccess || !WITH_DQ || n == 0) return e;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  dq_cast_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(a.dq_acc),
                                                static_cast<T*>(a.dq), n);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using C = DqCfg<T, D>;
  cudaError_t e = allow_smem(varlen_dq_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S.tq + C::BQ - 1) / C::BQ, a.h);
  if (grid.x == 0) return cudaSuccess;
  varlen_dq_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.S,
      lay(a.packed, a.h, a.S.tq, D), lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e, a.scale);
  return cudaGetLastError();
}

// which: 0 forward, 1 fused backward, 2 split dK/dV, 3 split dQ
template <typename T, int D>
cudaError_t launch(int which, const Args& a, cudaStream_t s) {
  switch (which) {
    case 0: return launch_fwd<T, D>(a, s);
    case 1: return launch_bwd<T, D, true>(a, s);
    case 2: return launch_bwd<T, D, false>(a, s);
    default: return launch_dq<T, D>(a, s);
  }
}

int dispatch(int which, const Args& a, int dtype, void* stream) {
  if (a.h < 1 || a.h > 65535 || a.S.n_seq < 1 || a.S.tq < 0 || a.S.tk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && a.d == 64) return (int)launch<float, 64>(which, a, s);
  if (dtype == 0 && a.d == 128) return (int)launch<float, 128>(which, a, s);
  if (dtype == 1 && a.d == 64) return (int)launch<bf16, 64>(which, a, s);
  if (dtype == 1 && a.d == 128) return (int)launch<bf16, 128>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common contract: dtype 0 = float32, 1 = bfloat16 (every [H, T, D] operand
// shares it); d in {64, 128}; packed 1 = the [T, H, D] layout, 0 = [H, T, D],
// both contiguous; cu_q, cu_k int32 [n_seq + 1] on the device; lse and delta
// [h, tq] f32 contiguous; 16-byte aligned storage; 1 <= h <= 65535.

// q [tq], k and v [tk] -> o [tq], lse [h, tq] (natural log)
extern "C" int varlen_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                          const void* cu_q, const void* cu_k, int n_seq, int h, int tq, int tk,
                          int d, int packed, int causal, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse_out = lse;
  a.S = Seqs{static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), n_seq, tq, tk, causal};
  a.h = h, a.d = d, a.packed = packed, a.scale = scale;
  return dispatch(0, a, dtype, stream);
}

// dq_acc: f32 in dq's layout, zero on entry (the fused kernel sums into it)
extern "C" int varlen_bwd(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
                          void* dv, const void* cu_q, const void* cu_k, int n_seq, int h, int tq,
                          int tk, int d, int packed, int causal, float scale, int dtype,
                          void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.dq_acc = dq_acc, a.dq = dq, a.dk = dk, a.dv = dv;
  a.S = Seqs{static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), n_seq, tq, tk, causal};
  a.h = h, a.d = d, a.packed = packed, a.scale = scale;
  return dispatch(1, a, dtype, stream);
}

extern "C" int varlen_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv,
                              const void* cu_q, const void* cu_k, int n_seq, int h, int tq,
                              int tk, int d, int packed, int causal, float scale, int dtype,
                              void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.dk = dk, a.dv = dv;
  a.S = Seqs{static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), n_seq, tq, tk, causal};
  a.h = h, a.d = d, a.packed = packed, a.scale = scale;
  return dispatch(2, a, dtype, stream);
}

extern "C" int varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, const void* cu_q,
                             const void* cu_k, int n_seq, int h, int tq, int tk, int d,
                             int packed, int causal, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta, a.dq = dq;
  a.S = Seqs{static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), n_seq, tq, tk, causal};
  a.h = h, a.d = d, a.packed = packed, a.scale = scale;
  return dispatch(3, a, dtype, stream);
}

extern "C" const char* flash_varlen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
