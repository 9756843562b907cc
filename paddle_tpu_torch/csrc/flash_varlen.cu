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
// Every kernel, in both designs below, keeps these rules (from the TPU's
// _live_col_tiles with the causal diagonal clamp of _fwd_bounds /
// _bwd_bounds, at this card's tiles):
// - No schedule arrays and no host sync: each thread finds the segment of
//   its own rows (or keys) by binary search of cu in device memory and keeps
//   the row's live key interval [lo, hi) (or the key's live query interval)
//   in registers. A CTA walks the union of its rows' intervals (warp and
//   block min/max). A warp (a warpgroup on wgmma) skips a tile that holds no
//   live pair of its rows (an exact no-op of the online softmax), and a warp
//   masks only where a tile crosses one of its rows' interval ends.
// - Masking to -inf with a guarded rescale: a running max still at -inf uses
//   0 as its base, so exp2(-inf - base) = 0 and no NaN arises where a q tile
//   spans segments and a row sees k tiles that are wholly masked for it. The
//   backward masks P to 0 itself (it does not rely on lse, which is 0 for a
//   dead row).
// - The forward rounds P to the input dtype before P.V per 64-key tile
//   aligned to a multiple of 64 (the plain version's BLOCK_K walk), the
//   normaliser summing the unrounded P. The backward rounds P for dV and
//   dS = P (dP - delta) scale for dK and dQ.
//
// f32: mma.sync m16n8k16 warp tiles from csrc/mma_common.cuh, 16-byte
// cp.async in a two-stage pipeline, one barrier per tile.
// - Forward: one CTA of 4 warps per (64-row q tile, head), 64-key tiles.
// - Fused backward: one CTA per (64-key tile, head) over its live q tiles
//   (32 rows at D = 128, 64 at D = 64); dK and dV in f32 registers; dQ +=
//   dS K summed across CTAs by f32 atomicAdd into a zeroed scratch (pairs
//   that are exactly zero, such as rows with no live key, send no atomic),
//   then a cast pass. The summation order of dQ varies from run to run.
// - Split backward: varlen_bwd_dkv is the fused CTA without dQ;
//   varlen_bwd_dq is one CTA per (64-row q tile, head) over its live k
//   tiles, recomputing S and dP (7 products across the pair), dQ in
//   registers, no atomics: the same bits every run.
//
// bf16, designed for Hopper on wgmma (the dense kernels' tools:
// csrc/wgmma_common.cuh's 128-byte swizzled tiles, wgmma from shared memory
// and from registers, TMA through 3-D maps over [H, T, D] with each
// operand's own strides, so one map form serves both layouts and a box
// past T reads zeros; mbarrier rings; setmaxnreg). The same function,
// rounding points and contract. Every sum over q tiles or key stages takes
// each step's product in a zeroed accumulator and adds it to f32 registers
// with IEEE adds: the tensor cores round their own f32 sums toward zero,
// and a sum carried in them along a 65,536-token segment drifts 1e-4 low
// (tools/varlen_mutants.py). Every CTA has two consumer warpgroups of 64
// rows and a producer warpgroup that gives its registers to them
// (setmaxnreg 24 against 240) and fills a ring by TMA; stages are handed
// over by full/empty mbarriers. Timed against the forms they beat by
// tools/varlen_choices.py.
// - Forward (varlen_fwd_wg_kernel, the dense flash_fwd_wg_kernel's design):
//   a CTA of 128 q rows with Q loaded once, 128-key K/V stages in a ring of
//   128 KB. Per stage a consumer computes S = Q K^T (m64n128k16), then per
//   64-key half masks, runs the online softmax (c2 = scale log2 e on the
//   f32 score), puts P from the S accumulator straight into A fragments and
//   adds P V (m64nDk16, V read MN-major) to the rescaled o. o is staged in
//   the warpgroup's own rows of the Q tile and stored in 16-byte pieces.
//   The last q tile is launched first.
// - dK/dV (varlen_bwd_wg_kernel, the dense flash_bwd_wg_kernel's products):
//   a CTA owns 128 keys, K and V loaded once; 64-row Q and dO stages in a
//   four-stage ring, whose lse (in the log2 domain) and delta the
//   producer's 128 threads copy beside them. S^T = K Q^T and dP^T = V dO^T
//   are m64n64k16 from shared memory; dV and dK take P^T and dS^T straight
//   from those accumulators as register A fragments, one m64nDk16 product
//   each over all D columns (Q and dO read MN-major from the stage). The
//   output is staged in the warpgroup's own rows of the K and V tiles and
//   stored in 16-byte pieces. No atomics: the same bits every run.
// - Fused backward: the same kernel with its DQ flag on, so its dK and dV
//   have the bits of the split dK/dV on the same inputs. dS^T goes through
//   shared memory and each CTA's dS K is added to a zeroed f32 scratch by
//   float2 atomics (a zero pair sends none), then a cast pass: the
//   summation order of dQ varies from run to run.
// - dQ (varlen_dq_wg_kernel, the forward's design with dP and dQ in place
//   of P V): a CTA of 128 q rows with Q and dO loaded once, 128-key K/V
//   stages in a two-stage ring. Per stage a consumer computes S = Q K^T and
//   dP = dO V^T (m64n128k16), forms dS = round(P (dP - delta) scale)
//   straight into A fragments, and adds dS K (m64nDk16, K read MN-major).
//   dQ is staged in the warpgroup's own rows of the Q tile and stored in
//   16-byte pieces. The last q tile is launched first.
// At the long pack (16 x 4,096 tokens, 32 heads x 128, causal) the forward
// does 2 products of 2 D operations per live pair (2.2e12, 2.22 ms at 989
// TFLOP/s), the dK/dV pass 4 (4.45 ms), the dQ pass 3 (3.34 ms).
//
// Types f32 and bf16, head_dim 64 and 128. The kernels allocate nothing and
// do not synchronise; they launch on the caller's stream.
#include <math.h>
#include <limits.h>

#include <type_traits>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

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

// The union [lo, hi) of warps w0 .. w0 + n - 1 from their s_lo, s_hi
// entries (after the barrier that follows the writes)
__device__ __forceinline__ void span_of(const int* s_lo, const int* s_hi, int w0, int n, int& lo,
                                        int& hi) {
  lo = s_lo[w0];
  hi = s_hi[w0];
#pragma unroll
  for (int w = w0 + 1; w < w0 + n; ++w) {
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
  span_of(s_lo, s_hi, 0, kWarps, clo, chi);
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
  span_of(s_lo, s_hi, 0, kWarps, clo, chi);
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
  span_of(s_lo, s_hi, 0, kWarps, clo, chi);
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

// ---------------------------------------------------------------------------
// dK/dV for bf16 on wgmma: the split dK/dV (row 22), and with DQ the fused
// backward (row 21)
// ---------------------------------------------------------------------------

template <int D>
struct WgBwdCfg {
  static constexpr int BK = 128, BQ = 64, NS = 4;  // keys a CTA, q rows a step, ring stages
  static constexpr int NB = D / 64;                 // 64-column blocks of D
  static constexpr int KV_BYTES = BK * D * 2;       // K or V, resident
  static constexpr int QT_BYTES = BQ * D * 2;       // Q or dO of one stage
  static constexpr int DS_BYTES = BK * BQ * 2;      // dS^T [keys][q rows] (DQ)
  static constexpr int OFF_V = KV_BYTES, OFF_RING = 2 * KV_BYTES;  // stage st: Q, then dO
  static constexpr int OFF_DS = OFF_RING + NS * 2 * QT_BYTES, OFF_STAT = OFF_DS + DS_BYTES;
  static constexpr int OFF_BAR = OFF_STAT + NS * 2 * BQ * 4;  // stage st: lse, then delta
  // barriers (K and V landed, NS stages full, NS stages empty), and slack
  // to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
  static_assert(kSmem <= 232448, "WgBwdCfg: more shared memory than a CTA has");
};

// qm, dom, km, vm: tensor maps of q, dout [H, Tq, D] and k, v [H, Tk, D]
// (bf16, each with its own strides) with boxes of 64 columns by 64 (q,
// dout) or 128 (k, v) rows; lse (natural log), delta [H, Tq] f32; dk, dv
// in k's layout lk, written whole. DQ: dq_acc f32 in q's layout lq, zero
// on entry, gets dQ by float2 atomics. 384 threads, grid (ceil(Tk / 128),
// H).
template <int D, bool DQ>
__global__ void __launch_bounds__(384, 1)
    varlen_bwd_wg_kernel(const __grid_constant__ CUtensorMap qm,
                         const __grid_constant__ CUtensorMap dom,
                         const __grid_constant__ CUtensorMap km,
                         const __grid_constant__ CUtensorMap vm, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq_acc,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Seqs S, Lay lq, Lay lk,
                         float c2, float scale) {
  using C = WgBwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lo[8], s_hi[8];
  unsigned char* sm = align1024(smem_raw);
  float* stat = reinterpret_cast<float*>(sm + C::OFF_STAT);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;
  const uint32_t ka = smem_u32(sm), va = ka + C::OFF_V;
  [[maybe_unused]] const uint32_t dsa = ka + C::OFF_DS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, wiw = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;  // low keys of a segment have the most live q tiles
  const int h = blockIdx.y;

  // consumer warpgroup wg owns keys k0 + 64 wg ..; this warp 16 of them,
  // this lane key0 and key1 with their live query intervals
  const int krow = 64 * wg + 16 * wiw + g;  // key0's row of the CTA's tile
  const int key0 = k0 + krow, key1 = key0 + 8;
  int lo0 = INT_MAX, hi0 = 0, lo1 = INT_MAX, hi1 = 0;
  WarpSpan w{INT_MAX, 0, INT_MAX, 0};
  if (wg < 2) {
    query_range(S, key0, lo0, hi0);
    query_range(S, key1, lo1, hi1);
    w = warp_span(lo0, hi0, lo1, hi1);
    if (lane == 0) {
      s_lo[warp] = w.lo;
      s_hi[warp] = w.hi;
    }
  }
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 128);  // every producer thread writes its lse or delta
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the CTA walks the union of its keys' live q tiles; a warpgroup skips
  // a tile that none of its keys sees
  int clo, chi, glo[2], ghi[2];
  span_of(s_lo, s_hi, 0, 8, clo, chi);
  span_of(s_lo, s_hi, 0, 4, glo[0], ghi[0]);
  span_of(s_lo, s_hi, 4, 4, glo[1], ghi[1]);
  const int i0 = chi > clo ? clo / BQ : 0;
  const int ni = chi > clo ? (chi - 1) / BQ - i0 + 1 : 0;

  if (wg == 2) {  // the producer warpgroup
    setmaxnreg_dec<24>();
    // thread 0 loads K and V once and each stage's Q and dO by TMA; every
    // thread copies one of the stage's 64 lse and 64 delta values (then
    // arrives on the stage's full barrier)
    const int pt = tid - 256;
    const float* src = (pt < BQ ? lse : delta) + (size_t)h * S.tq;
    if (pt == 0 && ni > 0) {
      mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm + b * (BK * 128), &km, kvbar, 64 * b, k0, h);
        tma_load_3d(sm + C::OFF_V + b * (BK * 128), &vm, kvbar, 64 * b, k0, h);
      }
    }
    for (int ii = 0; ii < ni; ++ii) {
      const int st = ii % NS, r0 = (i0 + ii) * BQ, r = r0 + (pt & (BQ - 1));
      if (ii >= NS) mbar_wait(&empty[st], ((ii / NS) & 1) ^ 1);
      // lse in the log2 domain
      stat[st * 2 * BQ + pt] = r < S.tq ? (pt < BQ ? src[r] * kLog2e : src[r]) : 0.f;
      if (pt == 0) {
        unsigned char* qs = sm + C::OFF_RING + st * 2 * C::QT_BYTES;
        mbar_expect_tx(&full[st], 2 * C::QT_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(qs + b * (BQ * 128), &qm, &full[st], 64 * b, r0, h);
          tma_load_3d(qs + C::QT_BYTES + b * (BQ * 128), &dom, &full[st], 64 * b, r0, h);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  float dkc[D / 2], dvc[D / 2];  // m64nD accumulator layout
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dkc[e] = dvc[e] = 0.f;

  if (ni > 0) mbar_wait(kvbar, 0);
  for (int ii = 0; ii < ni; ++ii) {
    const int st = ii % NS, r0 = (i0 + ii) * BQ;
    mbar_wait(&full[st], (ii / NS) & 1);
    const bool on0 = r0 < ghi[0] && r0 + BQ > glo[0], on1 = r0 < ghi[1] && r0 + BQ > glo[1];
    const bool on = wg ? on1 : on0;
    const uint32_t qa = smem_u32(sm + C::OFF_RING + st * 2 * C::QT_BYTES), doa = qa + C::QT_BYTES;

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
    float s[32], dp[32];
    if (on) {
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
    }
    [[maybe_unused]] uint32_t dsf[16];
    if (on) {
      const float* lse_s = stat + st * 2 * BQ;  // in the log2 domain
      const float* dl_s = lse_s + BQ;
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
          pe[e] = masked && !live ? 0.f : exp2f(s[4 * j + e] * c2 - lse_s[ql]);
          de[e] = pe[e] * (dp[4 * j + e] - dl_s[ql]) * scale;
        }
        pf[2 * j] = pack_bf16(pe[0], pe[1]);
        pf[2 * j + 1] = pack_bf16(pe[2], pe[3]);
        dsf[2 * j] = pack_bf16(de[0], de[1]);
        dsf[2 * j + 1] = pack_bf16(de[2], de[3]);
      }

      // dV += round(P^T) dO and dK += round(dS^T) Q over all D columns at
      // once (m64nDk16, dO and Q read MN-major from the stage): each q
      // tile's product in a zeroed accumulator, added to the running f32
      // sums with IEEE adds (the tensor cores' own f32 sums round toward
      // zero, and a sum carried in them over a long segment drifts)
      float pr[D / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1, D>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                       sw128_desc(doa + kk * 2048, BQ * 128, 1024), kk);
      wg_commit();
      wg_wait<0>();
      reg_fence(pr);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dvc[e] += pr[e];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1, D>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                       sw128_desc(qa + kk * 2048, BQ * 128, 1024), kk);
      wg_commit();
      wg_wait<0>();
      reg_fence(pr);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dkc[e] += pr[e];
    }

    if constexpr (DQ) {
      // dQ tile += dS K over this CTA's keys, from dS^T in shared memory
      // (MN-major A) and K (MN-major B), summed across CTAs by float2
      // atomics (a zero pair sends none). D = 128: warpgroup wg takes
      // columns 64 wg.. over all 128 keys (a warpgroup that skipped the
      // tile writes zero rows; named barrier 3 joins both); D = 64: all
      // columns over its own keys.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow, 8 * j + 2 * t)) =
            on ? dsf[2 * j] : 0u;
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow + 8, 8 * j + 2 * t)) =
            on ? dsf[2 * j + 1] : 0u;
      }
      fence_async_smem();
      if constexpr (D == 128)
        bar_sync(3, 256);
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
        float* dqg = dq_acc + (size_t)h * lq.hs;
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
      if constexpr (D == 128) bar_sync(4, 256);  // both are done with dS^T
    }
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  // dK and dV rounded to bf16 and staged in this warpgroup's own rows of
  // the K and V tiles (free once its last product is done; DQ: once both
  // warpgroups' dQ products have read K), then stored in 16-byte pieces
  if constexpr (DQ)
    bar_sync(3, 256);
  else
    wg_bar(1 + wg);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BK>(krow, col)) =
        pack_bf16(dkc[4 * j], dkc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BK>(krow + 8, col)) =
        pack_bf16(dkc[4 * j + 2], dkc[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(sm + C::OFF_V + sw128_offset<BK>(krow, col)) =
        pack_bf16(dvc[4 * j], dvc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(sm + C::OFF_V + sw128_offset<BK>(krow + 8, col)) =
        pack_bf16(dvc[4 * j + 2], dvc[4 * j + 3]);
  }
  wg_bar(1 + wg);
  constexpr int CPR = D / 8;  // 16-byte pieces a row
  for (int i = tid & 127; i < 2 * 64 * CPR; i += 128) {
    const int v_side = i >= 64 * CPR, x = i % (64 * CPR);
    const int rr = 64 * wg + x / CPR, c = 8 * (x % CPR), key = k0 + rr;
    if (key < S.tk)
      *reinterpret_cast<uint4*>((v_side ? dv : dk) + (size_t)h * lk.hs + key * lk.rs + c) =
          *reinterpret_cast<const uint4*>(sm + (v_side ? C::OFF_V : 0) + sw128_offset<BK>(rr, c));
  }
}

// ---------------------------------------------------------------------------
// split dQ for bf16 on wgmma (row 23)
// ---------------------------------------------------------------------------

template <int D>
struct WgDqCfg {
  static constexpr int BQ = 128, BK = 128;        // q rows a CTA, keys a stage
  static constexpr int NB = D / 64;               // 64-column blocks of D
  static constexpr int QT_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int NS = 131072 / (2 * KV_BYTES);  // ring stages: 128 KB of K and V
  static constexpr int OFF_DO = QT_BYTES, OFF_KV = 2 * QT_BYTES;  // stage st: K, then V
  static constexpr int OFF_BAR = OFF_KV + NS * 2 * KV_BYTES;
  // barriers (Q and dO landed, NS stages full, NS stages empty), and slack
  // to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
};

// qm, dom, km, vm: tensor maps of q, dout [H, Tq, D] and k, v [H, Tk, D]
// (bf16, each with its own strides) with boxes of 64 columns by BQ (q,
// dout) or BK (k, v) rows; lse (natural log), delta [H, Tq] f32; dq in
// q's layout lq, written whole. 384 threads, grid (ceil(Tq / 128), H).
template <int D>
__global__ void __launch_bounds__(384, 1)
    varlen_dq_wg_kernel(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap dom,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, Seqs S, Lay lq,
                        float c2, float scale) {
  using C = WgDqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lo[8], s_hi[8];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, wiw = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the last q tile first
  const int h = blockIdx.y;

  // consumer warpgroup wg owns q rows q0 + 64 wg ..; this warp 16 of them,
  // this lane row0 and row1 with their live key intervals
  const int rloc = 64 * wg + 16 * wiw + g;  // row0's row of the CTA's tile
  const int row0 = q0 + rloc, row1 = row0 + 8;
  int lo0 = INT_MAX, hi0 = 0, lo1 = INT_MAX, hi1 = 0;
  WarpSpan w{INT_MAX, 0, INT_MAX, 0};
  if (wg < 2) {
    key_range(S, row0, lo0, hi0);
    key_range(S, row1, lo1, hi1);
    w = warp_span(lo0, hi0, lo1, hi1);
    if (lane == 0) {
      s_lo[warp] = w.lo;
      s_hi[warp] = w.hi;
    }
  }
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the CTA loads the union of its rows' live key stages; a warpgroup
  // skips a stage that none of its rows sees
  int clo, chi, glo, ghi;
  span_of(s_lo, s_hi, 0, 8, clo, chi);
  span_of(s_lo, s_hi, 4 * (wg & 1), 4, glo, ghi);
  const int j0 = chi > clo ? clo / BK : 0;
  const int nj = chi > clo ? (chi - 1) / BK - j0 + 1 : 0;

  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == 256 && nj > 0) {
      mbar_expect_tx(qbar, 2 * C::QT_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm + b * (BQ * 128), &qm, qbar, 64 * b, q0, h);
        tma_load_3d(sm + C::OFF_DO + b * (BQ * 128), &dom, qbar, 64 * b, q0, h);
      }
      for (int jj = 0; jj < nj; ++jj) {
        const int st = jj % NS;
        if (jj >= NS) mbar_wait(&empty[st], ((jj / NS) & 1) ^ 1);
        unsigned char* ks = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(ks + b * (BK * 128), &km, &full[st], 64 * b, (j0 + jj) * BK, h);
          tma_load_3d(ks + C::KV_BYTES + b * (BK * 128), &vm, &full[st], 64 * b,
                      (j0 + jj) * BK, h);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // lse in the log2 domain and delta of this lane's rows (0 past Tq, where
  // q and dO read zeros and no key is live)
  const float lse0 = row0 < S.tq ? lse[(size_t)h * S.tq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < S.tq ? lse[(size_t)h * S.tq + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S.tq ? delta[(size_t)h * S.tq + row0] : 0.f;
  const float dl1 = row1 < S.tq ? delta[(size_t)h * S.tq + row1] : 0.f;
  const uint32_t qa = smem_u32(sm) + wg * 64 * 128, doa = qa + C::OFF_DO;
  float acc[D / 2];  // m64nD accumulator layout
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  if (nj > 0) mbar_wait(qbar, 0);
  for (int jj = 0; jj < nj; ++jj) {
    const int st = jj % NS, c0 = (j0 + jj) * BK;
    mbar_wait(&full[st], (jj / NS) & 1);
    // a stage that no row of this warpgroup sees adds nothing: skipped (a
    // warpgroup-uniform branch)
    if (c0 < ghi && c0 + BK > glo) {
      const uint32_t ka = smem_u32(sm + C::OFF_KV + st * 2 * C::KV_BYTES), va = ka + C::KV_BYTES;

      // S = Q K^T and dP = dO V^T over the stage's keys
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

      // P = exp2(S c2 - lse2), 0 outside each row's live key interval;
      // dS = P (dP - delta) scale rounded to bf16, straight into the A
      // fragments of dS K. Only a stage that crosses an end of one of the
      // warp's intervals is masked (a warp-uniform branch).
      const bool masked = !(c0 >= w.lo_max && c0 + BK <= w.hi_min);
      uint32_t dsf[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const bool live = e < 2 ? (col >= lo0 && col < hi0) : (col >= lo1 && col < hi1);
          const float p = masked && !live ? 0.f : exp2f(s[4 * j + e] * c2 - (e < 2 ? lse0 : lse1));
          de[e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1)) * scale;
        }
        dsf[2 * j] = pack_bf16(de[0], de[1]);
        dsf[2 * j + 1] = pack_bf16(de[2], de[3]);
      }

      // dQ += dS K over all D columns at once (m64nDk16, K read MN-major
      // from the stage): the stage's product in a zeroed accumulator,
      // added to the running dQ with IEEE adds
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
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  // dQ rounded to bf16 and staged in this warpgroup's own rows of the Q
  // tile (free once its last product is done; the swizzle keeps the pair
  // writes free of bank conflicts), then stored in 16-byte pieces
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
    const int rr = 64 * wg + i / (D / 8), c = 8 * (i % (D / 8)), row = q0 + rr;
    if (row < S.tq)
      *reinterpret_cast<uint4*>(dqg + row * lq.rs + c) =
          *reinterpret_cast<const uint4*>(sm + sw128_offset<BQ>(rr, c));
  }
}

// ---------------------------------------------------------------------------
// forward for bf16 on wgmma (row 20)
// ---------------------------------------------------------------------------

template <int D>
struct WgFwdCfg {
  static constexpr int BQ = 128, BK = 128;  // q rows a CTA, keys a stage (64-key halves)
  static constexpr int NB = D / 64;               // 64-column blocks of D
  static constexpr int QT_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int NS = 131072 / (2 * KV_BYTES);  // ring stages: 128 KB of K and V
  static constexpr int OFF_KV = QT_BYTES;             // stage st: K, then V
  static constexpr int OFF_BAR = OFF_KV + NS * 2 * KV_BYTES;
  // barriers (Q landed, NS stages full, NS stages empty), and slack to
  // align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
};

// qm, km, vm: tensor maps of q [H, Tq, D] and k, v [H, Tk, D] (bf16, each
// with its own strides) with boxes of 64 columns by 128 rows; o in q's
// layout lq, lse [H, Tq] f32 (natural log), both written whole. 384
// threads, grid (ceil(Tq / 128), H).
template <int D>
__global__ void __launch_bounds__(384, 1)
    varlen_fwd_wg_kernel(const __grid_constant__ CUtensorMap qm,
                         const __grid_constant__ CUtensorMap km,
                         const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                         float* __restrict__ lse, Seqs S, Lay lq, float c2) {
  using C = WgFwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_lo[8], s_hi[8];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, wiw = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the last q tile first
  const int h = blockIdx.y;

  // consumer warpgroup wg owns q rows q0 + 64 wg ..; this warp 16 of them,
  // this lane row0 and row1 with their live key intervals
  const int rloc = 64 * wg + 16 * wiw + g;  // row0's row of the CTA's tile
  const int row0 = q0 + rloc, row1 = row0 + 8;
  int lo0 = INT_MAX, hi0 = 0, lo1 = INT_MAX, hi1 = 0;
  WarpSpan w{INT_MAX, 0, INT_MAX, 0};
  if (wg < 2) {
    key_range(S, row0, lo0, hi0);
    key_range(S, row1, lo1, hi1);
    w = warp_span(lo0, hi0, lo1, hi1);
    if (lane == 0) {
      s_lo[warp] = w.lo;
      s_hi[warp] = w.hi;
    }
  }
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the CTA loads the union of its rows' live key stages; a warpgroup
  // skips a stage (or a 64-key half) that none of its rows sees
  int clo, chi, glo, ghi;
  span_of(s_lo, s_hi, 0, 8, clo, chi);
  span_of(s_lo, s_hi, 4 * (wg & 1), 4, glo, ghi);
  const int kb = chi > clo ? clo / BK * BK : 0;  // stage jj holds keys kb + BK jj ..
  const int nj = chi > clo ? (chi - 1 - kb) / BK + 1 : 0;

  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == 256 && nj > 0) {
      mbar_expect_tx(qbar, C::QT_BYTES);
      for (int b = 0; b < NB; ++b) tma_load_3d(sm + b * (BQ * 128), &qm, qbar, 64 * b, q0, h);
      for (int jj = 0; jj < nj; ++jj) {
        const int st = jj % NS;
        if (jj >= NS) mbar_wait(&empty[st], ((jj / NS) & 1) ^ 1);
        unsigned char* ks = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(ks + b * (BK * 128), &km, &full[st], 64 * b, kb + jj * BK, h);
          tma_load_3d(ks + C::KV_BYTES + b * (BK * 128), &vm, &full[st], 64 * b, kb + jj * BK,
                      h);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const uint32_t qa = smem_u32(sm) + wg * 64 * 128;
  float acc[D / 2];  // m64nD accumulator layout
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (nj > 0) mbar_wait(qbar, 0);
  if (wg == 1 && nj > 0) bar_arrive(3, 256);  // warpgroup 0 takes the first turn
  for (int jj = 0; jj < nj; ++jj) {
    const int st = jj % NS, c0 = kb + jj * BK;
    mbar_wait(&full[st], (jj / NS) & 1);
    // the two warpgroups take turns issuing S (named barriers 3 and 4),
    // which keeps their S products apart on the tensor cores; a stage that
    // no row of this warpgroup sees leaves its state as it is: skipped (a
    // warpgroup-uniform branch), its turn passed on
    const bool on = c0 < ghi && c0 + BK > glo;
    bar_sync(3 + wg, 256);
    if (!on && (wg == 0 || jj + 1 < nj)) bar_arrive(4 - wg, 256);
    if (on) {
      const uint32_t ka = smem_u32(sm + C::OFF_KV + st * 2 * C::KV_BYTES), va = ka + C::KV_BYTES;

      // S = Q K^T over the stage's keys (q as given: c2 scales the f32
      // score, never q)
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int x = 0; x < D / 16; ++x)
        wgmma_ss<0, 0, BK>(s, sw128_desc(qa + (x >> 2) * (BQ * 128) + (x & 3) * 32, 16, 1024),
                           sw128_desc(ka + (x >> 2) * (BK * 128) + (x & 3) * 32, 16, 1024), x);
      wg_commit();
      if (wg == 0 || jj + 1 < nj) bar_arrive(4 - wg, 256);
      wg_wait<0>();
      reg_fence(s);

      // the online softmax and P V once per 64-key half, so that P is
      // rounded against the running max of the plain version's walk of
      // BLOCK_K = 64 keys aligned to multiples of 64
#pragma unroll
      for (int hh = 0; hh < BK / 64; ++hh) {
        const int h0 = c0 + 64 * hh;
        if (h0 >= ghi || h0 + 64 <= glo) continue;  // warpgroup-uniform
        // only a half that crosses an end of one of the warp's intervals
        // is masked (a warp-uniform branch)
        const bool masked = !(h0 >= w.lo_max && h0 + 64 <= w.hi_min);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int r = 32 * hh + 4 * n;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = h0 + 8 * n + 2 * t + (e & 1);
            const bool live = e < 2 ? (col >= lo0 && col < hi0) : (col >= lo1 && col < hi1);
            s[r + e] = masked && !live ? -INFINITY : s[r + e] * c2;
          }
          mx0 = fmaxf(mx0, fmaxf(s[r], s[r + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[r + 2], s[r + 3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        // a row with no live key yet keeps m = -inf; base 0 keeps exp2
        // finite (a 128-row tile can span segments)
        const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = exp2f(m0 - b0), al1 = exp2f(m1 - b1);
        float rs0 = 0.f, rs1 = 0.f;
        uint32_t pf[16];  // P rounded to bf16, as the A fragments of P V
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int r = 32 * hh + 4 * n;
          const float p0 = exp2f(s[r] - b0), p1 = exp2f(s[r + 1] - b0);
          const float p2 = exp2f(s[r + 2] - b1), p3 = exp2f(s[r + 3] - b1);
          rs0 += p0 + p1;
          rs1 += p2 + p3;
          pf[2 * n] = pack_bf16(p0, p1);
          pf[2 * n + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * al0 + quad_sum(rs0);
        l1 = l1 * al1 + quad_sum(rs1);
        m0 = mn0;
        m1 = mn1;

        // P V over the half's 64 keys and all D columns (m64nDk16, V read
        // MN-major from the stage) in a zeroed accumulator, added to the
        // running o after its rescale with IEEE adds: the tensor cores'
        // own f32 sums round toward zero, and o carried in them over a
        // long segment drifts. The rescale runs while the product does,
        // and is skipped where the warp's max did not move (exact).
        float pv[D / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1, D>(pv, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                         sw128_desc(va + hh * 8192 + kk * 2048, BK * 128, 1024), kk);
        wg_commit();
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int e = 0; e < D / 2; ++e) acc[e] *= e & 2 ? al1 : al0;
        }
        wg_wait<0>();
        reg_fence(pv);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] += pv[e];
      }
    }
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  // o = acc / l rounded to bf16 (0 for a row with no live key) and staged
  // in this warpgroup's own rows of the Q tile (free once its last product
  // is done), then stored in 16-byte pieces; lse one value a row
  const float d0 = l0 > 0.f ? 1.f / l0 : 0.f, d1 = l1 > 0.f ? 1.f / l1 : 0.f;
  wg_bar(1 + wg);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc, col)) =
        pack_bf16(acc[4 * j] * d0, acc[4 * j + 1] * d0);
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc + 8, col)) =
        pack_bf16(acc[4 * j + 2] * d1, acc[4 * j + 3] * d1);
  }
  if (t == 0) {
    float* lg = lse + (size_t)h * S.tq;
    if (row0 < S.tq) lg[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : 0.f;
    if (row1 < S.tq) lg[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : 0.f;
  }
  wg_bar(1 + wg);
  bf16* og = o + (size_t)h * lq.hs;
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int rr = 64 * wg + i / (D / 8), c = 8 * (i % (D / 8)), row = q0 + rr;
    if (row < S.tq)
      *reinterpret_cast<uint4*>(og + row * lq.rs + c) =
          *reinterpret_cast<const uint4*>(sm + sw128_offset<BQ>(rr, c));
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

// the fused backward's dQ: the f32 scratch cast to dq's dtype
template <typename T, int D>
cudaError_t launch_dq_cast(const Args& a, cudaStream_t stream) {
  const size_t n = (size_t)a.h * a.S.tq * D;
  if (n == 0) return cudaSuccess;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  dq_cast_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(a.dq_acc),
                                                static_cast<T*>(a.dq), n);
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
  if (e != cudaSuccess || !WITH_DQ) return e;
  return launch_dq_cast<T, D>(a, stream);
}

// Tensor maps of q, dout [H, Tq, D] and k, v [H, Tk, D] with each
// operand's own strides, boxes of 64 columns by qrows or krows rows. A
// side with no rows (tq or tk 0) has no live pair, so no box of it is
// ever loaded: the other side's map stands in. The forward has no dout:
// its map is q's.
cudaError_t varlen_maps(const Args& a, int d, int qrows, int krows, CUtensorMap (&maps)[4]) {
  const Lay lq = lay(a.packed, a.h, a.S.tq, d), lk = lay(a.packed, a.h, a.S.tk, d);
  const void* base[4] = {a.q, a.dout ? a.dout : a.q, a.k, a.v};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
    bool qside = i < 2;
    if ((qside ? a.S.tq : a.S.tk) == 0) qside = !qside;
    const int j = qside ? i % 2 : 2 + i % 2;
    const Lay& l = qside ? lq : lk;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)(qside ? a.S.tq : a.S.tk),
                                (cuuint64_t)a.h};
    const cuuint64_t strides[2] = {l.rs * 2, l.hs * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)(i < 2 ? qrows : krows), 1};
    e = tma_map_bf16_strided(&maps[i], base[j], 3, dims, strides, box);
  }
  return e;
}

// bf16 forward on wgmma, the K/V ring filled by TMA
template <int D>
cudaError_t launch_fwd_wg(const Args& a, cudaStream_t stream) {
  using C = WgFwdCfg<D>;
  const dim3 grid((a.S.tq + C::BQ - 1) / C::BQ, a.h);
  if (grid.x == 0) return cudaSuccess;
  CUtensorMap maps[4] = {};
  cudaError_t e = varlen_maps(a, D, C::BQ, C::BK, maps);
  if (e == cudaSuccess) e = allow_smem(varlen_fwd_wg_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return e;
  varlen_fwd_wg_kernel<D><<<grid, 384, C::kSmem, stream>>>(
      maps[0], maps[2], maps[3], static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.S,
      lay(a.packed, a.h, a.S.tq, D), a.scale * kLog2e);
  return cudaGetLastError();
}

// bf16 dK/dV on wgmma, Q and dO stages filled by TMA: the split dK/dV, or
// with DQ the fused backward (dQ by float2 atomics into the zeroed
// scratch, then its cast)
template <int D, bool DQ>
cudaError_t launch_bwd_wg(const Args& a, cudaStream_t stream) {
  using C = WgBwdCfg<D>;
  const dim3 grid((a.S.tk + C::BK - 1) / C::BK, a.h);
  cudaError_t e = cudaSuccess;
  if (grid.x > 0) {  // no keys: dQ stays the zeroed scratch
    CUtensorMap maps[4] = {};
    e = varlen_maps(a, D, C::BQ, C::BK, maps);
    if (e == cudaSuccess) e = allow_smem(varlen_bwd_wg_kernel<D, DQ>, C::kSmem);
    if (e != cudaSuccess) return e;
    varlen_bwd_wg_kernel<D, DQ><<<grid, 384, C::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.dq_acc),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, lay(a.packed, a.h, a.S.tq, D),
        lay(a.packed, a.h, a.S.tk, D), a.scale * kLog2e, a.scale);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || !DQ) return e;
  return launch_dq_cast<bf16, D>(a, stream);
}

// bf16 split dQ on wgmma, the K/V ring filled by TMA
template <int D>
cudaError_t launch_dq_wg(const Args& a, cudaStream_t stream) {
  using C = WgDqCfg<D>;
  const dim3 grid((a.S.tq + C::BQ - 1) / C::BQ, a.h);
  if (grid.x == 0) return cudaSuccess;
  CUtensorMap maps[4] = {};
  cudaError_t e = varlen_maps(a, D, C::BQ, C::BK, maps);
  if (e == cudaSuccess) e = allow_smem(varlen_dq_wg_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return e;
  varlen_dq_wg_kernel<D><<<grid, 384, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.S,
      lay(a.packed, a.h, a.S.tq, D), a.scale * kLog2e, a.scale);
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

// which: 0 forward, 1 fused backward, 2 split dK/dV, 3 split dQ; bf16
// takes the wgmma kernels, f32 the mma.sync ones
template <typename T, int D>
cudaError_t launch(int which, const Args& a, cudaStream_t s) {
  constexpr bool wg = std::is_same<T, bf16>::value;
  switch (which) {
    case 0:
      if constexpr (wg) return launch_fwd_wg<D>(a, s);
      else return launch_fwd<T, D>(a, s);
    case 1:
      if constexpr (wg) return launch_bwd_wg<D, true>(a, s);
      else return launch_bwd<T, D, true>(a, s);
    case 2:
      if constexpr (wg) return launch_bwd_wg<D, false>(a, s);
      else return launch_bwd<T, D, false>(a, s);
    default:
      if constexpr (wg) return launch_dq_wg<D>(a, s);
      else return launch_dq<T, D>(a, s);
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
