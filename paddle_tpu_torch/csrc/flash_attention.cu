// Flash attention forward and fused backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of paddle_tpu/ops/flash_attention.py:
//   flash_fwd  <- _flash_fwd (kernel _fwd_kernel; its default variant
//                 _fwd_kernel_fixed_base is not ported), the resident FA2
//                 forward over [BH, S, D] returning o and the natural-log lse;
//   flash_bwd  <- _bwd_fused_flat_call (kernel _bwd_fused_flat_kernel), the
//                 fused one-pass FA2 backward returning dq, dk, dv.
// q arrives PRE-SCALED by scale * log2(e) (the caller folds it, as the TPU
// path does), so scores are in the log2 domain and the softmax uses exp2.
//
// What bounds them on this card: operations. At the train shape (BH = 128,
// S = 2048, D = 128, causal, bf16) the forward does 2 products of
// 2 * BH * S^2 * D / 2 operations (1.37e11, 0.139 ms at 989 TFLOP/s) over
// 268 MB of q, k, v and o (0.080 ms at 3.35 TB/s); the backward does 5 such
// products (3.44e11, 0.347 ms) over 0.5 GB.
//
// Design (not the TPU's). Products are warp-level mma.sync m16n8k16 (bf16
// in, f32 accumulation) on tiles staged in shared memory; for f32 inputs the
// same warp tile is computed by scalar FMAs with the same register layout,
// so the softmax and masking code is shared. Fragments come from shared
// memory by ldmatrix (.trans where the contraction index is strided, so no
// operand is ever stored transposed); rows are padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts (the warp-level helpers are
// csrc/mma_common.cuh's). Global tiles arrive by 16-byte
// cp.async in a two-stage pipeline (the next tile is in flight while this
// one is used; one barrier per tile). No wgmma, TMA or warp specialisation
// yet: those are later PRs' work.
//
// Forward: one CTA of 4 warps per (64-row q tile, bh); each warp owns 16 q
// rows. The CTA walks 64-key K/V tiles (tiles wholly above the causal
// diagonal are skipped; the ragged tail is bounds-checked and masked, where
// the TPU zero-pads to its block size because Pallas slices clamp) with the
// online softmax in f32: running max, exp2, P ROUNDED TO THE INPUT DTYPE
// before P.V while the normaliser l sums the unrounded f32 P; o = acc /
// max(l, 1e-30), lse = (m + log2 max(l, 1e-30)) * ln 2. Heaviest causal
// tiles are launched first.
//
// Backward: the TPU kernel walks one sequential k-major schedule and carries
// dQ in a persistent [S, D] f32 VMEM scratch from grid step to grid step.
// On Hopper CTAs run in parallel and in no order, so nothing carries over:
// one CTA per (64-key tile, bh) keeps its dK and dV in f32 registers and
// loops over the q tiles from the first live one (q tile >= key0 / BQ under
// causal, _dense_bwd_lo) to the end, computing S^T = K Q~^T, P^T =
// exp2(S^T - lse2), dV += round(P^T) dO, dP^T = V dO^T, dS^T = P^T (dP^T -
// delta) rounded to the input dtype, dK += dS^T Q~, and dQ += dS K. dQ is
// summed across CTAs with f32 atomicAdd into a [BH, S, D] scratch that the
// wrapper zeroes, then a small pass multiplies by scale and casts. Atomics
// were chosen over a second pass over q tiles because the second pass would
// recompute S and dP (7 products instead of 5); the price is a summation
// order for dQ that varies from run to run (the tolerances allow for it).
// dK is multiplied by ln 2 at the end, since q~ carries log2(e).
//
// Types f32 and bf16, head_dim 64 and 128 (template parameters). The
// kernels allocate nothing and do not synchronise; they launch on the
// caller's stream.
#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -1e30f;

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

// q [BH, sq, D] pre-scaled; k, v [BH, sk, D] of which the first kv_len keys
// are live; o [BH, sq, D]; lse [BH, sq] f32 (natural log).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int kv_len,
                     int causal) {
  using C = FwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTS = BK / 8, NTO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BQ * LD;  // stage st: K at kv_s + 2 st BK LD, V after it
  T* p_s = kv_s + 4 * BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int nk = (kv_len + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, sq) - 1) / BK + 1);
  const T* qw = q_s + warp * 16 * LD;
  T* pw = p_s + warp * 16 * LDP;

  // two-stage pipeline: tile j + 1 is in flight while tile j is used
  load_rows<T, D, BQ, LD>(q_s, q + bh * sq * D, q0, sq);
  load_rows<T, D, BK, LD>(kv_s, kg, 0, kv_len);
  load_rows<T, D, BK, LD>(kv_s + BK * LD, vg, 0, kv_len);
  cp_commit();
  for (int j = 0; j < nk; ++j) {
    const int c0 = j * BK;
    cp_wait<0>();
    // tile j has landed for every thread, and every warp is done with
    // tile j - 1, whose stage the next copy refills
    __syncthreads();
    if (j + 1 < nk) {
      T* nxt = kv_s + ((j + 1) & 1) * 2 * BK * LD;
      load_rows<T, D, BK, LD>(nxt, kg, c0 + BK, kv_len);
      load_rows<T, D, BK, LD>(nxt + BK * LD, vg, c0 + BK, kv_len);
      cp_commit();
    }
    const T* k_s = kv_s + (j & 1) * 2 * BK * LD;
    const T* v_s = k_s + BK * LD;

    float s[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_mm<NTS, true, true>(s, qw, LD, k_s, LD, D);  // S = Q~ K^T

    // only the kv tail and tiles that cross this warp's causal diagonal
    // are masked (a warp-uniform branch)
    const bool masked =
        c0 + BK > kv_len || (causal && c0 + BK - 1 > q0 + warp * 16);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= kv_len || (causal && col > row)) s[n][e] = kMask;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      const float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
      const float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
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

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* og = o + bh * sq * D;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < sq) st_pair(og + (size_t)row0 * D + col, acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < sq) st_pair(og + (size_t)row1 * D + col, acc[n][2] / d1, acc[n][3] / d1);
  }
  if (t == 0) {
    if (row0 < sq) lse[bh * sq + row0] = (m0 + log2f(d0)) * kLn2;
    if (row1 < sq) lse[bh * sq + row1] = (m1 + log2f(d1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fused backward
// ---------------------------------------------------------------------------

template <typename T, int D>
struct BwdCfg {
  static constexpr int BK = 64, BQ = D == 128 ? 32 : 64;  // BQ bounds registers
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD, LDP = BQ + PAD;
  // K and V tiles, two stages of (Q~ tile, dO tile), dS^T, lse and delta
  static constexpr size_t kSmem =
      sizeof(T) * ((size_t)2 * BK * LD + 4 * BQ * LD + BK * LDP) + sizeof(float) * 2 * BQ;
};

// q [BH, sq, D] pre-scaled, dout [BH, sq, D], lse and delta [BH, sq] f32
// (lse natural log); k, v [BH, sk, D]. dq_acc [BH, sq, D] f32 must be zero;
// dk, dv [BH, sk, D] are written whole.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq_acc,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal) {
  using C = BwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTQ = BQ / 8, NTO = D / 8;
  // dQ tile [BQ, D] split over the warps: MT m-tiles of 16 rows, each
  // m-tile's D / 8 n-tiles shared by WPM warps
  constexpr int MT = BQ / 16, WPM = kWarps / MT, NTW = NTO / WPM;
  static_assert(kWarps % MT == 0 && NTO % WPM == 0, "dQ split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BK * LD;
  T* qd_s = v_s + BK * LD;  // stage st: Q~ at qd_s + 2 st BQ LD, dO after it
  T* ds_s = qd_s + 4 * BQ * LD;  // P^T, then dS^T: [BK keys][BQ q rows]
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * LDP);
  float* dl_s = lse_s + BQ;

  const int kt = blockIdx.x;  // low key tiles have the most live q tiles
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kt * BK;
  const T* qg = q + bh * sq * D;
  const T* dog = dout + bh * sq * D;
  const float* lseg = lse + bh * sq;
  const float* dlg = delta + bh * sq;
  float* dqg = dq_acc + bh * sq * D;

  float dkc[NTO][4], dvc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkc[n][e] = dvc[n][e] = 0.f;

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const int nq = (sq + BQ - 1) / BQ;
  const int i_lo = causal ? k0 / BQ : 0;
  const T* kw = k_s + warp * 16 * LD;
  const T* vw = v_s + warp * 16 * LD;
  T* dsw = ds_s + warp * 16 * LDP;
  const int mt = warp % MT, nt0 = (warp / MT) * NTW;

  // two-stage pipeline: q tile i + 1 is in flight while tile i is used
  load_rows<T, D, BK, LD>(k_s, k + bh * sk * D, k0, sk);
  load_rows<T, D, BK, LD>(v_s, v + bh * sk * D, k0, sk);
  if (i_lo < nq) {
    load_rows<T, D, BQ, LD>(qd_s, qg, i_lo * BQ, sq);
    load_rows<T, D, BQ, LD>(qd_s + BQ * LD, dog, i_lo * BQ, sq);
  }
  cp_commit();
  for (int i = i_lo; i < nq; ++i) {
    const int r0 = i * BQ;
    cp_wait<0>();
    // every warp has passed the previous tile's mid-tile barrier, so its
    // lse/delta and its q stage are free
    for (int x = threadIdx.x; x < BQ; x += kThreads) {
      const bool live = r0 + x < sq;
      lse_s[x] = live ? lseg[r0 + x] * kLog2e : 0.f;
      dl_s[x] = live ? dlg[r0 + x] : 0.f;
    }
    __syncthreads();  // q tile i, lse and delta are in place for every thread
    if (i + 1 < nq) {
      T* nxt = qd_s + ((i + 1 - i_lo) & 1) * 2 * BQ * LD;
      load_rows<T, D, BQ, LD>(nxt, qg, r0 + BQ, sq);
      load_rows<T, D, BQ, LD>(nxt + BQ * LD, dog, r0 + BQ, sq);
      cp_commit();
    }
    const T* q_s = qd_s + ((i - i_lo) & 1) * 2 * BQ * LD;
    const T* do_s = q_s + BQ * LD;

    // P^T = exp2(K Q~^T - lse2), masked: q tail, kv tail, causal
    float s[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_mm<NTQ, true, true>(s, kw, LD, q_s, LD, D);
    // masks only where the q tail, the kv tail or this warp's causal
    // diagonal reaches the tile (a warp-uniform branch)
    const bool masked = r0 + BQ > sq || k0 + warp * 16 + 16 > sk ||
                        (causal && r0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qrow = r0 + ql;
        const int key = e < 2 ? key0 : key1;
        const float x =
            masked && (qrow >= sq || key >= sk || (causal && qrow < key)) ? kMask : s[n][e];
        s[n][e] = exp2f(x - lse_s[ql]);
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
      st_pair(dsw + g * LDP + ql, s[n][0] * (dp[n][0] - dl_s[ql]),
              s[n][1] * (dp[n][1] - dl_s[ql + 1]));
      st_pair(dsw + (g + 8) * LDP + ql, s[n][2] * (dp[n][2] - dl_s[ql]),
              s[n][3] * (dp[n][3] - dl_s[ql + 1]));
    }
    __syncwarp();
    warp_mm<NTO, true, false>(dkc, dsw, LDP, q_s, LD, BQ);  // dK += round(dS^T) Q~
    __syncthreads();  // every warp's dS^T rows are in ds_s

    // dQ tile += dS K over this CTA's 64 keys, summed across CTAs by atomics
    float dqc[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n) dqc[n][0] = dqc[n][1] = dqc[n][2] = dqc[n][3] = 0.f;
    warp_mm<NTW, false, false>(dqc, ds_s + mt * 16, LDP, k_s + nt0 * 8, LD, BK);
    const int qa = r0 + mt * 16 + g, qb = qa + 8;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int col = (nt0 + n) * 8 + 2 * t;
      // float2 atomics (compute capability 9.x): one per column pair
      if (qa < sq)
        atomicAdd(reinterpret_cast<float2*>(dqg + (size_t)qa * D + col),
                  make_float2(dqc[n][0], dqc[n][1]));
      if (qb < sq)
        atomicAdd(reinterpret_cast<float2*>(dqg + (size_t)qb * D + col),
                  make_float2(dqc[n][2], dqc[n][3]));
    }
  }

  cp_wait<0>();  // no copy outlives the CTA (no live q tile: K, V only)
  T* dkg = dk + bh * sk * D;
  T* dvg = dv + bh * sk * D;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < sk) {
      st_pair(dkg + (size_t)key0 * D + col, dkc[n][0] * kLn2, dkc[n][1] * kLn2);
      st_pair(dvg + (size_t)key0 * D + col, dvc[n][0], dvc[n][1]);
    }
    if (key1 < sk) {
      st_pair(dkg + (size_t)key1 * D + col, dkc[n][2] * kLn2, dkc[n][3] * kLn2);
      st_pair(dvg + (size_t)key1 * D + col, dvc[n][2], dvc[n][3]);
    }
  }
}

template <typename T>
__global__ void dq_finalize_kernel(const float* __restrict__ acc, T* __restrict__ dq, size_t n,
                                   float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, int kv_len, int causal, cudaStream_t stream) {
  using C = FwdCfg<T, D>;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, kv_len, causal);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
                       void* dv, int bh, int sq, int sk, int causal, float scale,
                       cudaStream_t stream) {
  using C = BwdCfg<T, D>;
  cudaError_t e = allow_smem(flash_bwd_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sk + C::BK - 1) / C::BK, bh);
  flash_bwd_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)bh * sq * D;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  dq_finalize_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(dq_acc),
                                                    static_cast<T*>(dq), n, scale);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). The caller
// guarantees contiguous tensors on 16-byte aligned storage, d in {64, 128},
// 1 <= kv_len <= sk, bh <= 65535.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int sq, int sk, int kv_len, int d, int causal, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_len < 1 || kv_len > sk || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh > 0 && sq > 0) {
    cudaError_t e;
    if (dtype == 0 && d == 64)
      e = launch_fwd<float, 64>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 0 && d == 128)
      e = launch_fwd<float, 128>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 1 && d == 64)
      e = launch_fwd<bf16, 64>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 1 && d == 128)
      e = launch_fwd<bf16, 128>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// dq_acc is [bh, sq, d] f32 and must be zero on entry; dq, dk, dv share q's
// dtype. Same guarantees as flash_fwd, with sk >= 1.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
                         void* dv, int bh, int sq, int sk, int d, int causal, float scale,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh > 0 && sq > 0) {
    cudaError_t e;
    if (dtype == 0 && d == 64)
      e = launch_bwd<float, 64>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk,
                                causal, scale, s);
    else if (dtype == 0 && d == 128)
      e = launch_bwd<float, 128>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk,
                                 causal, scale, s);
    else if (dtype == 1 && d == 64)
      e = launch_bwd<bf16, 64>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk,
                               causal, scale, s);
    else if (dtype == 1 && d == 128)
      e = launch_bwd<bf16, 128>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk,
                                causal, scale, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
