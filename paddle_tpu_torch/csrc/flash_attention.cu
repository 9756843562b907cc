// Flash attention forward, fused backward and split backward for Hopper
// (sm_90a).
//
// Replaces four TPU kernels of paddle_tpu/ops/flash_attention.py:
//   flash_fwd      <- _flash_fwd (kernel _fwd_kernel; its default variant
//                     _fwd_kernel_fixed_base is not ported), the resident FA2
//                     forward over [BH, S, D] returning o and the natural-log
//                     lse; it streams K/V tiles at any length, so it also
//                     computes _flash_fwd_stream's function (_fwd_kernel_stream);
//   flash_bwd      <- _bwd_fused_flat_call (kernel _bwd_fused_flat_kernel), the
//                     fused one-pass FA2 backward returning dq, dk, dv; it keeps
//                     no per-sequence scratch on chip, so it also computes
//                     _bwd_fused_stream_chunk's function (_bwd_fused_kernel_stream);
//   flash_bwd_dkv  <- _bwd_pallas_calls (kernel _bwd_dkv_kernel), the split
//                     backward's k-major dK/dV pass: flash_bwd's kernel with the
//                     dQ product compiled out, so dK and dV are flash_bwd's bits;
//   flash_bwd_dq   <- _bwd_pallas_calls (kernel _bwd_dq_kernel), the split
//                     backward's q-major dQ pass, with no atomics.
// q arrives PRE-SCALED by scale * log2(e) (the caller folds it, as the TPU
// path does), so scores are in the log2 domain and the softmax uses exp2.
//
// What bounds them on this card: operations. At the train shape (BH = 128,
// S = 2048, D = 128, causal, bf16) the forward does 2 products of
// 2 * BH * S^2 * D / 2 operations (1.37e11, 0.139 ms at 989 TFLOP/s) over
// 268 MB of q, k, v and o (0.080 ms at 3.35 TB/s); the backward does 5 such
// products (3.44e11, 0.347 ms) over 0.5 GB.
//
// Design (not the TPU's). Every f32 kernel takes warp-level mma.sync m16n8k16 (bf16 in, f32 accumulation) on tiles
// staged in shared memory; for f32 inputs the same warp tile is computed by
// scalar FMAs with the same register layout (no TF32), so the softmax and
// masking code is shared. Fragments come from shared memory by ldmatrix
// (.trans where the contraction index is strided, so no operand is ever
// stored transposed); rows are padded by 16 bytes, which keeps ldmatrix
// free of bank conflicts (csrc/mma_common.cuh). Global tiles arrive by
// 16-byte cp.async in a two-stage pipeline (the next tile is in flight
// while this one is used; one barrier per tile). Every bf16 kernel (the
// forward, the fused backward and both passes of the split backward) runs
// on wgmma instead (below).
//
// Forward (f32): one CTA of 4 warps per (64-row q tile, bh); each warp owns
// 16 q rows. The CTA walks 64-key K/V tiles (tiles wholly above the causal
// diagonal are skipped; the ragged tail is bounds-checked and masked, where
// the TPU zero-pads to its block size because Pallas slices clamp) with the
// online softmax in f32: running max, exp2, P ROUNDED TO THE INPUT DTYPE
// before P.V while the normaliser l sums the unrounded f32 P; o = acc /
// max(l, 1e-30), lse = (m + log2 max(l, 1e-30)) * ln 2. Heaviest causal
// tiles are launched first.
//
// Forward (bf16, flash_fwd_wg_kernel, redesigned for Hopper): the same
// function on a warp-specialised CTA of 128 q rows. Two consumer
// warpgroups own 64 q rows each; K/V stages of 128 keys fill a ring in
// shared memory (two stages at D = 128, four at D = 64), in the 128-byte
// swizzled layout that wgmma reads. The ring is filled by TMA: one thread
// of a third, producer warpgroup (which gives its registers to the
// consumers with setmaxnreg: 24 against 240) issues the loads through 3-D
// tensor maps [BH, S, D], so a box past a head's last row reads zeros and
// not the next head; stages are handed over by mbarriers (full: the
// bytes landed; empty: all 256 consumer threads are done). A cp.async form
// (the consumers copy each stage and arrive on its full barrier as the
// copies land) lost to TMA by 10-29% at every shape when both were timed
// in one call (PERF.md §6), and was removed. Per stage a consumer computes S =
// Q~ K^T over all 128 keys with m64n128k16 from shared memory (Q stays in
// shared memory for the CTA's life), then runs the online softmax and P V
// once for each 64-key half, so that P is rounded against the running max
// of the 64-key walk (a 128-key walk moves o by up to 1.3e-3 relative
// Frobenius, tools/fwd_tile_gap.py): P goes from the S accumulator
// straight into register A fragments (m64n64k16, V read MN-major from the
// stage), into a zeroed accumulator per 64-column block of D, added to the
// running o after its rescale with IEEE adds. The two warpgroups take
// turns issuing S (named barriers 1 and 2). Halves that no row of a
// warpgroup sees are skipped; only the kv tail and halves that cross a
// warp's causal diagonal are masked.
//
// Backward: the TPU kernel walks one sequential k-major schedule and carries
// dQ in a persistent [S, D] f32 VMEM scratch from grid step to grid step.
// On Hopper CTAs run in parallel and in no order, so nothing carries over:
// a CTA owns a key tile, keeps its dK and dV in f32 registers and loops
// over the q tiles from the first live one (q tile >= key0 / BQ under
// causal, _dense_bwd_lo) to the end, computing S^T = K Q~^T, P^T =
// exp2(S^T - lse2), dV += round(P^T) dO, dP^T = V dO^T, dS^T = P^T (dP^T -
// delta) rounded to the input dtype, dK += round(dS^T) Q~, and dQ += dS K.
// dQ is summed across CTAs into a [BH, S, D] f32 scratch that the wrapper
// zeroes (f32: one CTA of 4 warps per 64-key tile, float2 atomics; bf16:
// bulk reduce-adds, below), then a small pass multiplies by scale and casts. A sum across
// CTAs was chosen over a second pass over q tiles because the second pass
// would recompute S and dP (7 products instead of 5); the price is a
// summation order for dQ that varies from run to run (the tolerances allow
// for it). dK and dV take each q tile's product in a zeroed accumulator
// and add it to their running sums in f32: the tensor cores' own f32 sums
// round toward zero, and a sum carried in them over thousands of q tiles
// drifts (dK 1.17e-3 low, relative, at S = 131072). dK is multiplied by
// ln 2 at the end, since q~ carries log2(e). The dK/dV pass of the split
// backward is the same kernel with DQ = false: the dS K product and its
// sum are compiled out, everything else (schedule, barriers, rounding) is
// the same code, so its dK and dV are bitwise the fused kernel's (4
// products at the train shape, 0.278 ms).
//
// bf16 (flash_bwd_wg_kernel, redesigned for Hopper): a CTA of two
// warpgroups owns 128 keys, each warpgroup 64 of them, and steps over the
// q tiles 64 rows at a time. Its K and V stay in shared memory; the Q~ and
// dO tiles, with lse and delta, stream through a two-stage cp.async ring,
// all in the 128-byte swizzled layout that wgmma reads (wgmma_common.cuh;
// cp.async rather than TMA: it needs no tensor map per call from the
// driver, and the loads are 32 KB a step against five 64 x 64 x D
// products). All five products are wgmma m64n64k16: S^T and dP^T from
// shared memory (K-major), dV and dK with P^T and dS^T taken straight from
// the S^T and dP^T accumulators as register A fragments and Q~ and dO
// read MN-major from the same tiles, 64 columns of D at a time; dQ from
// dS^T written to shared memory (MN-major A) and K (MN-major B):
// warpgroup wg takes D columns 64 wg.. over all 128 keys at D = 128, or
// all 64 columns over its own keys at D = 64. The dQ product is issued
// as soon as dS^T is in shared memory and its partial (64 x 64 f32 a
// warpgroup) is staged while dV's first product runs. It is staged in
// the accumulators' own register order, so that a warp's stores cover
// contiguous 512 bytes (no bank conflicts), and each warpgroup's 16 KB
// block is added to the f32 scratch by one thread with one bulk
// reduce-add (cp.reduce.async.bulk .add.f32): the L2 does the adds, no
// thread issues an atomic, and the scratch keeps that order (a small pass
// reads it back in row order, times scale, cast). Staging is
// double-buffered, so a step waits only for the reduce of two steps
// before. Registers: dK and dV 64 each at D = 128, S^T and dP^T 32 each,
// a 64-column product 32; one CTA of 256 threads an SM, so every thread
// may hold 255 and no warp needs to give registers away (no producer
// warp, no setmaxnreg). A step has one CTA barrier (the q tile landed),
// one more at D = 128 (dS^T of both warpgroups), and a warpgroup barrier
// before each reduce.
//
// Split dQ pass: a CTA per q tile walks the live K/V tiles (key tiles
// that hold a key <= some row of the q tile under causal, the forward's
// live set). Per tile it recomputes S = Q~ K^T, P = exp2(S - lse2), dP =
// dO V^T and dS = P (dP - delta) rounded to the input dtype before any
// scale (the TPU kernel's rounding point), and adds dQ += dS K: 3
// products, no atomics, so dQ has the same bits on every run. dQ is
// multiplied by scale once at the end and cast. At the train shape it does
// 3 products of 2 * BH * S^2 * D / 2 operations (0.208 ms).
// f32: one CTA of 4 warps per 64-row q tile, each warp owning 16 q rows,
// 64-key tiles through the forward's two-stage pipeline, dQ in f32
// registers.
// bf16 (flash_bwd_dq_wg_kernel, redesigned for Hopper; the design of the
// varlen dQ, flash_varlen.cu's varlen_dq_wg_kernel): a CTA of 128 q rows,
// two consumer warpgroups of 64 rows and a producer warpgroup that gives
// its registers to them (setmaxnreg 24 against 240). The producer loads Q~
// and dO once and fills a ring of 128-key K/V stages (two at D = 128, four
// at D = 64: 128 KB) by TMA through 3-D maps over [BH, S, D], so a box
// past a head's last row reads zeros; full/empty mbarriers hand the
// stages over. Per stage a consumer computes S and dP as m64n128k16 from
// shared memory, forms dS straight into register A fragments (masked only
// on the kv tail and on stages that cross a warp's diagonal, top-left
// aligned at Sq != Sk), and takes dS K (m64nDk16, K read MN-major from the
// stage) into a zeroed accumulator that it adds to dQ in f32 registers
// with IEEE adds: the tensor cores round their own f32 sums toward zero,
// and a dQ carried in them over the key tiles drifted 2.4e-5 low at S =
// 131072 in the mma.sync form this kernel replaced. A stage wholly above a
// warpgroup's diagonal is skipped. dQ times scale is staged in the
// warpgroup's own rows of the Q~ tile and stored in 16-byte pieces; the
// last q tile is launched first.
//
// Types f32 and bf16, head_dim 64 and 128 (template parameters). The
// kernels allocate nothing and do not synchronise; they launch on the
// caller's stream.
#include <math.h>

#include <type_traits>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

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
// are live; o [BH, sq, D]; lse [BH, sq] f32 (natural log). f32 only: bf16
// takes flash_fwd_wg_kernel.
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
// forward for bf16 on wgmma (rows 14 and 13)
// ---------------------------------------------------------------------------

template <int D>
struct WgFwdCfg {
  static constexpr int BQ = 128, BK = 128;      // q rows a CTA, keys a stage
  static constexpr int NS = D == 64 ? 4 : 2;    // ring stages
  static constexpr int NB = D / 64;             // 64-column blocks of D
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_KV = Q_BYTES;        // stage st: K, then V
  static constexpr int OFF_BAR = OFF_KV + NS * 2 * KV_BYTES;
  // barriers (Q landed, NS stages full, NS stages empty), and slack to
  // align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
};

// 2^x by the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q [BH, sq, D] pre-scaled, k, v [BH, sk, D] of which the first kv_len
// keys are live, all bf16; o [BH, sq, D] bf16, lse [BH, sq] f32 (natural
// log), given as qm, km, vm: tensor maps of q, k, v as [BH, S, D] with
// boxes of 64 columns by 128 rows. 384 threads, grid (ceil(sq / 128), BH).
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                        float* __restrict__ lse, int sq, int kv_len, int causal) {
  using C = WgFwdCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  int nk = (kv_len + BK - 1) / BK;  // stages of 128 keys
  if (causal) nk = min(nk, (min(q0 + BQ, sq) - 1) / BK + 1);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int b = 0; b < NB; ++b) tma_load_3d(sm + b * (BQ * 128), &qm, qbar, 64 * b, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) & 1) ^ 1);
        unsigned char* ks = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(ks + b * (BK * 128), &km, &full[st], 64 * b, j * BK, bh);
          tma_load_3d(ks + C::KV_BYTES + b * (BK * 128), &vm, &full[st], 64 * b, j * BK, bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumers: warpgroup wg owns q rows q0 + 64 wg .., this warp 16 of them
  const int wiw = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = q0 + 64 * wg + 16 * wiw;
  const int row0 = rw + g, row1 = row0 + 8;
  const uint32_t qa = smem_u32(sm) + wg * 64 * 128;
  float acc[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  if (wg == 1) bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  for (int j = 0; j < nk; ++j) {
    const int st = j % NS;
    mbar_wait(&full[st], (j / NS) & 1);
    const uint32_t ka = smem_u32(sm + C::OFF_KV + st * 2 * C::KV_BYTES), va = ka + C::KV_BYTES;

    // S = Q~ K^T over the stage's 128 keys; the two warpgroups take turns
    // issuing it (named barriers 1 and 2), which keeps their S products
    // apart on the tensor cores
    float s[64];
    bar_sync(1 + wg, 256);
    wg_fence();
#pragma unroll
    for (int x = 0; x < D / 16; ++x)
      wgmma_ss<0, 0, 128>(s, sw128_desc(qa + (x >> 2) * (BQ * 128) + (x & 3) * 32, 16, 1024),
                          sw128_desc(ka + (x >> 2) * (BK * 128) + (x & 3) * 32, 16, 1024), x);
    wg_commit();
    if (wg == 0 || j + 1 < nk) bar_arrive(2 - wg, 256);
    wg_wait<0>();
    reg_fence(s);

    // the online softmax and P V once per 64-key half, so that P is
    // rounded against the running max of the 64-key walk (BLOCK_K of
    // ops/flash_attention.py)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = j * BK + 64 * hh;
      // a half that no row of this warpgroup sees would leave its state
      // as it is (alpha 1, P 0): skipped (a warpgroup-uniform branch)
      if (c0 >= kv_len || (causal && c0 > q0 + 64 * wg + 63)) continue;
      // only the kv tail and halves that cross this warp's causal diagonal
      // are masked (a warp-uniform branch)
      const bool masked = c0 + 64 > kv_len || (causal && c0 + 63 > rw);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int r = 32 * hh + 4 * n;
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * n + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= kv_len || (causal && col > row)) s[r + e] = kMask;
          }
        }
        mx0 = fmaxf(mx0, fmaxf(s[r], s[r + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[r + 2], s[r + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2_ftz(m0 - mn0), al1 = exp2_ftz(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t pf[16];  // P rounded to bf16, as the A fragments of P V
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int r = 32 * hh + 4 * n;
        const float p0 = exp2_ftz(s[r] - mn0), p1 = exp2_ftz(s[r + 1] - mn0);
        const float p2 = exp2_ftz(s[r + 2] - mn1), p3 = exp2_ftz(s[r + 3] - mn1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pf[2 * n] = pack_bf16(p0, p1);
        pf[2 * n + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * al0 + quad_sum(rs0);
      l1 = l1 * al1 + quad_sum(rs1);
      m0 = mn0;
      m1 = mn1;

      // P V over the half's 64 keys, each 64-column block of D in a zeroed
      // accumulator, added to the running o after its rescale with IEEE
      // adds (a sum carried in the tensor cores' accumulator over
      // thousands of key tiles would drift toward zero); the rescale runs
      // while the product does, and is skipped where the warp's max did
      // not move (a rescale by 1 is exact)
      float pv[NB][32];
      wg_fence();
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(pv[h], pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                      sw128_desc(va + h * (BK * 128) + hh * 8192 + kk * 2048, BK * 128, 1024),
                      kk);
      wg_commit();
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int h = 0; h < NB; ++h)
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[h][e] *= e & 2 ? al1 : al0;
      }
      wg_wait<0>();
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        reg_fence(pv[h]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] += pv[h][e];
      }
    }
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* og = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * h + 8 * n + 2 * t;
      if (row0 < sq) st_pair(og + (size_t)row0 * D + col, acc[h][4 * n] / d0, acc[h][4 * n + 1] / d0);
      if (row1 < sq)
        st_pair(og + (size_t)row1 * D + col, acc[h][4 * n + 2] / d1, acc[h][4 * n + 3] / d1);
    }
  if (t == 0) {
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(d0)) * kLn2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(d1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fused backward
// ---------------------------------------------------------------------------

// c += A (16 x K, k contiguous) * B (K x 8 NT, n contiguous), the product
// summed in a zeroed register tile of NT / 2 n-tiles at a time and added
// to c with f32 round-to-nearest adds. The tensor cores round the f32 sums
// of an mma toward zero, so a sum carried in the mma accumulator over
// thousands of q tiles drifts toward zero (dK and dV 2.5e-4 low, relative,
// at S = 131072); one q tile's product is at most BQ terms.
template <int NT, typename T>
__device__ __forceinline__ void mm_add(float (&c)[NT][4], const T* a, int lda, const T* b,
                                       int ldb, int K) {
  constexpr int H = NT / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float p[H][4];
#pragma unroll
    for (int n = 0; n < H; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    warp_mm<H, true, false>(p, a, lda, b + h * H * 8, ldb, K);
#pragma unroll
    for (int n = 0; n < H; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[h * H + n][e] += p[n][e];
  }
}

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
// (lse natural log); k, v [BH, sk, D]. DQ: dq_acc [BH, sq, D] f32 must be
// zero (unused without DQ); dk, dv [BH, sk, D] are written whole.
template <typename T, int D, bool DQ>
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
  [[maybe_unused]] float* dqg = DQ ? dq_acc + bh * sq * D : nullptr;

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
  [[maybe_unused]] const int mt = warp % MT, nt0 = (warp / MT) * NTW;

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
    mm_add<NTO>(dvc, dsw, LDP, do_s, LD, BQ);  // dV += round(P^T) dO

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
    mm_add<NTO>(dkc, dsw, LDP, q_s, LD, BQ);  // dK += round(dS^T) Q~
    // every warp's dS^T rows are in ds_s; every warp is done with this
    // tile's lse, delta and q stage (kept without DQ for that)
    __syncthreads();

    // dQ tile += dS K over this CTA's 64 keys, summed across CTAs by atomics
    if constexpr (DQ) {
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

// ---------------------------------------------------------------------------
// fused backward for bf16 on wgmma (rows 16 and 17)
// ---------------------------------------------------------------------------

template <int D>
struct WgBwdCfg {
  static constexpr int BK = 128, BQ = 64, NT = 256;  // keys, q rows a step, threads
  static constexpr int NB = D / 64;                   // 64-column blocks of D
  static constexpr int KV_BYTES = BK * D * 2;         // K or V, resident
  static constexpr int QT_BYTES = BQ * D * 2;         // one stage of Q~ or dO
  static constexpr int DS_BYTES = BK * BQ * 2;        // dS^T [keys][q rows]
  static constexpr int PART_BYTES = BQ * 64 * 4;      // a warpgroup's dQ part, f32
  static constexpr int OFF_V = KV_BYTES, OFF_Q = 2 * KV_BYTES, OFF_DO = OFF_Q + 2 * QT_BYTES,
                       OFF_DS = OFF_DO + 2 * QT_BYTES, OFF_STG = OFF_DS + DS_BYTES,
                       OFF_STAT = OFF_STG + 2 * 2 * PART_BYTES;  // two steps
  // two stages of (lse, delta), and slack to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_STAT + 2 * 2 * BQ * 4 + 1024;
};

// q [BH, sq, D] pre-scaled, dout [BH, sq, D], lse and delta [BH, sq] f32
// (lse natural log); k, v [BH, sk, D], all bf16. DQ: dq_acc, BH x
// ceil(sq / 64) tiles of 64 x D f32 in the accumulators' order (read back
// by dq_finalize_wg_kernel), must be zero (unused without DQ); dk, dv
// [BH, sk, D] are written whole. Launched with 256 threads, grid
// (ceil(sk / 128), BH).
template <int D, bool DQ>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int sq, int sk, int causal) {
  using C = WgBwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* k_s = reinterpret_cast<bf16*>(sm);
  bf16* v_s = reinterpret_cast<bf16*>(sm + C::OFF_V);
  float* stg = reinterpret_cast<float*>(sm + C::OFF_STG);
  float* stat = reinterpret_cast<float*>(sm + C::OFF_STAT);  // stage st: lse, then delta
  const uint32_t ka = smem_u32(k_s), va = smem_u32(v_s), qa0 = smem_u32(sm + C::OFF_Q),
                 doa0 = smem_u32(sm + C::OFF_DO), dsa = smem_u32(sm + C::OFF_DS);

  const int tid = threadIdx.x, wg = tid >> 7, wiw = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x;  // low key tiles have the most live q tiles
  const size_t bh = blockIdx.y;
  const int k0 = kt * BK;
  const bf16* qg = q + bh * sq * D;
  const bf16* dog = dout + bh * sq * D;
  const float* lseg = lse + bh * sq;
  const float* dlg = delta + bh * sq;
  const int nq = (sq + BQ - 1) / BQ;
  [[maybe_unused]] float* dqg = DQ ? dq_acc + bh * nq * BQ * D : nullptr;

  // this warpgroup owns keys k0 + 64 wg ..; this warp 16 of them
  const int kw = k0 + 64 * wg + 16 * wiw;
  const int key0 = kw + g, key1 = key0 + 8;
  const int krow = 64 * wg + 16 * wiw + g;  // key0's row of the CTA's tile
  const int i_lo = causal ? k0 / BQ : 0;

  auto load_stage = [&](int st, int i) {
    load_sw128<D, BQ, NT>(reinterpret_cast<bf16*>(sm + C::OFF_Q + st * C::QT_BYTES), qg, i * BQ,
                          sq);
    load_sw128<D, BQ, NT>(reinterpret_cast<bf16*>(sm + C::OFF_DO + st * C::QT_BYTES), dog,
                          i * BQ, sq);
    for (int x = tid; x < 2 * BQ; x += NT) {
      const int r = i * BQ + (x % BQ);
      const float* src = x < BQ ? lseg : dlg;
      cp_async4(stat + st * 2 * BQ + x, src + (r < sq ? r : 0), r < sq ? 4 : 0);
    }
  };

  float dkc[NB][32], dvc[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) dkc[h][e] = dvc[h][e] = 0.f;

  // K and V stay; q tile i + 1 is in flight while tile i is used
  load_sw128<D, BK, NT>(k_s, k + bh * sk * D, k0, sk);
  load_sw128<D, BK, NT>(v_s, v + bh * sk * D, k0, sk);
  if (i_lo < nq) load_stage(0, i_lo);
  cp_commit();
  for (int i = i_lo; i < nq; ++i) {
    const int st = (i - i_lo) & 1, r0 = i * BQ;
    // the dQ reduce of step i - 2 has read this step's staging part
    if (DQ && (tid & 127) == 0) bulk_wait_read<1>();
    cp_wait<0>();
    fence_async_smem();
    // q tile i is in place for every thread; every warpgroup is done with
    // tile i - 1, whose stage the next copy refills
    __syncthreads();
    if (i + 1 < nq) {
      load_stage(st ^ 1, i + 1);
      cp_commit();
    }
    const uint32_t qa = qa0 + st * C::QT_BYTES, doa = doa0 + st * C::QT_BYTES;
    const float* lse_s = stat + st * 2 * BQ;
    const float* dl_s = lse_s + BQ;

    // S^T = K Q~^T and dP^T = V dO^T for this warpgroup's 64 keys
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

    // P^T = exp2(S^T - lse2), masked (q tail, kv tail, causal), rounded for
    // dV; dS^T = P^T (dP^T - delta), rounded for dK and dQ. Only warps that
    // the q tail, the kv tail or the causal diagonal reach test the mask.
    const bool masked = r0 + BQ > sq || kw + 16 > sk || (causal && r0 < kw + 15);
    uint32_t pf[16], dsf[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pe[4], de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), qrow = r0 + ql;
        const int key = e < 2 ? key0 : key1;
        const float x =
            masked && (qrow >= sq || key >= sk || (causal && qrow < key)) ? kMask : s[4 * j + e];
        pe[e] = exp2f(x - lse_s[ql] * kLog2e);
        de[e] = pe[e] * (dp[4 * j + e] - dl_s[ql]);
      }
      pf[2 * j] = pack_bf16(pe[0], pe[1]);
      pf[2 * j + 1] = pack_bf16(pe[2], pe[3]);
      dsf[2 * j] = pack_bf16(de[0], de[1]);
      dsf[2 * j + 1] = pack_bf16(de[2], de[3]);
      if constexpr (DQ) {
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow, 8 * j + 2 * t)) =
            dsf[2 * j];
        *reinterpret_cast<uint32_t*>(sm + C::OFF_DS + sw128_offset<BK>(krow + 8, 8 * j + 2 * t)) =
            dsf[2 * j + 1];
      }
    }

    // dQ tile += dS K over this CTA's keys, summed across CTAs by bulk
    // reduce-adds from shared memory. D = 128: warpgroup wg takes columns
    // 64 wg.. over all 128 keys; D = 64: all columns over its own 64 keys.
    // Issued first; its partial is staged while dV's first product runs.
    [[maybe_unused]] float dq[32];
    if constexpr (DQ) {
      fence_async_smem();
      // dS^T of every warpgroup (D = 128), of this one (D = 64), is in
      // shared memory
      if constexpr (D == 128)
        __syncthreads();
      else
        wg_bar(1 + wg);
      wg_fence();
      if constexpr (D == 128) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<1, 1>(dq, sw128_desc(dsa + kk * 2048, BK * 128, 1024),
                         sw128_desc(ka + wg * (BK * 128) + kk * 2048, BK * 128, 1024), kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(dq, sw128_desc(dsa + wg * 8192 + kk * 2048, BK * 128, 1024),
                         sw128_desc(ka + wg * 8192 + kk * 2048, BK * 128, 1024), kk);
      }
      wg_commit();
      reg_fence(dq);
    }

    // dV += round(P^T) dO and dK += round(dS^T) Q~: each q tile's product
    // in a zeroed accumulator, 64 columns at a time, added to the running
    // f32 sums with IEEE adds (the tensor cores' own f32 sums round toward
    // zero, and a sum carried in them over thousands of q tiles drifts)
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      float pr[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(pr, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                    sw128_desc(doa + h * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
      wg_commit();
      reg_fence(pr);
      if constexpr (DQ) {
        if (h == 0) {
          wg_wait<1>();  // the dQ product is done
          reg_fence(dq);
          // The partial goes to the scratch in the accumulators' own
          // order: warp wiw's 16 rows x 64 columns as [8 j][32 lanes][4],
          // so that each float4 store of a warp covers 512 contiguous
          // bytes (no bank conflicts) and the warpgroup's part is one
          // contiguous 16 KB block, added by one bulk reduce (D = 128: the
          // tile's columns 64 wg..; D = 64: both warpgroups add onto the
          // whole tile).
          float* part = stg + (st * 2 + wg) * (BQ * 64);
          float* pw = part + wiw * 1024 + lane * 4;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float4*>(pw + j * 128) =
                make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
          fence_async_smem();
          wg_bar(1 + wg);  // this warpgroup's part is whole
          if ((tid & 127) == 0) {
            bulk_reduce_add_f32(dqg + (size_t)i * BQ * D + (D == 128 ? wg * BQ * 64 : 0), part,
                                C::PART_BYTES);
            bulk_commit();
          }
        }
      }
      wg_wait<0>();
      reg_fence(pr);
#pragma unroll
      for (int e = 0; e < 32; ++e) dvc[h][e] += pr[e];
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      float pr[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(pr, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                    sw128_desc(qa + h * (BQ * 128) + kk * 2048, BQ * 128, 1024), kk);
      wg_commit();
      wg_wait<0>();
      reg_fence(pr);
#pragma unroll
      for (int e = 0; e < 32; ++e) dkc[h][e] += pr[e];
    }
  }

  if (DQ && (tid & 127) == 0) bulk_wait();  // no bulk operation outlives the CTA
  cp_wait<0>();                     // nor a copy (no live q tile: K, V only)
  bf16* dkg = dk + bh * sk * D;
  bf16* dvg = dv + bh * sk * D;
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * h + 8 * j + 2 * t;
      if (key0 < sk) {
        st_pair(dkg + (size_t)key0 * D + col, dkc[h][4 * j] * kLn2, dkc[h][4 * j + 1] * kLn2);
        st_pair(dvg + (size_t)key0 * D + col, dvc[h][4 * j], dvc[h][4 * j + 1]);
      }
      if (key1 < sk) {
        st_pair(dkg + (size_t)key1 * D + col, dkc[h][4 * j + 2] * kLn2, dkc[h][4 * j + 3] * kLn2);
        st_pair(dvg + (size_t)key1 * D + col, dvc[h][4 * j + 2], dvc[h][4 * j + 3]);
      }
    }
}

// ---------------------------------------------------------------------------
// split backward, dQ pass
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD, LDP = BK + PAD;
  // Q~ and dO tiles, two stages of (K tile, V tile), dS
  static constexpr size_t kSmem = sizeof(T) * ((size_t)2 * BQ * LD + 4 * BK * LD + BQ * LDP);
};

// q [BH, sq, D] pre-scaled, dout [BH, sq, D], lse and delta [BH, sq] f32
// (lse natural log); k, v [BH, sk, D]. dq [BH, sq, D] is written whole,
// with respect to the unscaled q (times scale).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                        int causal, float scale) {
  using C = DqCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NTS = BK / 8, NTO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * LD;
  T* kv_s = do_s + BQ * LD;  // stage st: K at kv_s + 2 st BK LD, V after it
  T* ds_s = kv_s + 4 * BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;

  // this lane's two rows: lse in the log2 domain and delta (0 past sq,
  // where q and dO are zero-filled, so dS is 0 there)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < sq ? lse[bh * sq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < sq ? lse[bh * sq + row1] * kLog2e : 0.f;
  const float dl0 = row0 < sq ? delta[bh * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[bh * sq + row1] : 0.f;
  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, sq) - 1) / BK + 1);
  const T* qw = q_s + warp * 16 * LD;
  const T* dow = do_s + warp * 16 * LD;
  T* dsw = ds_s + warp * 16 * LDP;

  // two-stage pipeline: K/V tile j + 1 is in flight while tile j is used
  load_rows<T, D, BQ, LD>(q_s, q + bh * sq * D, q0, sq);
  load_rows<T, D, BQ, LD>(do_s, dout + bh * sq * D, q0, sq);
  load_rows<T, D, BK, LD>(kv_s, kg, 0, sk);
  load_rows<T, D, BK, LD>(kv_s + BK * LD, vg, 0, sk);
  cp_commit();
  for (int j = 0; j < nk; ++j) {
    const int c0 = j * BK;
    cp_wait<0>();
    // tile j has landed for every thread, and every warp is done with
    // tile j - 1 (its stage, and its own dS rows)
    __syncthreads();
    if (j + 1 < nk) {
      T* nxt = kv_s + ((j + 1) & 1) * 2 * BK * LD;
      load_rows<T, D, BK, LD>(nxt, kg, c0 + BK, sk);
      load_rows<T, D, BK, LD>(nxt + BK * LD, vg, c0 + BK, sk);
      cp_commit();
    }
    const T* k_s = kv_s + (j & 1) * 2 * BK * LD;
    const T* v_s = k_s + BK * LD;

    float s[NTS][4], dp[NTS][4];
#pragma unroll
    for (int n = 0; n < NTS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_mm<NTS, true, true>(s, qw, LD, k_s, LD, D);    // S = Q~ K^T
    warp_mm<NTS, true, true>(dp, dow, LD, v_s, LD, D);  // dP = dO V^T

    // only the kv tail and tiles that cross this warp's causal diagonal
    // are masked (a warp-uniform branch)
    const bool masked = c0 + BK > sk || (causal && c0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < NTS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float x = masked && (col >= sk || (causal && col > row)) ? kMask : s[n][e];
        const float p = exp2f(x - (e < 2 ? lse0 : lse1));
        ds[e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
      }
      st_pair(dsw + g * LDP + n * 8 + 2 * t, ds[0], ds[1]);
      st_pair(dsw + (g + 8) * LDP + n * 8 + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();  // dS of this warp's rows is in ds_s
    warp_mm<NTO, true, false>(acc, dsw, LDP, k_s, LD, BK);  // dQ += round(dS) K
  }
  cp_wait<0>();  // no copy outlives the CTA

  T* dqg = dq + bh * sq * D;
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < sq) st_pair(dqg + (size_t)row0 * D + col, acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < sq) st_pair(dqg + (size_t)row1 * D + col, acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// split backward, dQ pass for bf16 on wgmma (row 18)
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

// qm, dom, km, vm: tensor maps of q (pre-scaled), dout [BH, sq, D] and k, v
// [BH, sk, D] (bf16) with boxes of 64 columns by 128 rows; lse (natural
// log), delta [BH, sq] f32; dq [BH, sq, D] written whole, with respect to
// the unscaled q (times scale). 384 threads, grid (ceil(sq / 128), BH).
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap dom,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int sk,
                           int causal, float scale) {
  using C = WgDqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, wg = tid >> 7, wiw = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the last q tile first
  const int bh = blockIdx.y;
  int nk = (sk + BK - 1) / BK;  // stages of 128 keys
  if (causal) nk = min(nk, (min(q0 + BQ, sq) - 1) / BK + 1);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(qbar, 2 * C::QT_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm + b * (BQ * 128), &qm, qbar, 64 * b, q0, bh);
        tma_load_3d(sm + C::OFF_DO + b * (BQ * 128), &dom, qbar, 64 * b, q0, bh);
      }
      for (int j = 0; j < nk; ++j) {
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) & 1) ^ 1);
        unsigned char* ks = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(ks + b * (BK * 128), &km, &full[st], 64 * b, j * BK, bh);
          tma_load_3d(ks + C::KV_BYTES + b * (BK * 128), &vm, &full[st], 64 * b, j * BK, bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg owns q rows q0 + 64 wg ..; this warp 16 of them
  // from rw, this lane row0 and row1: lse in the log2 domain and delta (0
  // past sq, where q and dO read zeros, so dS is 0 there)
  const int rloc = 64 * wg + 16 * wiw + g;  // row0's row of the CTA's tile
  const int rw = q0 + 64 * wg + 16 * wiw;
  const int row0 = q0 + rloc, row1 = row0 + 8;
  const float lse0 = row0 < sq ? lse[(size_t)bh * sq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < sq ? lse[(size_t)bh * sq + row1] * kLog2e : 0.f;
  const float dl0 = row0 < sq ? delta[(size_t)bh * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[(size_t)bh * sq + row1] : 0.f;
  const uint32_t qa = smem_u32(sm) + wg * 64 * 128, doa = qa + C::OFF_DO;
  float acc[D / 2];  // m64nD accumulator layout
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < nk; ++j) {
    const int st = j % NS, c0 = j * BK;
    mbar_wait(&full[st], (j / NS) & 1);
    // a stage wholly above the causal diagonal of this warpgroup's rows
    // adds nothing: skipped (a warpgroup-uniform branch)
    if (!causal || c0 <= q0 + 64 * wg + 63) {
      const uint32_t ka = smem_u32(sm + C::OFF_KV + st * 2 * C::KV_BYTES), va = ka + C::KV_BYTES;

      // S = Q~ K^T and dP = dO V^T over the stage's keys
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

      // P = exp2(S - lse2), 0 past the kv tail and above the causal
      // diagonal (top-left); dS = P (dP - delta) rounded to bf16 before any
      // scale (the TPU kernel's and the plain version's rounding point),
      // straight into the A fragments of dS K. Only the kv tail and stages
      // that cross this warp's diagonal are masked (a warp-uniform branch).
      const bool masked = c0 + BK > sk || (causal && c0 + BK - 1 > rw);
      uint32_t dsf[BK / 4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool dead = masked && (col >= sk || (causal && col > row));
          const float p = dead ? 0.f : exp2f(s[4 * n + e] - (e < 2 ? lse0 : lse1));
          de[e] = p * (dp[4 * n + e] - (e < 2 ? dl0 : dl1));
        }
        dsf[2 * n] = pack_bf16(de[0], de[1]);
        dsf[2 * n + 1] = pack_bf16(de[2], de[3]);
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

  // dQ times scale, rounded to bf16 and staged in this warpgroup's own rows
  // of the Q tile (free once its last product is done; the swizzle keeps
  // the pair writes free of bank conflicts), then stored in 16-byte pieces
  wg_bar(1 + wg);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc, col)) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(sm + sw128_offset<BQ>(rloc + 8, col)) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  wg_bar(1 + wg);
  bf16* dqg = dq + (size_t)bh * sq * D;
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int rr = 64 * wg + i / (D / 8), c = 8 * (i % (D / 8)), row = q0 + rr;
    if (row < sq)
      *reinterpret_cast<uint4*>(dqg + (size_t)row * D + c) =
          *reinterpret_cast<const uint4*>(sm + sw128_offset<BQ>(rr, c));
  }
}

template <typename T>
__global__ void dq_finalize_kernel(const float* __restrict__ acc, T* __restrict__ dq, size_t n,
                                   float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

// dq [BH, sq, D] bf16 = scale x dq_acc read back from flash_bwd_wg_kernel's
// tile order: within the 64 x D tile of q rows 64 i.., element (r, d) of
// warp r / 16's block of columns 64 (d / 64).. sits at [d / 64][r / 16][j =
// (d % 64) / 8][lane = 4 (r % 8) + (d % 8) / 2][2 ((r / 8) % 2) + d % 2].
template <int D>
__global__ void dq_finalize_wg_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                                      int bh, int sq, float scale) {
  const int nq = (sq + 63) / 64;
  const size_t npairs = (size_t)bh * sq * D / 2;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < npairs;
       p += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 2 * p, row = e / D;
    const int d = (int)(e % D), qr = (int)(row % sq);
    const size_t b = row / sq;
    const int r = qr % 64, c = d % 64;
    const size_t off = (b * nq + qr / 64) * 64 * D + (size_t)(d / 64) * 4096 + (r / 16) * 1024 +
                       (c / 8) * 128 + (4 * (r % 8) + (c % 8) / 2) * 4 + 2 * ((r / 8) % 2);
    const float2 x = *reinterpret_cast<const float2*>(acc + off);
    st_pair(dq + e, x.x * scale, x.y * scale);
  }
}

// f32 on the scalar path of mma_common.cuh
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, int kv_len, int causal, cudaStream_t stream) {
  using C = FwdCfg<float, D>;
  cudaError_t e = allow_smem(flash_fwd_kernel<float, D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  flash_fwd_kernel<float, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), sq, sk, kv_len, causal);
  return cudaSuccess;
}

// bf16 on wgmma, the ring filled by TMA
template <int D>
cudaError_t launch_fwd_wg(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                          int sq, int sk, int kv_len, int causal, cudaStream_t stream) {
  using C = WgFwdCfg<D>;
  CUtensorMap maps[3] = {};
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)(i ? sk : sq), (cuuint64_t)bh};
    const cuuint32_t box[3] = {64, (cuuint32_t)C::BQ, 1};
    const cudaError_t e = tma_map_bf16(&maps[i], base[i], 3, dims, box);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = allow_smem(flash_fwd_wg_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  flash_fwd_wg_kernel<D><<<grid, 384, C::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                           static_cast<bf16*>(o),
                                                           static_cast<float*>(lse), sq, kv_len,
                                                           causal);
  return cudaSuccess;
}

// The fused backward's kernel (DQ) or its dK/dV pass (no DQ): bf16 on
// wgmma, f32 on the scalar path of mma_common.cuh.
template <typename T, int D, bool DQ>
cudaError_t launch_bwd_main(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                            int bh, int sq, int sk, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    using C = WgBwdCfg<D>;
    cudaError_t e = allow_smem(flash_bwd_wg_kernel<D, DQ>, C::kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((sk + C::BK - 1) / C::BK, bh);
    flash_bwd_wg_kernel<D, DQ><<<grid, C::NT, C::kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, sk, causal);
  } else {
    using C = BwdCfg<T, D>;
    cudaError_t e = allow_smem(flash_bwd_kernel<T, D, DQ>, C::kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((sk + C::BK - 1) / C::BK, bh);
    flash_bwd_kernel<T, D, DQ><<<grid, kThreads, C::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<T*>(dk),
        static_cast<T*>(dv), sq, sk, causal);
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
                       void* dv, int bh, int sq, int sk, int causal, float scale,
                       cudaStream_t stream) {
  cudaError_t e = launch_bwd_main<T, D, true>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq,
                                                sk, causal, stream);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)bh * sq * D;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  if constexpr (std::is_same<T, bf16>::value)
    dq_finalize_wg_kernel<D><<<blocks, 256, 0, stream>>>(static_cast<const float*>(dq_acc),
                                                         static_cast<bf16*>(dq), bh, sq, scale);
  else
    dq_finalize_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(dq_acc),
                                                      static_cast<T*>(dq), n, scale);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh,
                           int sq, int sk, int causal, cudaStream_t stream) {
  return launch_bwd_main<T, D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, sq, sk,
                                      causal, stream);
}

// bf16 on wgmma, the K/V ring filled by TMA; f32 on the scalar path of
// mma_common.cuh
template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                          int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    using C = WgDqCfg<D>;
    CUtensorMap maps[4] = {};
    const void* base[4] = {q, dout, k, v};
    for (int i = 0; i < 4; ++i) {
      const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)(i < 2 ? sq : sk), (cuuint64_t)bh};
      const cuuint32_t box[3] = {64, (cuuint32_t)C::BQ, 1};
      const cudaError_t e = tma_map_bf16(&maps[i], base[i], 3, dims, box);
      if (e != cudaSuccess) return e;
    }
    cudaError_t e = allow_smem(flash_bwd_dq_wg_kernel<D>, C::kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
    flash_bwd_dq_wg_kernel<D><<<grid, 384, C::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), sq, sk, causal, scale);
  } else {
    using C = DqCfg<T, D>;
    cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, C::kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, causal, scale);
  }
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
      e = launch_fwd<64>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 0 && d == 128)
      e = launch_fwd<128>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 1 && d == 64)
      e = launch_fwd_wg<64>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else if (dtype == 1 && d == 128)
      e = launch_fwd_wg<128>(q, k, v, o, lse, bh, sq, sk, kv_len, causal, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// dq_acc is bh * ceil(sq / 64) * 64 * d f32 and must be zero on entry; dq,
// dk, dv share q's dtype. Same guarantees as flash_fwd, with sk >= 1.
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

// The split backward's passes: flash_bwd's guarantees and arguments, less
// dq_acc. flash_bwd_dkv writes dk and dv; flash_bwd_dq writes dq.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh > 0 && sq > 0) {
    cudaError_t e;
    if (dtype == 0 && d == 64)
      e = launch_bwd_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, s);
    else if (dtype == 0 && d == 128)
      e = launch_bwd_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, s);
    else if (dtype == 1 && d == 64)
      e = launch_bwd_dkv<bf16, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, s);
    else if (dtype == 1 && d == 128)
      e = launch_bwd_dkv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                            int d, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh > 0 && sq > 0) {
    cudaError_t e;
    if (dtype == 0 && d == 64)
      e = launch_bwd_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, s);
    else if (dtype == 0 && d == 128)
      e = launch_bwd_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, s);
    else if (dtype == 1 && d == 64)
      e = launch_bwd_dq<bf16, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, s);
    else if (dtype == 1 && d == 128)
      e = launch_bwd_dq<bf16, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal, scale, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
