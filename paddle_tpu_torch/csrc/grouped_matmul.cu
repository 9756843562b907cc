// Grouped matmul of the dropless MoE expert FFN for Hopper (sm_90a).
//
// Replaces three TPU kernels of paddle_tpu/ops/grouped_matmul.py:
//   gmm_fwd <- _gmm_fwd_call (kernel _gmm_kernel):    out[t] = lhs[t] @ rhs[e(t)]
//   gmm_dx  <- _gmm_dx_call  (kernel _gmm_dx_kernel): dlhs[t] = dout[t] @ rhs[e(t)]^T
//   gmm_dw  <- _gmm_dw_call  (kernel _gmm_dw_kernel): drhs[e] = sum_{t of e} lhs[t]^T @ dout[t]
// where t runs over 128-row tiles of an expert-sorted token buffer whose
// groups start on tile boundaries, e(t) = tile_expert[t], and the flat
// per-tile schedule (tile_expert, live) is read from device memory, so
// nothing waits on the host. Dead tiles (live == 0) write zeros in the
// forward and dX; an expert with no live tile gets an exactly zero dW.
//
// What bounds them on this card: bytes, at the MoE slice's shapes. The
// forward at M = 20480 rows (16384 routed), K = 1024, N = 512 moves about
// 90 MB (0.027 ms at 3.35 TB/s) for 1.7e10 operations (0.017 ms at
// 989 TFLOP/s); dX and dW are alike.
//
// Design (simple first, not the TPU's). Every CTA of 4 warps computes one
// 128 x 64 output block in f32 registers (each warp 32 rows: two m16 tiles
// by eight n8 tiles of mma.sync m16n8k16, bf16 in, f32 accumulation). The
// contraction runs in chunks of 64 bytes of K (32 bf16, 16 f32) staged
// through shared memory by 16-byte cp.async in a two-stage pipeline;
// operands whose contraction index is strided are read with ldmatrix.trans,
// so nothing is ever stored transposed, and rows are padded by 16 bytes to
// keep ldmatrix free of bank conflicts. f32 runs the same block by scalar
// FMAs in the same register layout (no TF32). The warp-level helpers are
// csrc/mma_common.cuh's. No wgmma, TMA or persistent schedule yet.
//
//   forward: grid (N / 64, tiles); the 128-row tile of lhs against 64
//            columns of rhs[e]; the column blocks of one tile are
//            neighbours in launch order, so lhs is read from device memory
//            about once and rhs[e] stays in L2.
//   dX:      grid (K / 64, tiles); dout's tile against 64 rows of rhs[e]
//            (contraction over N, contiguous in both).
//   dW:      grid (N / 64, K / 128, E). The TPU carries a VMEM accumulator
//            across a sequential grid between a group's first and last
//            flags; CTAs run in no order, so each CTA owns one (expert, K
//            block, N block), finds its expert's run of live tiles in the
//            schedule (groups are contiguous by construction) and sums
//            them in tile order in registers: the same order every run, no
//            atomics.
//
// The caller guarantees contiguous operands on 16-byte aligned storage, K a
// multiple of 128, N of 64, int32 schedule arrays of n_tiles entries. The
// kernels allocate nothing and do not synchronise; they launch on the
// caller's stream.
#include "mma_common.cuh"

namespace {

constexpr int kTileRows = 128;  // rows of a schedule tile
constexpr int BM = 128, BN = 64;  // CTA output block
constexpr int MT = 2, NT = 8;     // a warp's m16 and n8 tiles (32 x 64)

// Shared-memory layout of one pipeline stage: an A slice and a B slice of
// one contraction chunk of BKK elements.
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T>
struct Cfg {
  static constexpr int BKK = 64 / sizeof(T);
  static constexpr int PAD = 16 / sizeof(T);
  // A(m, kk): [BM][BKK + PAD] when kk is contiguous, else [BKK][BM + PAD]
  static constexpr int A_ELEMS = cmax(BM * (BKK + PAD), BKK * (BM + PAD));
  // B(kk, n): [BN][BKK + PAD] when kk is contiguous, else [BKK][BN + PAD]
  static constexpr int B_ELEMS = cmax(BN * (BKK + PAD), BKK * (BN + PAD));
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(T);  // two stages
};

// Starts copying an R x C block (C contiguous, rows gld apart in global
// memory) into shared memory with rows LD apart, 16 bytes per cp.async.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void copy_block(T* s, const T* g, size_t gld) {
  constexpr int VEC = 16 / sizeof(T), VPR = C / VEC;
  for (int i = threadIdx.x; i < R * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    cp_async16(s + r * LD + c, g + r * gld + c);
  }
}

// ---------------------------------------------------------------------------
// Warp tile product: c[i][j] += A (rows 16 i .. 16 i + 15, K) * B (K, cols
// 8 j .. 8 j + 7), in the register layout of mma.m16n8k16's accumulator:
// lane (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t and
// 2t + 1 of each tile.
// A_KC: A(m, k) = a[m * lda + k] (k contiguous), else a[k * lda + m].
// B_KC: B(k, n) = b[n * ldb + k] (k contiguous), else b[k * ldb + n].
// ---------------------------------------------------------------------------

template <bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mm_32x64(float (&c)[MT][NT][4], const bf16* a, int lda,
                                        const bf16* b, int ldb, int K) {
  const int r = threadIdx.x & 31, r8 = r & 7, h1 = (r >> 3) & 1, h2 = r >> 4;
  const bf16* pa = A_KC ? a + (r8 + h1 * 8) * lda + h2 * 8 : a + (r8 + h2 * 8) * lda + h1 * 8;
  const bf16* pb = B_KC ? b + (r8 + h2 * 8) * ldb + h1 * 8 : b + (r8 + h1 * 8) * ldb + h2 * 8;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4<!A_KC>(af[i], pa + (A_KC ? i * 16 * lda + k0 : k0 * lda + i * 16));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldsm_x4<!B_KC>(bq, pb + (B_KC ? j * 8 * ldb + k0 : k0 * ldb + j * 8));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(c[i][j], af[i], bq[0], bq[1]);
        mma_bf16(c[i][j + 1], af[i], bq[2], bq[3]);
      }
    }
  }
}

// f32: the same tile by scalar FMAs (TF32 would round the inputs)
template <bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mm_32x64(float (&c)[MT][NT][4], const float* a, int lda,
                                        const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    float b0[NT], b1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b0[j] = ld_el<B_KC>(b, ldb, 8 * j + 2 * t, k);
      b1[j] = ld_el<B_KC>(b, ldb, 8 * j + 2 * t + 1, k);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float a0 = ld_el<A_KC>(a, lda, 16 * i + g, k);
      const float a1 = ld_el<A_KC>(a, lda, 16 * i + g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        c[i][j][0] = fmaf(a0, b0[j], c[i][j][0]);
        c[i][j][1] = fmaf(a0, b1[j], c[i][j][1]);
        c[i][j][2] = fmaf(a1, b0[j], c[i][j][2]);
        c[i][j][3] = fmaf(a1, b1[j], c[i][j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Block product: c += sum over nchunks contraction chunks of A_j (BM x BKK)
// B_j (BKK x BN), where src(j, a_j, b_j) gives chunk j's first elements in
// global memory (A(m, kk) and B(kk, n) laid out as A_KC / B_KC say, with
// row strides lda and ldb). Two-stage pipeline: chunk j + 1 is in flight
// while chunk j is multiplied; one barrier per chunk.
// ---------------------------------------------------------------------------
template <typename T, bool A_KC, bool B_KC, typename Src>
__device__ __forceinline__ void block_mm(float (&c)[MT][NT][4], T* smem, int nchunks, size_t lda,
                                         size_t ldb, Src src) {
  using C = Cfg<T>;
  constexpr int BKK = C::BKK, PAD = C::PAD;
  constexpr int LDA = A_KC ? BKK + PAD : BM + PAD;
  constexpr int LDB = B_KC ? BKK + PAD : BN + PAD;
  auto load = [&](int j, int stage) {
    const T* a;
    const T* b;
    src(j, a, b);
    T* sa = smem + stage * C::STAGE;
    T* sb = sa + C::A_ELEMS;
    if constexpr (A_KC)
      copy_block<T, BM, BKK, LDA>(sa, a, lda);
    else
      copy_block<T, BKK, BM, LDA>(sa, a, lda);
    if constexpr (B_KC)
      copy_block<T, BN, BKK, LDB>(sb, b, ldb);
    else
      copy_block<T, BKK, BN, LDB>(sb, b, ldb);
    cp_commit();
  };
  const int warp = threadIdx.x >> 5;
  if (nchunks > 0) load(0, 0);
  for (int j = 0; j < nchunks; ++j) {
    cp_wait<0>();
    // chunk j has landed for every thread, and every warp is done with
    // chunk j - 1, whose stage the next copy refills
    __syncthreads();
    if (j + 1 < nchunks) load(j + 1, (j + 1) & 1);
    const T* sa = smem + (j & 1) * C::STAGE;
    const T* sb = sa + C::A_ELEMS;
    const T* aw = A_KC ? sa + warp * 32 * LDA : sa + warp * 32;
    warp_mm_32x64<A_KC, B_KC>(c, aw, LDA, sb, LDB, BKK);
  }
}

template <typename T>
__device__ __forceinline__ void store_block(const float (&c)[MT][NT][4], T* o, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = warp * 32 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
      st_pair(o + (size_t)r0 * ldo + col, c[i][j][0], c[i][j][1]);
      st_pair(o + (size_t)(r0 + 8) * ldo + col, c[i][j][2], c[i][j][3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_block(T* o, int ldo) {
  for (int i = threadIdx.x; i < BM * BN / 2; i += kThreads) {
    const int r = i / (BN / 2), col = (i % (BN / 2)) * 2;
    st_pair(o + (size_t)r * ldo + col, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// lhs [n_tiles * 128, K], rhs [E, K, N] -> out [n_tiles * 128, N]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                   const int* __restrict__ tile_expert, const int* __restrict__ live,
                   T* __restrict__ out, int K, int N) {
  __shared__ __align__(16) unsigned char smem_raw[Cfg<T>::SMEM_BYTES];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int BKK = Cfg<T>::BKK;
  const int nb = blockIdx.x, t = blockIdx.y;
  T* o = out + (size_t)t * kTileRows * N + nb * BN;
  if (!live[t]) {
    zero_block(o, N);
    return;
  }
  const T* a = lhs + (size_t)t * kTileRows * K;                 // A(m, kk) = a[m K + kk]
  const T* b = rhs + (size_t)tile_expert[t] * K * N + nb * BN;  // B(kk, n) = b[kk N + n]
  float c[MT][NT][4] = {};
  block_mm<T, true, false>(c, smem, K / BKK, K, N, [&](int j, const T*& aj, const T*& bj) {
    aj = a + j * BKK;
    bj = b + (size_t)j * BKK * N;
  });
  store_block(c, o, N);
}

// dout [n_tiles * 128, N], rhs [E, K, N] -> dlhs [n_tiles * 128, K]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_dx_kernel(const T* __restrict__ dout, const T* __restrict__ rhs,
                  const int* __restrict__ tile_expert, const int* __restrict__ live,
                  T* __restrict__ dlhs, int K, int N) {
  __shared__ __align__(16) unsigned char smem_raw[Cfg<T>::SMEM_BYTES];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int BKK = Cfg<T>::BKK;
  const int kb = blockIdx.x, t = blockIdx.y;
  T* o = dlhs + (size_t)t * kTileRows * K + kb * BN;
  if (!live[t]) {
    zero_block(o, K);
    return;
  }
  const T* a = dout + (size_t)t * kTileRows * N;  // A(m, n) = a[m N + n]
  // B(n, col) = rhs[e][(kb BN + col) N + n] = b[col N + n]: n contiguous
  const T* b = rhs + (size_t)tile_expert[t] * K * N + (size_t)kb * BN * N;
  float c[MT][NT][4] = {};
  block_mm<T, true, true>(c, smem, N / BKK, N, N, [&](int j, const T*& aj, const T*& bj) {
    aj = a + j * BKK;
    bj = b + j * BKK;
  });
  store_block(c, o, K);
}

// lhs [n_tiles * 128, K], dout [n_tiles * 128, N] -> drhs [E, K, N]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                  const int* __restrict__ tile_expert, const int* __restrict__ live,
                  T* __restrict__ drhs, int n_tiles, int K, int N) {
  __shared__ __align__(16) unsigned char smem_raw[Cfg<T>::SMEM_BYTES];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_first, s_count;
  constexpr int BKK = Cfg<T>::BKK, CPT = kTileRows / BKK;  // chunks per tile
  const int nb = blockIdx.x, kb = blockIdx.y, e = blockIdx.z;
  // this expert's live tiles: one contiguous run [first, first + count)
  if (threadIdx.x == 0) {
    s_first = n_tiles;
    s_count = 0;
  }
  __syncthreads();
  int mine_first = n_tiles, mine_count = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads)
    if (live[t] && tile_expert[t] == e) {
      mine_first = min(mine_first, t);
      ++mine_count;
    }
  if (mine_count) {
    atomicMin(&s_first, mine_first);
    atomicAdd(&s_count, mine_count);
  }
  __syncthreads();
  const int first = s_first, count = s_count;
  T* o = drhs + (size_t)e * K * N + (size_t)kb * BM * N + nb * BN;
  if (count == 0) {
    zero_block(o, N);
    return;
  }
  // A(k, r) = lhs[r K + kb BM + k], B(r, n) = dout[r N + nb BN + n]: the
  // contraction index r (a row of the buffer) is strided in both
  const T* a = lhs + (size_t)first * kTileRows * K + kb * BM;
  const T* b = dout + (size_t)first * kTileRows * N + nb * BN;
  float c[MT][NT][4] = {};
  block_mm<T, false, false>(c, smem, count * CPT, K, N, [&](int j, const T*& aj, const T*& bj) {
    const size_t r0 = (size_t)j * BKK;  // rows past the run's first row
    aj = a + r0 * K;
    bj = b + r0 * N;
  });
  store_block(c, o, N);
}

bool bad_shape(int n_tiles, int k, int n) {
  return n_tiles < 0 || n_tiles > 65535 || k <= 0 || n <= 0 || k % BM || n % BN;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand and the output share it).
// tile_expert and live are int32 [n_tiles]; rows = n_tiles * 128. K must be
// a multiple of 128 and N of 64.
extern "C" int gmm_fwd(const void* lhs, const void* rhs, const void* tile_expert, const void* live,
                       void* out, int n_tiles, int k, int n, int dtype, void* stream) {
  if (bad_shape(n_tiles, k, n)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / BN, n_tiles);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs),
                                                    static_cast<const float*>(rhs), te, lv,
                                                    static_cast<float*>(out), k, n);
  else if (dtype == 1)
    gmm_fwd_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(lhs),
                                                   static_cast<const bf16*>(rhs), te, lv,
                                                   static_cast<bf16*>(out), k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dout [rows, n], rhs [E, k, n] -> dlhs [rows, k]; same contract.
extern "C" int gmm_dx(const void* dout, const void* rhs, const void* tile_expert, const void* live,
                      void* dlhs, int n_tiles, int k, int n, int dtype, void* stream) {
  if (bad_shape(n_tiles, k, n)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(k / BN, n_tiles);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_dx_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(dout),
                                                   static_cast<const float*>(rhs), te, lv,
                                                   static_cast<float*>(dlhs), k, n);
  else if (dtype == 1)
    gmm_dx_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(dout),
                                                  static_cast<const bf16*>(rhs), te, lv,
                                                  static_cast<bf16*>(dlhs), k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// lhs [rows, k], dout [rows, n] -> drhs [num_experts, k, n]; same contract,
// and every expert's live tiles form one contiguous run of the schedule.
extern "C" int gmm_dw(const void* lhs, const void* dout, const void* tile_expert, const void* live,
                      void* drhs, int n_tiles, int num_experts, int k, int n, int dtype,
                      void* stream) {
  if (bad_shape(n_tiles, k, n) || num_experts < 1 || num_experts > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / BN, k / BM, num_experts);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_dw_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs),
                                                   static_cast<const float*>(dout), te, lv,
                                                   static_cast<float*>(drhs), n_tiles, k, n);
  else if (dtype == 1)
    gmm_dw_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(lhs),
                                                  static_cast<const bf16*>(dout), te, lv,
                                                  static_cast<bf16*>(drhs), n_tiles, k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
