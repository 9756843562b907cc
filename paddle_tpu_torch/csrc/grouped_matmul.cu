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
// bf16 runs on wgmma, fed by TMA from a producer warpgroup:
//
//   forward, dX (gmm_fwd_wg_kernel, gmm_dx_wg_kernel): a work item is one
//            128-row schedule tile by one block of WgMmCfg::BNW output
//            columns; persistent CTAs of three warpgroups walk the items
//            (tile, block), block fastest, so the CTAs in flight share
//            their lhs / dout tiles and an expert's rhs in L2. One thread
//            of the producer warpgroup (registers handed to the consumers
//            by setmaxnreg, 40 against 232) loads 64-wide chunks of the
//            contraction by TMA (2-D maps, 128-byte swizzle) into a ring
//            of stages, running ahead from one item into the next while
//            the consumers store; each consumer warpgroup takes 64 rows of
//            the tile and stores its bf16 rows through shared memory in
//            16-byte pieces. A is the tile (contraction contiguous:
//            K-major); B is rhs[e] viewed as [E K, N]: the forward's B
//            (K x N, N contiguous) is MN-major, dX's (N x K, N contiguous)
//            K-major. The sum over the contraction (at most 64 k16 steps
//            at the MoE shapes) stays in the accumulator: its drift
//            against f64 exceeds the plain version's by under 1e-6 there.
//            A dead tile's items load nothing and store zeros.
//   dW (gmm_dw_wg_kernel): a CTA of three warpgroups owns 128 rows of K
//            and two neighbouring 128-column blocks of N in turn (the last
//            block of N = 192 is 64 wide), grid (ceil(N / 256), K / 128,
//            E); the producer loads 64-row chunks of lhs [64 x 128] and
//            dout [64 x 128] into a ring of four stages; each consumer
//            warpgroup takes 64 rows of K and computes lhs^T dout with
//            m64n128k16, both operands MN-major. Each 128-row schedule
//            tile is summed in a zeroed accumulator and added to f32
//            register sums, so an expert that holds all rows does not
//            drift.
//
// f32 (the CPU-matched checks) runs scalar FMAs, no TF32: every CTA of 4
// warps computes one 128 x 64 output block in f32 registers (each warp 32
// rows, in mma.m16n8k16's accumulator layout), the contraction in chunks
// of 16 staged through shared memory by 16-byte cp.async in a two-stage
// pipeline. forward: grid (N / 64, tiles); dX: grid (K / 64, tiles); dW:
// grid (N / 64, K / 128, E), each CTA finding its expert's run of live
// tiles in the schedule (groups are contiguous by construction) and
// summing them in tile order: the same order every run, no atomics.
//
// The caller guarantees contiguous operands on 16-byte aligned storage, K a
// multiple of 128, N of 64, int32 schedule arrays of n_tiles entries whose
// experts are below num_experts. The kernels allocate nothing and do not
// synchronise; they launch on the caller's stream.
#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTileRows = 128;  // rows of a schedule tile
constexpr int BM = 128, BN = 64;  // f32 CTA output block
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
// Warp tile product (f32): c[i][j] += A (rows 16 i .. 16 i + 15, K) * B (K,
// cols 8 j .. 8 j + 7) by scalar FMAs (TF32 would round the inputs), in
// the register layout of mma.m16n8k16's accumulator: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1 of each tile.
// A_KC: A(m, k) = a[m * lda + k] (k contiguous), else a[k * lda + m].
// B_KC: B(k, n) = b[n * ldb + k] (k contiguous), else b[k * ldb + n].
// ---------------------------------------------------------------------------

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
// f32 kernels
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

// ---------------------------------------------------------------------------
// forward and dX for bf16 on wgmma
// ---------------------------------------------------------------------------

struct WgMmCfg {
  // a work item: one schedule tile by BNW output columns (one m64n128k16
  // product a warpgroup and k16 step), contracted in chunks of BC through
  // NS stages
  static constexpr int BNW = 128, BC = 64, NS = 4;
  static constexpr int A_BYTES = kTileRows * BC * 2, B_BYTES = BNW * BC * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_LD = BNW * 2 + 16;  // a staged output row, padded
  static constexpr int OFF_OUT = NS * STAGE, OFF_BAR = OFF_OUT + 2 * 64 * OUT_LD;
  // barriers (NS full, NS empty), and slack to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * 2 * NS + 1024;
  static_assert(kSmem <= 232448, "WgMmCfg: more shared memory than a CTA has");
};

// The consumers of one live item: warpgroup wg owns rows 64 wg .. 64 wg +
// 63 of the tile and every column of the block; the item's chunks are the
// ring's c0 .. c0 + nch - 1. Chunk j's products are issued before chunk
// j - 1's stage is released.
template <bool B_MN>
__device__ __forceinline__ void mm_consume(unsigned char* sm, uint64_t* full, uint64_t* empty,
                                           int c0, int nch, float (&acc)[64]) {
  using C = WgMmCfg;
  const int wg = threadIdx.x >> 7;
  for (int j = 0; j < nch; ++j) {
    const int c = c0 + j, st = c % C::NS;
    mbar_wait(&full[st], (c / C::NS) & 1);
    const uint32_t s0 = smem_u32(sm + st * C::STAGE), a = s0 + wg * 8192, b = s0 + C::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B: the forward's in two 64-column blocks of 64 rows (a k16 step is
      // 16 rows: 2048 bytes), dX's in one block of 128 rows (a k16 step is
      // 32 bytes along the row)
      const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
      if constexpr (B_MN)
        wgmma_ss<0, 1, 128>(acc, da, sw128_desc(b + kk * 2048, 8192, 1024), j | kk);
      else
        wgmma_ss<0, 0, 128>(acc, da, sw128_desc(b + kk * 32, 16, 1024), j | kk);
    }
    wg_commit();
    if (j > 0) {
      wg_wait<1>();  // chunk j - 1 is read
      mbar_arrive(&empty[(c - 1) % C::NS]);
    }
  }
  wg_wait<0>();
  mbar_arrive(&empty[(c0 + nch - 1) % C::NS]);
  reg_fence(acc);
}

// The item's nw columns of this warpgroup's 64 accumulator rows, rounded
// to bf16 (or zeros with live false), through shared memory: warpgroup wg
// writes them into its own staging rows (padded by 16 bytes: neither the
// pair writes nor the 16-byte reads conflict), then stores 16-byte
// pieces, a row's 256 bytes by 16 neighbouring threads (4-byte pairs
// stored straight from the accumulator took 1.2-1.4x as long:
// tools/gmm_choices.py). ow is row 64 wg of the tile at the block's first
// column.
__device__ __forceinline__ void mm_store(const float (&acc)[64], bool live, unsigned char* stage,
                                         bf16* ow, int ldo, int nw) {
  using C = WgMmCfg;
  const int tw = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int r = 16 * (tw >> 5) + ((tw & 31) >> 2), t = tw & 3;
  wg_bar(1 + wg);  // the last item's copy-out has read the staging rows
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float* v = acc + 4 * j;
    unsigned char* p = stage + r * C::OUT_LD + (8 * j + 2 * t) * 2;
    *reinterpret_cast<uint32_t*>(p) = live ? pack_bf16(v[0], v[1]) : 0u;
    *reinterpret_cast<uint32_t*>(p + 8 * C::OUT_LD) = live ? pack_bf16(v[2], v[3]) : 0u;
  }
  wg_bar(1 + wg);
  const int cpr = nw / 8;  // 16-byte pieces a row
  for (int i = tw; i < 64 * cpr; i += 128) {
    const int rr = i / cpr, ch = i % cpr;
    *reinterpret_cast<uint4*>(ow + (size_t)rr * ldo + 8 * ch) =
        *reinterpret_cast<const uint4*>(stage + rr * C::OUT_LD + 16 * ch);
  }
}

// out[t] (128 x no) = A[t] (128 x kc) B_e (kc x no) for every tile t of
// n_tiles, e = tile_expert[t]: am maps A as [rows, kc] with boxes of 64
// columns by 128 rows; bm maps rhs as [E K, N] with boxes of 64 columns by
// 64 rows (the forward: B_MN, kc = K, no = N) or by 128 rows (dX: kc = N,
// no = K). 384 threads: warpgroup 2 is the producer, 0 and 1 the
// consumers; CTA b takes items b, b + gridDim.x, ...
template <bool B_MN>
__device__ __forceinline__ void gmm_wg(const CUtensorMap* am, const CUtensorMap* bm,
                                       const int* __restrict__ tile_expert,
                                       const int* __restrict__ live, bf16* __restrict__ out,
                                       int n_tiles, int kc, int no) {
  using C = WgMmCfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + C::NS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nblk = (no + C::BNW - 1) / C::BNW, items = n_tiles * nblk, nch = kc / C::BC;
  if (tid == 0) {
    for (int st = 0; st < C::NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int c = 0;  // the ring's chunk count
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int t = it / nblk, n0 = (it % nblk) * C::BNW;
        if (!live[t]) continue;
        const int nw = min(C::BNW, no - n0), row = t * kTileRows;
        const int brow = tile_expert[t] * (B_MN ? kc : no);  // rhs[e]'s first row
        for (int j = 0; j < nch; ++j, ++c) {
          const int st = c % C::NS;
          if (c >= C::NS) mbar_wait(&empty[st], ((c / C::NS) & 1) ^ 1);
          unsigned char* a = sm + st * C::STAGE;
          unsigned char* b = a + C::A_BYTES;
          // only the boxes that hold the block's columns: nw / 64 blocks of
          // 64 columns (forward), or one of 128 rows (dX: K is a multiple
          // of 128, so nw is 128)
          mbar_expect_tx(&full[st], C::A_BYTES + nw * C::BC * 2);
          tma_load_2d(a, am, &full[st], j * C::BC, row);
          if constexpr (B_MN) {
            for (int x = 0; x < nw / 64; ++x)
              tma_load_2d(b + x * 8192, bm, &full[st], n0 + 64 * x, brow + j * C::BC);
          } else {
            tma_load_2d(b, bm, &full[st], j * C::BC, brow + n0);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  int c = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it / nblk, n0 = (it % nblk) * C::BNW;
    const int nw = min(C::BNW, no - n0);
    const bool lv = live[t] != 0;
    // A block narrower than 128 columns (the forward's last at N = 192)
    // multiplies what its stage held before in the columns it did not
    // load; those columns are not stored.
    float acc[64];
    if (lv) {
      mm_consume<B_MN>(sm, full, empty, c, nch, acc);
      c += nch;
    }
    bf16* o = out + (size_t)t * kTileRows * no + n0;
    mm_store(acc, lv, sm + C::OFF_OUT + wg * 64 * C::OUT_LD, o + (size_t)64 * wg * no, no, nw);
  }
}

__global__ void __launch_bounds__(384, 1)
    gmm_fwd_wg_kernel(const __grid_constant__ CUtensorMap lm, const __grid_constant__ CUtensorMap rm,
                      const int* __restrict__ tile_expert, const int* __restrict__ live,
                      bf16* __restrict__ out, int n_tiles, int k, int n) {
  gmm_wg<true>(&lm, &rm, tile_expert, live, out, n_tiles, k, n);
}

__global__ void __launch_bounds__(384, 1)
    gmm_dx_wg_kernel(const __grid_constant__ CUtensorMap dm, const __grid_constant__ CUtensorMap rm,
                     const int* __restrict__ tile_expert, const int* __restrict__ live,
                     bf16* __restrict__ dlhs, int n_tiles, int k, int n) {
  gmm_wg<false>(&dm, &rm, tile_expert, live, dlhs, n_tiles, n, k);
}

// a [rows, kc] and rhs [E, K, N] (bf16) -> out [rows, no]: the forward
// (B_MN: kc = K, no = N) or dX (kc = N, no = K)
template <bool B_MN>
cudaError_t launch_wg(const void* a, const void* rhs, const int* te, const int* lv, void* out,
                      int n_tiles, int num_experts, int k, int n, cudaStream_t s) {
  using C = WgMmCfg;
  const int kc = B_MN ? k : n, no = B_MN ? n : k;
  CUtensorMap am, bm;
  const cuuint64_t ad[2] = {(cuuint64_t)kc, (cuuint64_t)n_tiles * kTileRows};
  const cuuint64_t bd[2] = {(cuuint64_t)n, (cuuint64_t)num_experts * k};
  const cuuint32_t abox[2] = {64, kTileRows}, bbox[2] = {64, B_MN ? 64u : 128u};
  const auto kernel = B_MN ? gmm_fwd_wg_kernel : gmm_dx_wg_kernel;
  int dev = 0, sms = 0;
  cudaError_t e = tma_map_bf16(&am, a, 2, ad, abox);
  if (e == cudaSuccess) e = tma_map_bf16(&bm, rhs, 2, bd, bbox);
  if (e == cudaSuccess) e = allow_smem(kernel, C::kSmem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int items = n_tiles * ((no + C::BNW - 1) / C::BNW);
  kernel<<<min(items, sms), 384, C::kSmem, s>>>(am, bm, te, lv, static_cast<bf16*>(out),
                                                n_tiles, k, n);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// dW for bf16 on wgmma
// ---------------------------------------------------------------------------

struct WgDwCfg {
  // a block of the output: 128 rows of K by up to 128 columns of N; a CTA
  // takes NBPC neighbouring blocks of N in turn. The contraction runs in
  // chunks of 64 buffer rows through NS stages.
  static constexpr int BMK = 128, BNW = 128, BR = 64, NS = 4, NBPC = 2;
  static constexpr int A_BYTES = BR * BMK * 2, B_BYTES = BR * BNW * 2;  // lhs, dout chunk
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OFF_BAR = NS * STAGE;
  // barriers (NS full, NS empty), and slack to align the base to 1024 bytes
  static constexpr size_t kSmem = OFF_BAR + 8 * 2 * NS + 1024;
};

// The consumers of gmm_dw_wg_kernel for one output block: warpgroup wg
// owns K rows 64 wg .. of it and all NW columns; its chunks are the ring's
// c0 .. c0 + 2 ntiles. Each schedule tile (two chunks) is summed in a
// zeroed accumulator, then added to the f32 sums with IEEE adds, so an
// expert that holds every row does not drift; the tiles come in tile
// order, so the bits are the same on every run.
template <int NW>
__device__ __forceinline__ void dw_consume(unsigned char* sm, uint64_t* full, uint64_t* empty,
                                           int c0, int ntiles, bf16* o, int N) {
  using C = WgDwCfg;
  constexpr int R = NW / 2;  // accumulator registers
  const int tid = threadIdx.x, wg = tid >> 7, wiw = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float sum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] = 0.f;
  for (int tl = 0; tl < ntiles; ++tl) {
    float acc[R];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + 2 * tl + half, st = c % C::NS;
      mbar_wait(&full[st], (c / C::NS) & 1);
      // A = the lhs chunk transposed (K contiguous: MN-major), B = the dout
      // chunk (N contiguous: MN-major); 16 buffer rows a step
      const uint32_t a = smem_u32(sm + st * C::STAGE), b = a + C::A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1, NW>(acc, sw128_desc(a + wg * 8192 + kk * 2048, 8192, 1024),
                           sw128_desc(b + kk * 2048, 8192, 1024), half | kk);
      wg_commit();
    }
    wg_wait<1>();  // the tile's first chunk is read
    mbar_arrive(&empty[(c0 + 2 * tl) % C::NS]);
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(&empty[(c0 + 2 * tl + 1) % C::NS]);
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] += acc[i];
  }
  const int r0 = 64 * wg + 16 * wiw + g;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = 8 * j + 2 * t;
    st_pair(o + (size_t)r0 * N + col, sum[4 * j], sum[4 * j + 1]);
    st_pair(o + (size_t)(r0 + 8) * N + col, sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// lm maps lhs [n_tiles * 128, K] and dm dout [n_tiles * 128, N] (bf16)
// with boxes of 64 columns by 64 rows -> drhs [E, K, N] bf16. 384 threads:
// warpgroup 2 is the producer (one thread issues the TMA loads, running
// ahead from one output block into the next), 0 and 1 the consumers.
// Grid (ceil(ceil(N / 128) / NBPC), K / 128, E): the CTAs of one (expert,
// K block) are neighbours in launch order, and each scans the schedule
// for its expert's run once.
__global__ void __launch_bounds__(384, 1)
    gmm_dw_wg_kernel(const __grid_constant__ CUtensorMap lm, const __grid_constant__ CUtensorMap dm,
                     const int* __restrict__ tile_expert, const int* __restrict__ live,
                     bf16* __restrict__ drhs, int n_tiles, int K, int N) {
  using C = WgDwCfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + C::NS;
  __shared__ int s_first, s_count;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int kb = blockIdx.y, e = blockIdx.z;
  const int nb0 = blockIdx.x * C::NBPC;
  const int nbn = min(C::NBPC, (N + C::BNW - 1) / C::BNW - nb0);  // this CTA's blocks
  if (tid == 0) {
    s_first = n_tiles;
    s_count = 0;
    for (int st = 0; st < C::NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();
  // this expert's live tiles: one contiguous run [first, first + count)
  int mine_first = n_tiles, mine_count = 0;
  for (int t = tid; t < n_tiles; t += 384)
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
  bf16* ob = drhs + (size_t)e * K * N + (size_t)kb * C::BMK * N;
  if (count == 0) {
    const int n0 = nb0 * C::BNW, cols = min(nbn * C::BNW, N - n0);
    for (int i = tid; i < C::BMK * cols / 2; i += 384) {
      const int r = i / (cols / 2), col = (i % (cols / 2)) * 2;
      st_pair(ob + (size_t)r * N + n0 + col, 0.f, 0.f);
    }
    return;
  }
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int c = 0;  // the ring's chunk count
      for (int b = 0; b < nbn; ++b) {
        const int n0 = (nb0 + b) * C::BNW, nw = min(C::BNW, N - n0);
        for (int i = 0; i < 2 * count; ++i, ++c) {
          const int st = c % C::NS, r = first * kTileRows + i * C::BR;
          if (c >= C::NS) mbar_wait(&empty[st], ((c / C::NS) & 1) ^ 1);
          unsigned char* a = sm + st * C::STAGE;
          mbar_expect_tx(&full[st], C::A_BYTES + nw * C::BR * 2);
          tma_load_2d(a, &lm, &full[st], kb * C::BMK, r);
          tma_load_2d(a + 8192, &lm, &full[st], kb * C::BMK + 64, r);
          tma_load_2d(a + C::A_BYTES, &dm, &full[st], n0, r);
          if (nw == 128) tma_load_2d(a + C::A_BYTES + 8192, &dm, &full[st], n0 + 64, r);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  for (int b = 0; b < nbn; ++b) {
    const int n0 = (nb0 + b) * C::BNW;
    if (N - n0 >= 128)
      dw_consume<128>(sm, full, empty, 2 * count * b, count, ob + n0, N);
    else
      dw_consume<64>(sm, full, empty, 2 * count * b, count, ob + n0, N);
  }
}

cudaError_t launch_dw_wg(const void* lhs, const void* dout, const int* te, const int* lv,
                         void* drhs, int n_tiles, int num_experts, int k, int n,
                         cudaStream_t s) {
  using C = WgDwCfg;
  if (n_tiles == 0)  // no rows: every expert's dW is zero
    return cudaMemsetAsync(drhs, 0, (size_t)num_experts * k * n * sizeof(bf16), s);
  CUtensorMap lm, dm;
  const cuuint64_t rows = (cuuint64_t)n_tiles * kTileRows;
  const cuuint64_t ld[2] = {(cuuint64_t)k, rows}, dd[2] = {(cuuint64_t)n, rows};
  const cuuint32_t box[2] = {64, (cuuint32_t)C::BR};
  cudaError_t e = tma_map_bf16(&lm, lhs, 2, ld, box);
  if (e == cudaSuccess) e = tma_map_bf16(&dm, dout, 2, dd, box);
  if (e == cudaSuccess) e = allow_smem(gmm_dw_wg_kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  const int nblocks = (n + C::BNW - 1) / C::BNW;
  const dim3 grid((nblocks + C::NBPC - 1) / C::NBPC, k / C::BMK, num_experts);
  gmm_dw_wg_kernel<<<grid, 384, C::kSmem, s>>>(lm, dm, te, lv, static_cast<bf16*>(drhs), n_tiles,
                                               k, n);
  return cudaSuccess;
}

// rhs [E, k, n] rows must be addressable by TMA's int32 coordinates
bool bad_shape(int n_tiles, int num_experts, int k, int n) {
  return n_tiles < 0 || n_tiles > 65535 || k <= 0 || n <= 0 || k % BM || n % BN ||
         num_experts < 1 || num_experts > 65535 || (long long)num_experts * k > 0x7fffffff;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand and the output share it).
// tile_expert and live are int32 [n_tiles]; rows = n_tiles * 128; rhs
// [num_experts, k, n]. K must be a multiple of 128 and N of 64.
extern "C" int gmm_fwd(const void* lhs, const void* rhs, const void* tile_expert, const void* live,
                       void* out, int n_tiles, int num_experts, int k, int n, int dtype,
                       void* stream) {
  if (bad_shape(n_tiles, num_experts, k, n)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_fwd_kernel<float><<<dim3(n / BN, n_tiles), kThreads, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs), te, lv,
        static_cast<float*>(out), k, n);
  else if (dtype == 1) {
    const cudaError_t e = launch_wg<true>(lhs, rhs, te, lv, out, n_tiles, num_experts, k, n, s);
    if (e != cudaSuccess) return (int)e;
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dout [rows, n], rhs [num_experts, k, n] -> dlhs [rows, k]; same contract.
extern "C" int gmm_dx(const void* dout, const void* rhs, const void* tile_expert, const void* live,
                      void* dlhs, int n_tiles, int num_experts, int k, int n, int dtype,
                      void* stream) {
  if (bad_shape(n_tiles, num_experts, k, n)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_dx_kernel<float><<<dim3(k / BN, n_tiles), kThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(rhs), te, lv,
        static_cast<float*>(dlhs), k, n);
  else if (dtype == 1) {
    const cudaError_t e = launch_wg<false>(dout, rhs, te, lv, dlhs, n_tiles, num_experts, k, n, s);
    if (e != cudaSuccess) return (int)e;
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// lhs [rows, k], dout [rows, n] -> drhs [num_experts, k, n]; same contract,
// and every expert's live tiles form one contiguous run of the schedule.
extern "C" int gmm_dw(const void* lhs, const void* dout, const void* tile_expert, const void* live,
                      void* drhs, int n_tiles, int num_experts, int k, int n, int dtype,
                      void* stream) {
  if (bad_shape(n_tiles, num_experts, k, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 0)
    gmm_dw_kernel<float><<<dim3(n / BN, k / BM, num_experts), kThreads, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout), te, lv,
        static_cast<float*>(drhs), n_tiles, k, n);
  else if (dtype == 1) {
    const cudaError_t e = launch_dw_wg(lhs, dout, te, lv, drhs, n_tiles, num_experts, k, n, s);
    if (e != cudaSuccess) return (int)e;
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
