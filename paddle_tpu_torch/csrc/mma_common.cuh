// Warp-level helpers shared by the port's tensor-core kernels for Hopper
// (flash_attention.cu, flash_varlen.cu, grouped_matmul.cu).
//
// Every kernel that includes this header runs CTAs of kWarps = 4 warps.
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulation) on tiles in
// shared memory, fed by ldmatrix (.trans where the contraction index is
// strided, so no operand is ever stored transposed); for f32 inputs the
// same warp tile is computed by scalar FMAs in the same register layout
// (no TF32, which would round the inputs). Global tiles arrive by 16-byte
// cp.async. The accumulator layout of m16n8k16: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1 of each
// 16 x 8 tile.
//
// Everything here is in an anonymous namespace: each source is its own
// translation unit and its own library.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// store two neighbouring elements (even offset) rounded to T
__device__ __forceinline__ void st_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void st_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// 16-byte cp.async of global g to shared s; with src_bytes 0 the 16
// bytes are zero-filled and g is not read
__device__ __forceinline__ void cp_async16(void* s, const void* g, int src_bytes = 16) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(g),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying rows [r0, r0 + ROWS) of a row-major matrix of n rows of
// D elements, rows gld elements apart in global memory, into s[ROWS][LD]
// with 16-byte cp.async; rows at or past n are zero-filled. The copies
// land after cp_commit() and cp_wait<N>().
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* s, const T* g, int r0, int n, size_t gld = D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const bool live = r0 + r < n;
    cp_async16(s + r * LD + c, live ? g + (size_t)(r0 + r) * gld + c : g, live ? 16 : 0);
  }
}

// ldmatrix: four 8x8 b16 matrices from shared memory; lane r gives the
// address of row (r % 8) of matrix r / 8 (16 contiguous bytes). Lane
// (g, t) receives, in register i, elements (g, 2t) and (g, 2t + 1) of
// matrix i, or with .trans elements (2t, g) and (2t + 1, g).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c += A (16 x 16, fragment a) * B (16 x 8, fragment b0 b1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element (row, k) of an f32 operand: KC, k contiguous (p[row * ld + k]),
// else p[k * ld + row]
template <bool KC>
__device__ __forceinline__ float ld_el(const float* p, int ld, int row, int k) {
  return KC ? p[row * ld + k] : p[k * ld + row];
}

// ---------------------------------------------------------------------------
// Warp tile product over 16 rows: c[j] += A (16 x K) * B (K x 8) for the
// n-tiles j < NT.
// A_KC: A(m, k) = a[m * lda + k] (k contiguous), else a[k * lda + m].
// B_KC: B(k, n) = b[n * ldb + k] (k contiguous), else b[k * ldb + n].
// One ldmatrix.x4 per k-step brings A's fragment (rows 0-7 / 8-15 by k
// halves), one per pair of n-tiles brings B's. Every row address must be
// 16-byte aligned: leading dimensions and offsets are multiples of 8.
// ---------------------------------------------------------------------------
template <int NT, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const bf16* a, int lda,
                                        const bf16* b, int ldb, int K) {
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
  const int r = threadIdx.x & 31, r8 = r & 7, h1 = (r >> 3) & 1, h2 = r >> 4;
  const bf16* pa = A_KC ? a + (r8 + h1 * 8) * lda + h2 * 8 : a + (r8 + h2 * 8) * lda + h1 * 8;
  const bf16* pb = B_KC ? b + (r8 + h2 * 8) * ldb + h1 * 8 : b + (r8 + h1 * 8) * ldb + h2 * 8;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4<!A_KC>(af, pa + (A_KC ? k0 : k0 * lda));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldsm_x4<!B_KC>(bq, pb + (B_KC ? j * 8 * ldb + k0 : k0 * ldb + j * 8));
      mma_bf16(c[j], af, bq[0], bq[1]);
      mma_bf16(c[j + 1], af, bq[2], bq[3]);
    }
  }
}

// f32: the same tile by scalar FMAs
template <int NT, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* a, int lda,
                                        const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = ld_el<A_KC>(a, lda, g, k), a1 = ld_el<A_KC>(a, lda, g + 8, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = ld_el<B_KC>(b, ldb, 8 * j + 2 * t, k);
      const float b1 = ld_el<B_KC>(b, ldb, 8 * j + 2 * t + 1, k);
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// max and sum over the four lanes (t = 0..3) that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
