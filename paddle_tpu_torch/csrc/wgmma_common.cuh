// Hopper (sm_90a) helpers for the port's wgmma kernels (flash_attention.cu's
// fused backward for bf16): warpgroup products m64n64k16 (bf16 in, f32
// accumulation) on tiles in shared memory in the 128-byte swizzled
// layout, A from shared memory or from registers; 16-byte cp.async into
// that layout (mma_common.cuh's cp_async16); and the bulk reduce-add of an
// f32 tile from shared memory into device memory.
//
// The swizzled layout of a [ROWS, C] bf16 tile (C a multiple of 64): C / 64
// blocks of ROWS rows of 128 bytes, each block 1024-byte aligned; within a
// block, the 16-byte chunk c of row r sits at chunk c ^ (r % 8). One
// layout serves both operand majors:
//   K-major (the contraction runs along the row): SBO = 1024 bytes between
//     groups of 8 rows; a step of 16 elements along the row adds 32 bytes
//     to the start address; the next 64 elements are the next block.
//   MN-major (transposed; the contraction runs down the rows): a step of
//     16 rows adds 2048 bytes; SBO = 1024 bytes between groups of 8 rows,
//     LBO = the block size between 64-element groups of the M or N extent.
// Accumulator layout of m64n64 (f32, 32 registers): warp w of the
// warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane %
// 4); register 4 j + e holds column 8 j + 2 t + (e & 1) of row g + 8 (e >>
// 1). The A fragment of a 16-column slice kk taken from registers is the
// accumulator's blocks 2 kk and 2 kk + 1 packed as bf16 pairs: (row g,
// block 2 kk), (row g + 8, block 2 kk), (row g, block 2 kk + 1), (row
// g + 8, block 2 kk + 1).
//
// Everything here is in an anonymous namespace: each source is its own
// translation unit and its own library.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"  // cp_async16

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// matrix descriptor of a 128-byte swizzled operand at shared address addr
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed wgmma groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// barrier `id` (1..15) over the 128 threads of one warpgroup
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// makes this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B, A and B from shared memory; TA / TB: operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A B, A from registers (the fragment a0..a3), B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(TB));
}

// 4-byte cp.async, zero-filled with src_bytes 0
__device__ __forceinline__ void cp_async4(void* s, const void* g, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(s)), "l"(g),
               "r"(src_bytes));
}

// Starts copying rows [r0, r0 + ROWS) of a row-major [n, C] bf16 matrix
// into the swizzled layout at s (1024-byte aligned), NT threads sharing
// the copies; rows at or past n are zero-filled. Lands after
// cp.async.commit_group and cp.async.wait_group.
template <int C, int ROWS, int NT>
__device__ __forceinline__ void load_sw128(__nv_bfloat16* s, const __nv_bfloat16* g, int r0,
                                           int n) {
  constexpr int CPR = C / 8;  // 16-byte chunks per row
  char* sb = reinterpret_cast<char*>(s);
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool live = r0 + r < n;
    cp_async16(sb + (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                  live ? g + (size_t)(r0 + r) * C + c * 8 : g, live ? 16 : 0);
  }
}

// byte offset of element (r, c) of a swizzled [ROWS, C] tile
template <int ROWS>
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 6) * (ROWS * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// dst[0 .. bytes) += src[0 .. bytes) in f32, done by the L2 as one bulk
// operation (bytes a multiple of 16, both 16-byte aligned); one thread
// issues it, then commits the group
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// all but the newest N committed bulk groups of this thread have read
// their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// the committed bulk operations are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace
