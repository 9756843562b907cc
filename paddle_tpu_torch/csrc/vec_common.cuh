// Scalar helpers shared by the port's decode-attention kernels for Hopper
// (paged_attention.cu, decode_attention.cu), which run on the CUDA cores:
// loads are 16-byte vectors converted to f32, sums are f32, and P is
// rounded to the cache dtype before P.V as in the TPU kernels (the paged
// kernels' int8 pools keep P in f32 and convert their codes themselves,
// load_f there). to_f of f32 and bf16 comes from mma_common.cuh, the
// tensor-core kernels' header, so that a source may include both
// (paged_attention.cu takes wgmma_common.cuh's bulk copies).
//
// Everything here is in an anonymous namespace: each source is its own
// translation unit and its own library.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"  // to_f of f32 and bf16

namespace {

// x rounded to the element type that the pointer's type names
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one 16-byte vector of VEC elements at p (16-byte aligned), as f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace
