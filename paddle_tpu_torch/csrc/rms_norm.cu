// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/rms_norm.py:_rms_fwd_impl (kernel
// body _rms_kernel): per row, the f32 mean of squares over H,
// inv = rsqrt(ms + eps), then x * inv * w in f32 in that order (w is
// applied in f32 BEFORE the cast, not HF's order), cast to x's dtype.
//
// What bounds it on this card. Bytes: it reads N*H + H elements and writes
// N*H, about one operation per byte, far below the ~295 operations per
// byte where the H100's bf16 tensor cores would become the limit. But at
// the serving engine's decode shape (N = 8, H = 4096: 128 KiB, 40 ns at
// 3.35 TB/s) the floor is the launch (chip_smoke.py's times phase prints
// it beside this kernel: an empty kernel queued back to back), so only a
// prefill chunk (N = 256) or a train step (N = B*S) moves enough bytes to
// see bandwidth. What a body can still save at decode width is its own
// critical path: the dependent memory round trips and barriers between
// launch and store.
//
// Design: the row lives in registers, one CTA a row. Each thread holds
// NV 16-byte vectors of x and of w (8 bf16 or 4 f32 each: thread t takes
// vectors t, t + nt, ...), loaded together in one pass before the
// reduction, so there is one memory round trip before the sum and no
// second read of x or w. The sum of squares is a warp-shuffle butterfly,
// then ONE barrier: each warp publishes its partial in shared memory and
// every warp sums all partials itself, in the same order (so every thread
// holds the same inv, the same bits on every run). NV is a template
// argument in {1, 2, 4, 8}, chosen with the block width so that every H
// the port uses (1024, 2048, 4096, 5120) runs this register form at <= 256
// threads; rows of up to 4096 vectors (bf16 H <= 32768) run at NV = 8 on
// up to 512 threads. A persistent grid (a CTA walking rows with w loaded
// once and the next row's x in flight during the reduction), blocks of 512
// threads, a second barrier and programmatic dependent launch all lost, or
// did not win inside the decode step, on an H100 (tools/rms_choices.py).
// No scratch, no synchronisation with the host; launched on the caller's
// stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // at NV = 8: 128 registers a thread
constexpr int kWideThreads = 256;  // the widest block while NV < 8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // a butterfly: every lane holds the same bits
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_f(e[k]);
    ss += f * f;
  }
  return ss;
}

template <typename T, int NV>
__global__ void __launch_bounds__(NV < 8 ? kWideThreads : kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int h,
                    float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[kMaxThreads / 32];  // the warps' partial sums
  const int nvec = h / VEC, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * h);
  // x and w together, one 16-byte vector pass, before the reduction
  uint4 wv[NV], xv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + k * nt;
    wv[k] = i < nvec ? __ldg(wr + i) : zero;
    xv[k] = i < nvec ? __ldg(xr + i) : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) ss += sum_squares<T>(xv[k]);
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();  // the one barrier: every warp then sums all partials itself
  const float total = warp_sum(lane < nw ? part[lane] : 0.f);
  const float inv = rsqrtf(total / (float)h + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * h);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + k * nt;
    if (i < nvec) {
      uint4 o;
      const T* e = reinterpret_cast<const T*>(&xv[k]);
      const T* we = reinterpret_cast<const T*>(&wv[k]);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_f<T>(to_f(e[j]) * inv * to_f(we[j]));
      orow[i] = o;
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const void* x, const void* w, void* out, int n, int h, float eps,
                      int threads, cudaStream_t stream) {
  rms_norm_kernel<T, NV><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), h, eps);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int n, int h, float eps,
                   cudaStream_t stream) {
  const int nvec = h / (16 / (int)sizeof(T));
  // the fewest vectors a thread that keep the block within kWideThreads;
  // NV = 8 takes up to kMaxThreads
  int nv = 1;
  while (nv < 8 && (nvec + nv - 1) / nv > kWideThreads) nv *= 2;
  const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  switch (nv) {
    case 1: return launch_nv<T, 1>(x, w, out, n, h, eps, threads, stream);
    case 2: return launch_nv<T, 2>(x, w, out, n, h, eps, threads, stream);
    case 4: return launch_nv<T, 4>(x, w, out, n, h, eps, threads, stream);
    default: return launch_nv<T, 8>(x, w, out, n, h, eps, threads, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller guarantees contiguous rows,
// 16-byte aligned pointers, h * itemsize % 16 == 0 and at most 8 *
// kMaxThreads = 4096 vectors a row (ops/rms_norm.py's MAX_VECTORS).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out, int n, int h,
                            float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    cudaError_t e;
    if (dtype == 0)
      e = launch<float>(x, w, out, n, h, eps, s);
    else if (dtype == 1)
      e = launch<__nv_bfloat16>(x, w, out, n, h, eps, s);
    else
      e = cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
