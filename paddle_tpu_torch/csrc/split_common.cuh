// The split-context protocol shared by the port's decode-attention kernels
// for Hopper (decode_attention.cu's slab kernel, paged_attention.cu's paged
// decode and verify kernel): a row's context is cut into splits, one CTA each, and the
// splits of one group (a kv-head of a batch row) agree on P's rounding and
// on one ordered combine without a second launch.
//
// - Tickets. A split takes its index from an atomic ticket in arrival
//   order, so every split it waits on below is already running: no
//   deadlock, whatever order the hardware runs CTAs in.
// - Decoupled look-back (as in single-pass prefix scans). A split takes the
//   max of its own scores, publishes it with a flag (st.release), then
//   reads the maxes of every split before it (ld.acquire on their flags).
//   It starts its online recurrence from that max, so P is rounded against
//   the same running max as one walk over the whole context.
// - Ordered combine. Each split writes its partial state (m, l,
//   unnormalised acc) in f32; the last split to finish (a second atomic
//   count after __threadfence) combines them in split order, so the output
//   has the same bits on every run, and resets the group's sync words. It
//   finalises (acc / l), or leaves the combined state unfinalised for a
//   caller that merges it further (the paged verify read).
//
// Layouts. part: per (group, split) 3 REP + REP hd floats: the split's
// score max, m, l, then acc [REP, hd]. sync: per group 2 + nsplit ints,
// zero on entry and on exit: the ticket, the done count and a flag per
// split. The caller keys the sync buffer per (device, stream), so that
// launches that share one run in order.
//
// Everything here is in an anonymous namespace: each source is its own
// translation unit and its own library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The split index of this CTA in arrival order (thread 0 only).
__device__ __forceinline__ int take_ticket(int* gsync) { return atomicAdd(gsync, 1); }

// Publishes this split's score max (thread 0 only): mypart[0 .. REP) =
// mx, then the split's flag, which orders the writes before it.
template <int REP>
__device__ __forceinline__ void publish_max(int* gsync, float* mypart, int split,
                                            const float (&mx)[REP]) {
#pragma unroll
  for (int r = 0; r < REP; ++r) mypart[r] = mx[r];
  st_release(gsync + 2 + split, 1);
}

// The max of the published maxes of splits 0 .. split-1 that this thread
// reads (splits tid, tid + nt, ...): the caller takes the CTA's max.
template <int REP>
__device__ __forceinline__ void look_back(const int* gsync, const float* gpart, int pstride,
                                          int split, int nt, float (&seed)[REP]) {
#pragma unroll
  for (int r = 0; r < REP; ++r) seed[r] = -INFINITY;
  for (int t = threadIdx.x; t < split; t += nt) {
    while (ld_acquire(gsync + 2 + t) == 0) __nanosleep(32);
    const float* pt = gpart + (size_t)t * pstride;
#pragma unroll
    for (int r = 0; r < REP; ++r) seed[r] = fmaxf(seed[r], __ldcg(pt + r));
  }
}

// After every thread wrote its share of this split's partial state: true,
// in every thread, for the last of the group's nlive splits to get here.
// flag_s is one shared int. Every split has then finished and read its
// flags.
__device__ __forceinline__ bool last_split(int* gsync, int nlive, int* flag_s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag_s = atomicAdd(gsync + 1, 1) == nlive - 1;
  __syncthreads();
  const bool last = *flag_s;
  if (last) __threadfence();
  return last;
}

// Combines the nlive splits' partial states of one group in split order,
// nt threads sharing the work, then leaves the group's sync words zero for
// the next launch. The splits' (m, l) go to ml_s [nlive][2 REP] in one
// round of loads; each output element then loads its nlive partial sums,
// unrolled so that several are in flight. FINAL: out [REP, hd] = acc / l.
// Otherwise (hd <= nt) out is the caller's unfinalised rows: out.row(r) is
// row r's index in out.acc [., hd], out.m and out.l (-1: a row not
// stored), which get acc = sum_t acc_t w_t, l = sum_t l_t w_t and m =
// max_t m_t, with w_t = exp2(m_t - m); thread d takes column d of every
// row, its REP loads of a split in flight together.
template <int REP, bool FINAL = true, typename Out>
__device__ __forceinline__ void combine_splits(const float* gpart, int pstride, int nlive, int hd,
                                               int nt, Out out, float* ml_s, int* gsync) {
  const int tid = threadIdx.x;
  for (int x = tid; x < nlive * 2 * REP; x += nt)
    ml_s[x] = __ldcg(gpart + (size_t)(x / (2 * REP)) * pstride + REP + x % (2 * REP));
  __syncthreads();
  if constexpr (FINAL) {
    for (int i = tid; i < REP * hd; i += nt) {
      const int r = i / hd;
      float mm = -INFINITY;
      for (int t = 0; t < nlive; ++t) mm = fmaxf(mm, ml_s[t * 2 * REP + r]);
      float ls = 0.f, as = 0.f;
#pragma unroll 8
      for (int t = 0; t < nlive; ++t) {
        const float w = exp2f(ml_s[t * 2 * REP + r] - mm);
        ls += ml_s[t * 2 * REP + REP + r] * w;
        as += __ldcg(gpart + (size_t)t * pstride + 3 * REP + i) * w;
      }
      out[i] = as / fmaxf(ls, 1e-30f);
    }
  } else if (tid < hd) {
    float mm[REP], ls[REP], as[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      mm[r] = -INFINITY;
      for (int t = 0; t < nlive; ++t) mm[r] = fmaxf(mm[r], ml_s[t * 2 * REP + r]);
      ls[r] = as[r] = 0.f;
    }
#pragma unroll 2
    for (int t = 0; t < nlive; ++t) {
      const float* pt = gpart + (size_t)t * pstride + 3 * REP + tid;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float w = exp2f(ml_s[t * 2 * REP + r] - mm[r]);
        ls[r] += ml_s[t * 2 * REP + REP + r] * w;
        as[r] += __ldcg(pt + r * hd) * w;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const int o = out.row(r);
      if (o < 0) continue;
      out.acc[(size_t)o * hd + tid] = as[r];
      if (tid == 0) {
        out.m[o] = mm[r];
        out.l[o] = ls[r];
      }
    }
  }
  for (int t = tid; t < nlive; t += nt) gsync[2 + t] = 0;
  if (tid == 0) gsync[0] = gsync[1] = 0;
}

}  // namespace
