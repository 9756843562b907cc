// Slab decode attention for one decode layer, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/decode_attention.py:
//   decode_attend_update_slab (kernel body _kernel_update) -> slab_attend_update_fwd
//   decode_attention_slab     (kernel body _kernel)        -> slab_attention_fwd
// The caches keep the JAX layout [L, B, KVD, T] ("slab": time in the minor
// dimension, KVD = NKV * HD), the layout llama_decode_step uses at
// head_dim < 128. The update entry writes new_k[b] / new_v[b] into column
// `pos` of layer `layer` in place, then both entries attend each row's
// query heads over columns 0..pos inclusive. `pos` is one scalar for the
// whole batch (unlike the paged kernel's per-row positions).
//
// What bounds it on this card: bytes. Each (row, kv-head) reads
// (pos + 1) * HD elements of K and of V and does about 4 * REP * HD
// operations per token; TinyLlama's generate shape (B = 8, NKV = 4,
// HD = 64, pos = 1023, bf16) reads 8.4 MB per call, 2.5 us at 3.35 TB/s.
//
// Design (not the TPU's): the TPU pads every query row to the full KVD
// ("block-diagonal" q) so its matrix unit sees [B*NH, B*KVD] x [B*KVD, Tt]
// per tile. Here one CTA of TILE = 128 threads owns one (kv-head g, row b)
// pair: its REP = NH / NKV query rows [REP, HD] sit in shared memory, and
// it walks the live 128-column tiles of its [HD, T] slice (pos/128 + 1 of
// them; row stride T, time contiguous) with an online softmax in f32 (exp2
// on q pre-scaled by scale * log2(e), as the caller does). Loads are
// 16-byte vectors along T. For scores, thread (kg, kc) reads vector kc of
// K rows kg, kg+G, ... and keeps the partial scores of its VEC tokens in
// registers (the G partials of a token are summed in shared memory in a
// fixed order); for P.V, thread (d, part) reads its slice of V row d and
// keeps acc[REP] for output column d in registers for the whole walk.
// Three barriers per tile. P is rounded to the cache dtype before P.V, and
// the normaliser sums the unrounded f32 P, as in the TPU kernel. Only the
// online recurrence is implemented: the TPU default's tile-0-anchored
// "fixed-base" softmax overflows once a later tile's max exceeds tile 0's
// by about 100 log2 units.
//
// Write before read, without a race: CTA (g, b) is the only one that owns
// rows g*HD..(g+1)*HD of batch row b, so it writes column `pos` of exactly
// those rows, then __syncthreads(), then reads; no other CTA touches them
// and there is no second pass over the cache.
//
// The kernel allocates nothing and does not synchronise; it launches on
// the caller's stream. Not done yet: with NKV * B CTAs (32 at TinyLlama,
// B = 8) most of the 132 SMs idle; splitting T across CTAs with a combine
// pass, and cp.async/TMA prefetch of the next tile, are later work.
#include <math.h>

#include "vec_common.cuh"

namespace {

constexpr int TILE = 128;             // columns per tile = threads per CTA
constexpr int NWARPS = TILE / 32;

// Launched with blockDim.x == TILE, grid (nkv, nb). Shared memory, in floats:
//   q_s [REP*hd] | part_s [G*REP*TILE] | p_s [REP*TILE] | max_s [REP*NWARPS] | sum_s [REP*NWARPS]
// Caches are plain pointers (no __restrict__, no const): the update entry
// reads back the column it wrote.
template <typename T, int REP, bool UPDATE>
__global__ void slab_kernel(const T* __restrict__ q, const T* __restrict__ new_k,
                            const T* __restrict__ new_v, T* k_cache, T* v_cache,
                            float* __restrict__ out, int layer, int nb, int nkv, int hd,
                            int t_len, int pos) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int G = VEC;                // K row groups: TILE threads / (TILE/VEC) per row
  const int g = blockIdx.x, b = blockIdx.y;
  const int kvd = nkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* part_s = q_s + REP * hd;
  float* p_s = part_s + G * REP * TILE;
  float* max_s = p_s + REP * TILE;
  float* sum_s = max_s + REP * NWARPS;

  // this head's [hd, t_len] slice of layer `layer`, batch row b
  const size_t head = (((size_t)layer * nb + b) * kvd + (size_t)g * hd) * t_len;
  T* kh = k_cache + head;
  T* vh = v_cache + head;

  // 1. the new token's column, this kv-head's rows only
  if (UPDATE) {
    const size_t src = (size_t)b * kvd + (size_t)g * hd;
    for (int d = tid; d < hd; d += TILE) {
      kh[(size_t)d * t_len + pos] = new_k[src + d];
      vh[(size_t)d * t_len + pos] = new_v[src + d];
    }
  }
  // 2. queries
  const size_t q_off = ((size_t)b * nkv * REP + (size_t)g * REP) * hd;
  for (int i = tid; i < REP * hd; i += TILE) q_s[i] = to_f(q[q_off + i]);
  __syncthreads();  // orders the column write above before the reads below

  // score mapping: vector kc of K rows kg, kg+G, ...
  constexpr int NV = TILE / VEC;
  const int kc = tid % NV, kg = tid / NV;
  // P.V mapping: tp threads per V row, each over tpt consecutive tokens
  const int tp = TILE / hd, tpt = TILE / tp;
  const int vd = tid / tp, vpart = tid % tp;

  float m[REP], l[REP], acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r] = 0.f;
  }

  // 3. online softmax over the live tiles
  const int ntile = pos / TILE + 1;
  for (int j = 0; j < ntile; ++j) {
    const T* kt = kh + (size_t)j * TILE;
    const T* vt = vh + (size_t)j * TILE;

    // a. partial scores of VEC tokens over this thread's K rows
    float sp[REP][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) sp[r][i] = 0.f;
#pragma unroll 8
    for (int d = kg; d < hd; d += G) {
      float kf[VEC];
      load_vec<T, VEC>(kt + (size_t)d * t_len + kc * VEC, kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float qd = q_s[r * hd + d];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sp[r][i] += qd * kf[i];
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float4* dst = reinterpret_cast<float4*>(part_s + (kg * REP + r) * TILE + kc * VEC);
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        dst[i / 4] = make_float4(sp[r][i], sp[r][i + 1], sp[r][i + 2], sp[r][i + 3]);
    }
    __syncthreads();

    // b. thread t = token t of the tile: whole score, mask, tile max
    const bool live = j * TILE + tid <= pos;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) v += part_s[(k * REP + r) * TILE + tid];
      s[r] = live ? v : -1e30f;
      const float mx = warp_max(s[r]);
      if (lane == 0) max_s[r * NWARPS + warp] = mx;
    }
    __syncthreads();

    // c. every thread keeps the same running (m, l); P to shared memory
    float alpha[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, max_s[r * NWARPS + w]);
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      const float p = exp2f(s[r] - m_new);
      p_s[r * TILE + tid] = round_to(p, kt);
      const float ps = warp_sum(p);
      if (lane == 0) sum_s[r * NWARPS + warp] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) sum += sum_s[r * NWARPS + w];
      l[r] = l[r] * alpha[r] + sum;
    }

    // d. P.V over this thread's slice of V row vd
    float pv[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) pv[r] = 0.f;
    const T* vrow = vt + (size_t)vd * t_len + vpart * tpt;
#pragma unroll 8
    for (int u = 0; u < tpt; u += VEC) {
      float vf[VEC];
      load_vec<T, VEC>(vrow + u, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* pr = p_s + r * TILE + vpart * tpt + u;
#pragma unroll
        for (int i = 0; i < VEC; ++i) pv[r] += pr[i] * vf[i];
      }
    }
    // the tp threads of one V row are neighbouring lanes
    for (int o = tp >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r) pv[r] += __shfl_xor_sync(0xffffffffu, pv[r], o);
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r] = acc[r] * alpha[r] + pv[r];
    // the next tile's first barrier orders these p_s reads before its writes
  }

  // 4. finalise: attn [B, NH, HD] f32
  if (vpart == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) out[q_off + (size_t)r * hd + vd] = acc[r] / fmaxf(l[r], 1e-30f);
  }
}

template <typename T, int REP, bool UPDATE>
cudaError_t launch(const void* q, const void* nk, const void* nv, void* kc, void* vc, void* out,
                   int nb, int layer, int nkv, int hd, int t_len, int pos, cudaStream_t stream) {
  constexpr int G = 16 / sizeof(T);
  const size_t smem =
      sizeof(float) * (size_t)(REP * hd + G * REP * TILE + REP * TILE + 2 * REP * NWARPS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(slab_kernel<T, REP, UPDATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  slab_kernel<T, REP, UPDATE><<<dim3(nkv, nb), TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<float*>(out), layer, nb, nkv, hd,
      t_len, pos);
  return cudaSuccess;
}

template <typename T, bool UPDATE>
cudaError_t launch_rep(int rep, const void* q, const void* nk, const void* nv, void* kc,
                       void* vc, void* out, int nb, int layer, int nkv, int hd, int t_len,
                       int pos, cudaStream_t s) {
  switch (rep) {
    case 1: return launch<T, 1, UPDATE>(q, nk, nv, kc, vc, out, nb, layer, nkv, hd, t_len, pos, s);
    case 2: return launch<T, 2, UPDATE>(q, nk, nv, kc, vc, out, nb, layer, nkv, hd, t_len, pos, s);
    case 4: return launch<T, 4, UPDATE>(q, nk, nv, kc, vc, out, nb, layer, nkv, hd, t_len, pos, s);
    case 8: return launch<T, 8, UPDATE>(q, nk, nv, kc, vc, out, nb, layer, nkv, hd, t_len, pos, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool UPDATE>
int dispatch(const void* q, const void* nk, const void* nv, void* kc, void* vc, void* out,
             int nb, int layer, int nh, int nkv, int hd, int t_len, int pos, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hd a power of two in [8, 128]: TILE / hd threads share a V row (a
  // power of two, neighbouring lanes), and each reads hd tokens in
  // 16-byte vectors
  if (nkv < 1 || nh % nkv || hd < 8 || hd > TILE || (hd & (hd - 1)) || t_len % TILE ||
      pos < 0 || pos >= t_len || layer < 0)
    return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    cudaError_t e;
    if (dtype == 0)
      e = launch_rep<float, UPDATE>(nh / nkv, q, nk, nv, kc, vc, out, nb, layer, nkv, hd,
                                    t_len, pos, s);
    else if (dtype == 1)
      e = launch_rep<__nv_bfloat16, UPDATE>(nh / nkv, q, nk, nv, kc, vc, out, nb, layer, nkv,
                                            hd, t_len, pos, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, new_k/new_v and caches share it).
// The caller guarantees contiguous tensors with 16-byte aligned storage,
// q [nb, nh, hd], new_k/new_v [nb, nkv*hd], caches [L, nb, nkv*hd, t_len]
// with layer < L, nh / nkv in {1, 2, 4, 8}, hd a power of two in [8, 128],
// t_len % 128 == 0 and 0 <= pos < t_len; out [nb, nh, hd] f32.
extern "C" int slab_attend_update_fwd(const void* q, const void* nk, const void* nv, void* kc,
                                      void* vc, void* out, int nb, int layer, int nh, int nkv,
                                      int hd, int t_len, int pos, int dtype, void* stream) {
  return dispatch<true>(q, nk, nv, kc, vc, out, nb, layer, nh, nkv, hd, t_len, pos, dtype,
                        stream);
}

extern "C" int slab_attention_fwd(const void* q, void* kc, void* vc, void* out, int nb,
                                  int layer, int nh, int nkv, int hd, int t_len, int pos,
                                  int dtype, void* stream) {
  return dispatch<false>(q, nullptr, nullptr, kc, vc, out, nb, layer, nh, nkv, hd, t_len, pos,
                         dtype, stream);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
