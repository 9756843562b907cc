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
// Design (not the TPU's; redesigned for Hopper after the first port): the
// TPU pads every query row to the full KVD ("block-diagonal" q) so its
// matrix unit sees [B*NH, B*KVD] x [B*KVD, Tt] per tile. Here the context
// is split across CTAs (flash-decoding): the grid is (nkv, nb, nsplit), a
// CTA of TILE = 128 threads owns one (kv-head g, row b) pair and one run
// of `tps` 128-column tiles of its [HD, T] slice (row stride T, time
// contiguous), and its REP = NH / NKV query rows [REP, HD] sit in shared
// memory. nsplit comes from the cache extent T, not from pos (one launch
// shape per extent), so that nkv * nb * nsplit fills the card twice over;
// a split with no live column (past pos) exits at once. At generate's
// shape (B = 8, NKV = 4, T = 1152) that is one tile per split, 288 CTAs.
//
// Rounding: P is rounded to the cache dtype before P.V, and the
// normaliser sums the unrounded f32 P, as in the TPU kernel. A split does
// not round P against its own max: that moves every P's rounding (a
// relative Frobenius error of about 1.6e-3 against one split at
// generate's shape, outside the 2^-10 the checks allow;
// tools/slab_split_rounding.py). Instead each
// split starts its online recurrence from the max of all scores before
// it, so P is rounded against the same running max as a single walk
// (decoupled look-back, as in single-pass prefix scans): a split first
// takes the max of its own scores and publishes it with a flag, then
// waits for the flags of the splits before it. Splits take their index
// from an atomic ticket in arrival order, so every split waited on is
// already running and publishes without waiting itself: no deadlock,
// whatever order the hardware runs CTAs in. Each split writes its partial
// state (m, l, unnormalised acc) in f32 to a scratch the wrapper
// allocates; the last split to finish (a second atomic count after
// __threadfence) combines them in split order, so the output has the same
// bits on every run, and resets the tickets, counts and flags to zero:
// one launch, no memset. The sync words live in a buffer per (device,
// stream) that starts zeroed and that every launch leaves zeroed, so
// launches that share one run in order (ops/decode_attention.py keys it).
//
// Loads: for scores, thread (kg, kc) issues all its 16-byte K vectors of
// the tile (rows kg, kg+G, ...) before it sums them; the V vectors of
// the tile are issued before the softmax reduction, so they are in
// flight while the scores reduce. A split of one tile keeps its scores
// in registers across the look-back; a longer split recomputes them in
// its second walk (the K tiles come back from L2). Three barriers per
// tile, as before. Only the online recurrence is implemented: the TPU
// default's tile-0-anchored "fixed-base" softmax overflows once a later
// tile's max exceeds tile 0's by about 100 log2 units.
//
// Write before read, without a race: the split that owns column pos (the
// last live one) writes it for this kv-head's rows before it reads; no
// other CTA reads that column, and no CTA of another (g, b) touches these
// rows.
//
// The kernel allocates nothing and does not synchronise; it launches on
// the caller's stream.
#include <math.h>

#include "vec_common.cuh"

namespace {

constexpr int TILE = 128;             // columns per tile = threads per CTA
constexpr int NWARPS = TILE / 32;
constexpr int KLOADS = 8;             // 16-byte K vectors a thread has in flight
constexpr int VLOADS = 8;             // 16-byte V vectors issued ahead of the softmax
// the most splits a launch takes: the last split's combine keeps each
// split's (m, l) in part_s, G * REP * TILE floats with G >= 4
constexpr int MAX_SPLITS = 128;
static_assert(2 * MAX_SPLITS <= 4 * TILE, "part_s holds every split's (m, l)");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Whole scores of the tile at kt for token tid of the tile (-1e30 where
// not live): thread (kg, kc) issues all its K vectors (rows kg, kg+G, ...,
// vector kc) before it sums them, and the G partials of a token are summed
// in shared memory in a fixed order. The caller's next barrier orders
// these part_s reads before the next tile's writes.
template <typename T, int REP>
__device__ __forceinline__ void tile_scores(const T* kt, int t_len, int hd, const float* q_s,
                                            float* part_s, bool live, float (&s)[REP]) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int G = VEC;                // K row groups: TILE threads / (TILE/VEC) per row
  constexpr int NV = TILE / VEC;
  const int tid = threadIdx.x, kc = tid % NV, kg = tid / NV;
  float sp[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < VEC; ++i) sp[r][i] = 0.f;
  for (int d0 = kg; d0 < hd; d0 += KLOADS * G) {
    uint4 raw[KLOADS];
#pragma unroll
    for (int u = 0; u < KLOADS; ++u)
      if (d0 + u * G < hd)
        raw[u] = *reinterpret_cast<const uint4*>(kt + (size_t)(d0 + u * G) * t_len + kc * VEC);
#pragma unroll
    for (int u = 0; u < KLOADS; ++u) {
      const int d = d0 + u * G;
      if (d < hd) {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float qd = q_s[r * hd + d];
#pragma unroll
          for (int i = 0; i < VEC; ++i) sp[r][i] += qd * to_f(e[i]);
        }
      }
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
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) v += part_s[(k * REP + r) * TILE + tid];
    s[r] = live ? v : -1e30f;
  }
}

// max over the CTA of every thread's x[r], the same value in every thread;
// red_s [REP * NWARPS] must be free on entry and is free again after the
// caller's next barrier
template <int REP>
__device__ __forceinline__ void cta_max(float (&x)[REP], float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float mx = warp_max(x[r]);
    if (lane == 0) red_s[r * NWARPS + warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, red_s[r * NWARPS + w]);
    x[r] = mx;
  }
}

// Combines the nlive splits' partial states of one (g, b) group in split
// order into out [REP, hd], then leaves the group's sync words zero for the
// next launch. The splits' (m, l) go to ml_s [nlive][2 REP] in one round of
// loads; each output element then loads its nlive partial sums, unrolled
// so that several are in flight.
template <int REP>
__device__ __forceinline__ void combine_splits(const float* gpart, int pstride, int nlive, int hd,
                                               float* __restrict__ out, float* ml_s, int* gsync) {
  const int tid = threadIdx.x;
  for (int x = tid; x < nlive * 2 * REP; x += TILE)
    ml_s[x] = __ldcg(gpart + (size_t)(x / (2 * REP)) * pstride + REP + x % (2 * REP));
  __syncthreads();
  for (int i = tid; i < REP * hd; i += TILE) {
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
  for (int t = tid; t < nlive; t += TILE) gsync[2 + t] = 0;
  if (tid == 0) gsync[0] = gsync[1] = 0;
}

// Launched with blockDim.x == TILE, grid (nkv, nb, nsplit). Shared memory,
// in floats:
//   q_s [REP*hd] | part_s [G*REP*TILE] | p_s [REP*TILE] | max_s [REP*NWARPS] | sum_s [REP*NWARPS]
// part: per (group = b * nkv + g, split) 3 REP + REP hd floats: the split's
// score max, m, l and acc. sync: per group 2 + nsplit ints, zero on entry
// and on exit: the ticket, the done count and a flag per split.
// Caches are plain pointers (no __restrict__, no const): the update entry
// reads back the column it wrote.
template <typename T, int REP, bool UPDATE>
__global__ void __launch_bounds__(TILE)
    slab_kernel(const T* __restrict__ q, const T* __restrict__ new_k,
                const T* __restrict__ new_v, T* k_cache, T* v_cache, float* __restrict__ out,
                float* part, int* sync, int layer, int nb, int nkv, int hd, int t_len, int pos,
                int nsplit, int tps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int G = VEC;
  const int ntile = pos / TILE + 1;
  const int nlive = (ntile + tps - 1) / tps;
  if ((int)blockIdx.z >= nlive) return;  // no live column in this split
  const int g = blockIdx.x, b = blockIdx.y;
  const int grp = b * nkv + g;
  const int kvd = nkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* part_s = q_s + REP * hd;
  float* p_s = part_s + G * REP * TILE;
  float* max_s = p_s + REP * TILE;
  float* sum_s = max_s + REP * NWARPS;
  __shared__ int split_s, last_s;

  int* gsync = sync + (size_t)grp * (2 + nsplit);  // ticket, done, flags
  const int pstride = 3 * REP + REP * hd;
  float* gpart = part + (size_t)grp * nsplit * pstride;

  // the split index in arrival order: every split this one waits on below
  // took its ticket earlier, so it is running
  if (tid == 0) split_s = atomicAdd(gsync, 1);
  // this head's [hd, t_len] slice of layer `layer`, batch row b
  const size_t head = (((size_t)layer * nb + b) * kvd + (size_t)g * hd) * t_len;
  T* kh = k_cache + head;
  T* vh = v_cache + head;
  const size_t q_off = ((size_t)b * nkv * REP + (size_t)g * REP) * hd;
  for (int i = tid; i < REP * hd; i += TILE) q_s[i] = to_f(q[q_off + i]);
  __syncthreads();
  const int split = split_s;
  const int j0 = split * tps, j1 = min(j0 + tps, ntile);

  // 1. the new token's column, this kv-head's rows only, by the split
  // that owns it
  if (UPDATE && split == nlive - 1) {
    const size_t src = (size_t)b * kvd + (size_t)g * hd;
    for (int d = tid; d < hd; d += TILE) {
      kh[(size_t)d * t_len + pos] = new_k[src + d];
      vh[(size_t)d * t_len + pos] = new_v[src + d];
    }
    __syncthreads();  // orders the column write before the reads below
  }

  // P.V mapping: tp threads per V row, each over tpt consecutive tokens;
  // the first tile's V vectors go out now, in flight through steps 2-3
  const int tp = TILE / hd, tpt = TILE / tp;
  const int vd = tid / tp, vpart = tid % tp;
  uint4 vraw[VLOADS];
  {
    const T* vrow = vh + (size_t)j0 * TILE + (size_t)vd * t_len + vpart * tpt;
#pragma unroll
    for (int u = 0; u < VLOADS; ++u)
      if (u * VEC < tpt) vraw[u] = *reinterpret_cast<const uint4*>(vrow + u * VEC);
  }

  // 2. the max of this split's scores; a split of one tile keeps them
  float mx[REP], s_keep[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) mx[r] = -INFINITY;
  for (int j = j0; j < j1; ++j) {
    float sc[REP];
    tile_scores<T, REP>(kh + (size_t)j * TILE, t_len, hd, q_s, part_s, j * TILE + tid <= pos,
                        sc);
#pragma unroll
    for (int r = 0; r < REP; ++r) s_keep[r] = sc[r];
    cta_max<REP>(sc, max_s);
#pragma unroll
    for (int r = 0; r < REP; ++r) mx[r] = fmaxf(mx[r], sc[r]);
  }
  float* mypart = gpart + (size_t)split * pstride;  // smax | m | l | acc
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) mypart[r] = mx[r];
    st_release(gsync + 2 + split, 1);  // orders this thread's writes above
  }

  // 3. look back: the max of every earlier split's scores
  float seed[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) seed[r] = -INFINITY;
  for (int t = tid; t < split; t += TILE) {
    while (ld_acquire(gsync + 2 + t) == 0) __nanosleep(32);
    const float* pt = gpart + (size_t)t * pstride;
#pragma unroll
    for (int r = 0; r < REP; ++r) seed[r] = fmaxf(seed[r], __ldcg(pt + r));
  }
  cta_max<REP>(seed, sum_s);

  // 4. online softmax over this split's tiles from the seed: P is rounded
  // against the same running max as one walk over all tiles would use
  float m[REP], l[REP], acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = seed[r];
    l[r] = 0.f;
    acc[r] = 0.f;
  }
  for (int j = j0; j < j1; ++j) {
    const T* vrow = vh + (size_t)j * TILE + (size_t)vd * t_len + vpart * tpt;
    if (j != j0) {  // in flight while the scores reduce
#pragma unroll
      for (int u = 0; u < VLOADS; ++u)
        if (u * VEC < tpt) vraw[u] = *reinterpret_cast<const uint4*>(vrow + u * VEC);
    }
    float sc[REP];
    if (j1 - j0 == 1) {
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r] = s_keep[r];
    } else {
      tile_scores<T, REP>(kh + (size_t)j * TILE, t_len, hd, q_s, part_s,
                          j * TILE + tid <= pos, sc);
    }
    float tmx[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) tmx[r] = sc[r];
    cta_max<REP>(tmx, max_s);

    // every thread keeps the same running (m, l); P to shared memory
    float alpha[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m_new = fmaxf(m[r], tmx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      const float p = exp2f(sc[r] - m_new);
      p_s[r * TILE + tid] = round_to(p, kh);
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

    // P.V over this thread's slice of V row vd
    float pv[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) pv[r] = 0.f;
#pragma unroll
    for (int u = 0; u < VLOADS; ++u) {
      if (u * VEC < tpt) {
        const T* e = reinterpret_cast<const T*>(&vraw[u]);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float* pr = p_s + r * TILE + vpart * tpt + u * VEC;
#pragma unroll
          for (int i = 0; i < VEC; ++i) pv[r] += pr[i] * to_f(e[i]);
        }
      }
    }
    for (int u0 = VLOADS * VEC; u0 < tpt; u0 += VEC) {
      float vf[VEC];
      load_vec<T, VEC>(vrow + u0, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* pr = p_s + r * TILE + vpart * tpt + u0;
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

  // 5. this split's partial state, then the last split combines
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      mypart[REP + r] = m[r];
      mypart[2 * REP + r] = l[r];
    }
  }
  if (vpart == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) mypart[3 * REP + r * hd + vd] = acc[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(gsync + 1, 1) == nlive - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every split has finished (and read its flags)
  combine_splits<REP>(gpart, pstride, nlive, hd, out + q_off, part_s, gsync);
}

template <typename T, int REP, bool UPDATE>
cudaError_t launch(const void* q, const void* nk, const void* nv, void* kc, void* vc, void* out,
                   void* part, void* sync, int nb, int layer, int nkv, int hd, int t_len,
                   int pos, int nsplit, int tps, cudaStream_t stream) {
  constexpr int G = 16 / sizeof(T);
  const size_t smem =
      sizeof(float) * (size_t)(REP * hd + G * REP * TILE + REP * TILE + 2 * REP * NWARPS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(slab_kernel<T, REP, UPDATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  slab_kernel<T, REP, UPDATE><<<dim3(nkv, nb, nsplit), TILE, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(sync), layer, nb, nkv, hd, t_len, pos, nsplit,
      tps);
  return cudaSuccess;
}

template <typename T, bool UPDATE>
cudaError_t launch_rep(int rep, const void* q, const void* nk, const void* nv, void* kc,
                       void* vc, void* out, void* part, void* sync, int nb, int layer, int nkv,
                       int hd, int t_len, int pos, int nsplit, int tps, cudaStream_t s) {
#define SLAB_REP(R)                                                                    \
  case R:                                                                              \
    return launch<T, R, UPDATE>(q, nk, nv, kc, vc, out, part, sync, nb, layer, nkv, hd, \
                                t_len, pos, nsplit, tps, s);
  switch (rep) {
    SLAB_REP(1)
    SLAB_REP(2)
    SLAB_REP(4)
    SLAB_REP(8)
    default: return cudaErrorInvalidValue;
  }
#undef SLAB_REP
}

template <bool UPDATE>
int dispatch(const void* q, const void* nk, const void* nv, void* kc, void* vc, void* out,
             void* part, void* sync, int nb, int layer, int nh, int nkv, int hd, int t_len,
             int pos, int nsplit, int tps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // hd a power of two in [8, 128]: TILE / hd threads share a V row (a
  // power of two, neighbouring lanes), and each reads hd tokens in
  // 16-byte vectors; the splits must cover the extent
  if (nkv < 1 || nh % nkv || hd < 8 || hd > TILE || (hd & (hd - 1)) || t_len % TILE ||
      pos < 0 || pos >= t_len || layer < 0 || nsplit < 1 || nsplit > MAX_SPLITS || tps < 1 ||
      (long long)nsplit * tps * TILE < t_len)
    return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    cudaError_t e;
    if (dtype == 0)
      e = launch_rep<float, UPDATE>(nh / nkv, q, nk, nv, kc, vc, out, part, sync, nb, layer, nkv,
                                    hd, t_len, pos, nsplit, tps, s);
    else if (dtype == 1)
      e = launch_rep<__nv_bfloat16, UPDATE>(nh / nkv, q, nk, nv, kc, vc, out, part, sync, nb,
                                            layer, nkv, hd, t_len, pos, nsplit, tps, s);
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
// t_len % 128 == 0 and 0 <= pos < t_len; out [nb, nh, hd] f32. The
// context is cut into nsplit <= 128 runs of tps tiles (nsplit * tps * 128
// >= t_len); part is f32 scratch of nb * nkv * nsplit * (3 + hd) * nh /
// nkv floats, sync nb * nkv * (2 + nsplit) ints, zero (each launch leaves
// it zero; launches sharing it run in stream order).
extern "C" int slab_attend_update_fwd(const void* q, const void* nk, const void* nv, void* kc,
                                      void* vc, void* out, void* part, void* sync, int nb,
                                      int layer, int nh, int nkv, int hd, int t_len, int pos,
                                      int nsplit, int tps, int dtype, void* stream) {
  return dispatch<true>(q, nk, nv, kc, vc, out, part, sync, nb, layer, nh, nkv, hd, t_len, pos,
                        nsplit, tps, dtype, stream);
}

extern "C" int slab_attention_fwd(const void* q, void* kc, void* vc, void* out, void* part,
                                  void* sync, int nb, int layer, int nh, int nkv, int hd,
                                  int t_len, int pos, int nsplit, int tps, int dtype,
                                  void* stream) {
  return dispatch<false>(q, nullptr, nullptr, kc, vc, out, part, sync, nb, layer, nh, nkv, hd,
                         t_len, pos, nsplit, tps, dtype, stream);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
