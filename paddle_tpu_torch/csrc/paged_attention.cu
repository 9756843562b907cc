// Paged-attention kernels of the serving engine, for Hopper (sm_90a).
// Pools keep the JAX layout [L, NP, KVD, bs] (time in the minor
// dimension, KVD = NKV * HD); block 0 is the reserved null block.
//
// Replaces eight TPU kernels of paddle_tpu/ops/paged_attention.py:
//   paged_attend_update    (_paged_update_kernel) -> paged_attend_update_fwd
//   paged_attention        (_paged_kernel)        -> paged_attention_fwd
//   paged_attention_verify (_paged_verify_kernel) -> paged_attention_verify_fwd
//   paged_verify_commit    (_paged_commit_kernel) -> paged_verify_commit_fwd
// and their int8 twins over int8 pools with f32 scale pools [L, NP, NKV,
// bs], one scale per (block, kv-head, column):
//   paged_attend_update_quant    (_paged_update_quant_kernel)
//                                   -> paged_attend_update_quant_fwd
//   paged_attention_quant        (_paged_quant_kernel)
//                                   -> paged_attention_quant_fwd
//   paged_attention_verify_quant (_paged_verify_quant_kernel)
//                                   -> paged_attention_verify_quant_fwd
//   paged_verify_commit_quant    (_paged_commit_quant_kernel)
//                                   -> paged_verify_commit_quant_fwd
//
// paged_attend_update_fwd: for each batch row b it writes new_k[b] /
// new_v[b] into column positions[b] % bs of pool block tables[b,
// positions[b] / bs] at `layer` (in place), then attends the row's query
// heads over tokens 0..positions[b] inclusive, following the block table.
// paged_attention_fwd is the same kernel with that write compiled out,
// over tokens 0..lengths[b]-1 (a row of length 0 gets 0).
//
// paged_attention_verify_fwd: speculative verification. Each row b feeds
// T tokens whose NH query heads attend over the CACHED prefix only,
// tokens 0..qstart[b]-1 (the fed tokens are not in the pools yet). It
// returns the unfinalised online-softmax partials (acc, m, l) in f32; the
// caller merges the fed tokens' own causal block and finalises. A row with
// qstart = 0 (padding) gets acc = 0, l = 0, m = -1e30.
//
// paged_verify_commit_fwd: after verification, fed token t of row b lands
// at position qstart[b] + t. For t < commit_len[b] its new_k/new_v column
// of every layer is written into the row's block; every other (layer, row,
// token) writes the null block 0 at the same column, as the JAX commit
// schedule routes it. A bare scatter: the TPU kernel's first-visit and
// revisit flags exist only for Pallas's aliasing rules.
//
// What bounds them on this card: bytes. The attention entries read each
// row's K and V columns once and do about 4 * R * HD operations per token
// for R query rows of a kv-head, under 2 operations per byte at R <= 8
// (B = 8 rows of 1024 tokens at KVD = 4096 in bf16 is 134 MB, 40 us per
// layer; int8 halves the bytes and adds 4 bytes of scales per kv-head
// and token, 4 operations per byte at R <= 8). The commit moves 2 * L * B
// * T * KVD elements in and out; each column write touches KVD rows bs
// elements apart, so every element costs a 32-byte sector.
//
// Design of the attention entries (not the TPU's): the TPU walks one flat
// sequential schedule of (sequence, block) steps and pads each query row
// to the full KVD ("block-diagonal" q) so its matrix unit sees [R, KVD] x
// [KVD, bs]; for an MHA model that is NH times the useful work. Here a CTA
// of bs threads owns one (row, kv-head) pair, or a share of its context;
// its query rows sit in shared memory and the softmax is the online
// recurrence in f32 (exp2 on q pre-scaled by scale * log2(e), as the
// caller does). P is rounded to the pool dtype before P.V, and the
// normaliser sums the unrounded f32 P, as in the TPU kernels. Only the
// online recurrence is implemented: the TPU default's tile-0-anchored
// "fixed-base" softmax overflows once a later tile's max exceeds tile 0's
// by ~100 log2 units.
//
// Rows 3 and 2 (paged_split_kernel, redesigned for Hopper): flash-decoding.
// A serving batch is ragged (prompts of 128-1024 tokens plus what was
// generated), and a walk of one CTA per (row, kv-head) takes as long as
// its longest row's blocks in sequence. So the grid is (kv-head, row,
// split) and each split takes a run of ceil(max_nb / nsplit) of the row's
// pool blocks; nsplit comes from the table width and bs (the wrapper's
// kernel_splits), never from the lengths, so the launch shape depends only
// on tensor shapes; a split wholly past its row's last token exits at
// once. The splits of a row keep one walk's rounding by split_common.cuh's
// protocol (shared with the slab kernel, decode_attention.cu): a ticket in
// arrival order, the split's score max published with a flag, the max of
// every earlier split's scores as the seed of its recurrence (so P is
// rounded against the same running max as one walk), and the last split
// to finish combining the partial states in split order (the same bits on
// every run). A row whose live blocks fit one split takes none of it and
// finalises at once. Loads: one kv-head's slice of a pool block is
// contiguous (hd x bs elements at ((layer NP + blk) KVD + g hd) bs, 32 KB
// in bf16 at hd = bs = 128), so each K or V slice arrives by one 1-D bulk
// copy (cp.async.bulk, no tensor map) completing on an mbarrier, in pieces
// of at most 32 KB where a slice is larger; thread 0 issues the pieces in
// order, K pieces of the split first, then V, into a ring: one slot for a
// split of one block (V's copy goes out as soon as K is read, so it lands
// under the score reduction, the softmax and the look-back), two blocks'
// pieces for a longer split. Scores and P.V
// read shared memory in 16-byte vectors: thread (g, c) sums its K rows g,
// g+G, ... for the VEC tokens of vector c (the G partials of a token are
// summed in shared memory in a fixed order); thread (d, part) sums P.V
// over its slice of V row d, starting at a vector rotated by d so that the
// threads of a phase read different banks, with P kept in the pool dtype
// in shared memory. The first block's scores stay in registers across the
// look-back, later blocks' in shared memory.
//
// Rows 4-7 (the int8 entries and verify) keep one CTA per (row, kv-head,
// chunk of query rows) walking the row's live blocks in sequence
// (walk_blocks): every K and V access is a 16-byte vector from device
// memory, several in flight a thread; three barriers per block. The
// verify chunks of one (row, kv-head) read the same K and V; at MHA with
// T <= 8 there is one chunk.
//
// Write before read, without a race (update entries): the CTA that owns
// the new column (row 3: the split whose run holds positions[b]) writes
// only its own kv-head's HD rows of it, then reads them: row 3 orders the
// writes before its bulk copies with a proxy fence and a barrier, row 5
// with a barrier before its loads. No other CTA touches those bytes: the
// other splits of the row read earlier blocks only. Padding rows point
// their whole table at the reserved null block 0 with position 0; they all
// write block 0, column 0, concurrently. That is harmless: no live row
// ever reads block 0. The commit's rejected and padding columns likewise
// land in block 0 from many CTAs at once.
//
// Design of the commit: one CTA of 128 threads per (kv-slice of 128
// elements, row, layer) stages the row's T columns of that slice in shared
// memory (coalesced reads of new_k/new_v), then writes them with the token
// index fastest, so the up-to-T consecutive columns of one pool row go out
// together.
//
// The int8 entries (q in f32 or bf16, pools int8, scales f32). New
// columns arrive already quantized (the caller's kv_quant_columns, the one
// quantizer of prefill, decode and commit): the kernels copy bytes and
// scales and never requantize. The walk is the same block walk with
// 16-byte vectors of 16 codes (so G = 16 K row groups, and part_s holds
// 16 * R * bs floats: 64 KiB at R = 8). One CTA owns one kv-head, so a
// token's K scale and V scale are scalars of the whole CTA: step b forms
// s[t] = ks[t] * sum_d q[d] * k8[d, t], and step c stores p'[t] = p[t] *
// vs[t] for P.V, in f32 and NOT rounded (l sums the unscaled p). The TPU
// kernels dequantize every element first, f32(k8) * ks; the factored
// form differs from that only in f32 rounding. The decode entry
// (paged_attend_update_quant_fwd) writes the new column's HD bytes of its
// own kv-head and its one K and one V scale before the __syncthreads that
// precedes the walk, the same race-free argument as above; the read-only
// entry (paged_attention_quant_fwd) is the same kernel with the write
// compiled out, over tokens 0..lengths[b]-1 (a row of length 0 gets 0).
// The int8 commit is the commit's byte scatter with 1-byte elements, each
// of which costs a 32-byte sector (worse than bf16: the T columns of one
// pool row share one sector at most); each CTA also scatters the T scales
// of the kv-heads whose rows start in its slice.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// caller's stream. Not done yet: rows 4-7 on the split walk.
#include <math.h>

#include "split_common.cuh"
#include "vec_common.cuh"
#include "wgmma_common.cuh"  // mbarriers and 1-D bulk copies

namespace {

constexpr int kMaxFed = 8;        // verify and commit: fed tokens per row
constexpr int kCommitSlice = 128; // commit: KVD elements per CTA

// Shared memory of the attention walk, in floats:
//   q_s [R*hd] | part_s [G*R*bs] | p_s [R*bs] | max_s [R*32] | sum_s [R*32]
template <typename T, int R>
size_t walk_smem_bytes(int hd, int bs) {
  constexpr int G = 16 / sizeof(T);
  return sizeof(float) * (size_t)(R * hd + G * R * bs + R * bs + 2 * R * 32);
}

// The per-column scale pools [L, NP, NKV, bs] f32 of int8 pools, read at
// kv-head g (QUANT walks only)
struct Scales {
  const float* k = nullptr;
  const float* v = nullptr;
  int nkv = 0, g = 0;
};

// Online softmax of the R query rows q_s [R, hd] (f32, shared memory)
// over tokens 0..last (inclusive, last >= 0) of one sequence, whose pool
// blocks are trow[0..last/bs], at the kv-head slice that starts head_off
// rows into KVD. Launched with blockDim.x == bs; every thread of the CTA
// calls it. On return every thread holds the same m[r], l[r], and thread
// (vd, vpart) with vpart == 0 holds acc[r] for output column vd, where
// tp = bs / hd, vd = tid / tp, vpart = tid % tp. QUANT: T is int8_t and
// each token's score and P take its K and V scale from ``sc``.
template <typename T, int R, bool QUANT = false>
__device__ __forceinline__ void walk_blocks(const T* k_pool, const T* v_pool,
                                            const int* trow, int layer, int np, int kvd,
                                            size_t head_off, int hd, int bs, int last,
                                            float* smem, float (&m)[R], float (&l)[R],
                                            float (&acc)[R], Scales sc = {}) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int G = VEC;                // K row groups: bs threads / (bs/VEC) per row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* q_s = smem;
  float* part_s = smem + R * hd;
  float* p_s = part_s + G * R * bs;
  float* max_s = p_s + R * bs;
  float* sum_s = max_s + R * 32;

  // score mapping: vector c of K rows kg, kg+G, ...
  const int nv = bs / VEC;
  const int kc = tid % nv, kg = tid / nv;
  // P.V mapping: tp threads per V row, each over tpt consecutive tokens
  const int tp = blockDim.x / hd, tpt = bs / tp;
  const int vd = tid / tp, vpart = tid % tp;

#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r] = 0.f;
  }

  const int nblk = last / bs + 1;
  for (int j = 0; j < nblk; ++j) {
    const size_t base = (((size_t)layer * np + (size_t)trow[j]) * kvd + head_off) * bs;
    const T* kt = k_pool + base;
    const T* vt = v_pool + base;
    [[maybe_unused]] float kscale = 1.f, vscale = 1.f;  // this token's scales
    if constexpr (QUANT) {
      const size_t so = (((size_t)layer * np + (size_t)trow[j]) * sc.nkv + sc.g) * bs + tid;
      kscale = sc.k[so];
      vscale = sc.v[so];
    }

    // a. partial scores of VEC tokens over this thread's K rows
    float sp[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) sp[r][i] = 0.f;
#pragma unroll 8
    for (int d = kg; d < hd; d += G) {
      float kf[VEC];
      load_vec<T, VEC>(kt + (size_t)d * bs + kc * VEC, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float qd = q_s[r * hd + d];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sp[r][i] += qd * kf[i];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* dst = reinterpret_cast<float4*>(part_s + (kg * R + r) * bs + kc * VEC);
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        dst[i / 4] = make_float4(sp[r][i], sp[r][i + 1], sp[r][i + 2], sp[r][i + 3]);
    }
    __syncthreads();

    // b. thread t = token t: whole score, mask, block max
    const bool live = j * bs + tid <= last;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) v += part_s[(k * R + r) * bs + tid];
      if constexpr (QUANT) v *= kscale;
      s[r] = live ? v : -1e30f;
      const float mx = warp_max(s[r]);
      if (lane == 0) max_s[r * 32 + warp] = mx;
    }
    __syncthreads();

    // c. every thread keeps the same running (m, l); P to shared memory
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, max_s[r * 32 + w]);
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      const float p = exp2f(s[r] - m_new);
      if constexpr (QUANT)
        p_s[r * bs + tid] = p * vscale;
      else
        p_s[r * bs + tid] = round_to(p, kt);
      const float ps = warp_sum(p);
      if (lane == 0) sum_s[r * 32 + warp] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += sum_s[r * 32 + w];
      l[r] = l[r] * alpha[r] + sum;
    }

    // d. P.V over this thread's slice of V row vd
    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pv[r] = 0.f;
    const T* vrow = vt + (size_t)vd * bs + vpart * tpt;
#pragma unroll 8
    for (int u = 0; u < tpt; u += VEC) {
      float vf[VEC];
      load_vec<T, VEC>(vrow + u, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* pr = p_s + r * bs + vpart * tpt + u;
#pragma unroll
        for (int i = 0; i < VEC; ++i) pv[r] += pr[i] * vf[i];
      }
    }
    // the tp threads of one V row are neighbouring lanes
    for (int o = tp >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) pv[r] += __shfl_xor_sync(0xffffffffu, pv[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = acc[r] * alpha[r] + pv[r];
  }
}

// ---------------------------------------------------------------------------
// rows 3 and 2: the split-context decode walk
// ---------------------------------------------------------------------------

constexpr int kRing = 4;          // ring slots at most: two blocks of K and V
constexpr int kPieceBytes = 32768;  // the most one bulk copy brings
constexpr int kMaxSplits = 256;   // the combine keeps each split's (m, l) in part_s

// Shared memory of the split walk, byte offsets: the ring [nbuf][piece]
// | its barriers [kRing] | q_s [R, hd] f32 | part_s [G, R, bs] f32 |
// keep_s [bps - 1, R, bs] f32 | p_s [R, bs] T | max_s, lb_s, sum_s
// [R, 32] f32 | bm_s [bps, R] f32. Every region starts 16-byte aligned.
template <typename T, int R>
struct SplitSmem {
  size_t bars, q, part, keep, p, mx, lb, sum, bm, total;
  __host__ __device__ SplitSmem(int hd, int bs, int bps, int prow, int nbuf) {
    constexpr int G = 16 / sizeof(T);
    bars = (size_t)nbuf * prow * bs * sizeof(T);
    q = bars + 16 * ((kRing + 1) / 2);  // the barriers, 16-byte aligned
    part = q + 4 * (size_t)R * hd;
    keep = part + 4 * (size_t)G * R * bs;
    p = keep + 4 * (size_t)(bps - 1) * R * bs;
    mx = p + sizeof(T) * (size_t)R * bs;
    lb = mx + 4 * R * 32;
    sum = lb + 4 * R * 32;
    bm = sum + 4 * R * 32;
    total = bm + 4 * (size_t)bps * R;
  }
};

// grid (nkv, b, nsplit), blockDim.x == bs. Split z of (kv-head g, row b)
// takes the row's pool blocks [z bps, (z + 1) bps) of its live ones (the
// index z is a ticket in arrival order), a piece of prow rows of one K or
// V slice per bulk copy, nbuf pieces in flight. WRITE (row 3): the split
// that owns positions[b] writes row b's new column there, then every split
// attends over its share of 0..positions[b]. !WRITE (row 2): over
// 0..rows[b]-1, rows = lengths; a row of length 0 gets 0. new_k/new_v are
// unused when !WRITE. part and sync: split_common.cuh's layouts. MAXT
// bounds bs: blocks of more than 256 tokens take the form compiled for
// 1024 threads (64 registers a thread, where 256 threads leave it 255).
template <typename T, int REP, bool WRITE, int MAXT>
__global__ void __launch_bounds__(MAXT)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ new_k,
                       const T* __restrict__ new_v, T* k_pool, T* v_pool,
                       const int* __restrict__ tables, const int* __restrict__ rows,
                       float* __restrict__ out, float* part, int* sync, int layer, int np,
                       int nkv, int hd, int bs, int max_nb, int nsplit, int bps, int prow,
                       int nbuf) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int G = VEC;               // K row groups: bs threads / (bs/VEC) per row
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int kvd = nkv * hd;
  const int last = WRITE ? rows[b] : rows[b] - 1;  // the last token attended
  const int nblk = last < 0 ? 0 : last / bs + 1;
  const int nlive = (nblk + bps - 1) / bps;
  const size_t q_off = ((size_t)b * nkv * REP + (size_t)g * REP) * hd;
  if ((int)blockIdx.z >= max(nlive, 1)) return;  // no live token in this split
  if (nlive == 0) {  // a length-0 row of the read-only entry
    for (int i = tid; i < REP * hd; i += nt) out[q_off + i] = 0.f;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitSmem<T, REP> L(hd, bs, bps, prow, nbuf);
  unsigned char* ring = smem_raw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bars);
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);
  float* part_s = reinterpret_cast<float*>(smem_raw + L.part);
  float* keep_s = reinterpret_cast<float*>(smem_raw + L.keep);
  T* p_s = reinterpret_cast<T*>(smem_raw + L.p);
  float* max_s = reinterpret_cast<float*>(smem_raw + L.mx);
  float* lb_s = reinterpret_cast<float*>(smem_raw + L.lb);
  float* sum_s = reinterpret_cast<float*>(smem_raw + L.sum);
  float* bm_s = reinterpret_cast<float*>(smem_raw + L.bm);
  __shared__ int split_s, last_s;

  int* gsync = sync + (size_t)(b * nkv + g) * (2 + nsplit);  // ticket, done, flags
  const int pstride = 3 * REP + REP * hd;
  float* gpart = part + (size_t)(b * nkv + g) * nsplit * pstride;

  if (tid == 0) {
    if (nlive > 1) {
      // the ticket's round trip is spent warming the L2 with the blocks of
      // split blockIdx.z: tickets follow the grid order closely, and every
      // live block is warmed by one CTA
      const int z0 = blockIdx.z * bps, zn = min(bps, nblk - z0);
      const int* zrow = tables + (size_t)b * max_nb + z0;
      const uint32_t slice = (uint32_t)hd * bs * sizeof(T);
      for (int jj = 0; jj < zn; ++jj) {
        const size_t off = (((size_t)layer * np + (size_t)zrow[jj]) * kvd + (size_t)g * hd) * bs;
        bulk_prefetch_l2(k_pool + off, slice);
        bulk_prefetch_l2(v_pool + off, slice);
      }
    }
    split_s = nlive > 1 ? take_ticket(gsync) : 0;
    for (int i = 0; i < nbuf; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  for (int i = tid; i < REP * hd; i += nt) q_s[i] = to_f(q[q_off + i]);
  __syncthreads();
  const int split = split_s;
  const int j0 = split * bps, nb = min(bps, nblk - j0);  // this split's blocks
  const int* trow = tables + (size_t)b * max_nb + j0;
  const size_t head_off = (size_t)g * hd;

  // 1. the new token's column, this kv-head's rows only, by the split that
  // owns it, before any copy of its blocks is issued; the proxy fence and
  // the barrier order the writes before the bulk copies' reads
  if (WRITE && split == nlive - 1) {
    const size_t blk = (size_t)trow[last / bs - j0];
    const size_t base = (((size_t)layer * np + blk) * kvd + head_off) * bs + last % bs;
    const size_t src = (size_t)b * kvd + head_off;
    for (int d = tid; d < hd; d += nt) {
      k_pool[base + (size_t)d * bs] = new_k[src + d];
      v_pool[base + (size_t)d * bs] = new_v[src + d];
    }
    fence_async_global();
    __syncthreads();
  }

  // The pieces in the order they are used: every K piece of the split's
  // blocks (scores), then every V piece (P.V); piece i lands in ring slot
  // i % nbuf. Thread 0 keeps nbuf pieces in flight; where a block's slice
  // takes more pieces than the ring holds, a barrier frees them one by one.
  const int npk = (hd + prow - 1) / prow;  // pieces per slice
  const int total = 2 * nb * npk;
  const size_t piece_bytes = (size_t)prow * bs * sizeof(T);
  auto piece_src = [&](int i) -> const T* {
    const int jj = (i % (nb * npk)) / npk, r0 = (i % npk) * prow;
    const T* pool = i < nb * npk ? k_pool : v_pool;
    return pool + (((size_t)layer * np + (size_t)trow[jj]) * kvd + head_off + r0) * bs;
  };
  int issued = 0;  // thread 0: the pieces issued
  int freed = 0;   // every thread: the pieces before it are free
  auto refill = [&](int done) {  // every thread, past a barrier after piece done - 1
    freed = done;
    if (tid != 0) return;
    for (; issued < min(done + nbuf, total); ++issued) {
      const uint32_t bytes = (uint32_t)min(prow, hd - (issued % npk) * prow) * bs * sizeof(T);
      uint64_t* br = &bar[issued % nbuf];
      mbar_expect_tx(br, bytes);
      bulk_load(ring + (size_t)(issued % nbuf) * piece_bytes, piece_src(issued), bytes, br);
    }
  };
  auto piece_at = [&](int i) -> const T* {  // piece i's rows, once landed
    if (i >= freed + nbuf) {  // the ring holds pieces still read: free them first
      __syncthreads();
      refill(i);
    }
    mbar_wait(&bar[i % nbuf], (i / nbuf) & 1);
    return reinterpret_cast<const T*>(ring + (size_t)(i % nbuf) * piece_bytes);
  };
  refill(0);

  // 2. scores of the split's blocks, thread t = token t of a block: the
  // first block's stay in registers, later ones in keep_s (each thread
  // reads back only its own); each block's max to bm_s, the split's to smx
  const int nv = bs / VEC, kc = tid % nv, kg = tid / nv;
  float s0[REP], smx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) smx[r] = -INFINITY;
  int i = 0;  // the next piece
  for (int jj = 0; jj < nb; ++jj) {
    // a. partial scores of VEC tokens over this thread's K rows kg, kg+G, ...
    float sp[REP][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sp[r][e] = 0.f;
    for (int pc = 0; pc < npk; ++pc, ++i) {
      const T* kt = piece_at(i);
      const int r0 = pc * prow, nr = min(prow, hd - r0);
#pragma unroll 4
      for (int d = kg; d < nr; d += G) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kt + (size_t)d * bs + kc * VEC);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float qd = q_s[r * hd + r0 + d];
#pragma unroll
          for (int x = 0; x < VEC; ++x) sp[r][x] += qd * to_f(e[x]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float4* dst = reinterpret_cast<float4*>(part_s + (kg * REP + r) * bs + kc * VEC);
#pragma unroll
      for (int x = 0; x < VEC; x += 4)
        dst[x / 4] = make_float4(sp[r][x], sp[r][x + 1], sp[r][x + 2], sp[r][x + 3]);
    }
    __syncthreads();  // every thread is done with this block's K pieces
    refill(i);

    // b. whole scores, the mask, the block's max
    const bool live = (j0 + jj) * bs + tid <= last;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) v += part_s[(k * REP + r) * bs + tid];
      v = live ? v : -1e30f;
      if (jj == 0)
        s0[r] = v;
      else
        keep_s[((jj - 1) * REP + r) * bs + tid] = v;
      const float mx = warp_max(v);
      if (lane == 0) max_s[r * 32 + warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, max_s[r * 32 + w]);
      smx[r] = fmaxf(smx[r], mx);
      if (tid == 0) bm_s[jj * REP + r] = mx;
    }
  }

  __syncthreads();  // bm_s is complete

  // 3. look back: the max of every earlier split's scores seeds the
  // recurrence, so P is rounded against one walk's running max
  float* mypart = gpart + (size_t)split * pstride;  // smax | m | l | acc
  float m[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) m[r] = -INFINITY;
  if (nlive > 1) {
    if (tid == 0) publish_max<REP>(gsync, mypart, split, smx);
    look_back<REP>(gsync, gpart, pstride, split, nt, m);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mx = warp_max(m[r]);
      if (lane == 0) lb_s[r * 32 + warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, lb_s[r * 32 + w]);
      m[r] = mx;
    }
  }

  // 4. the online softmax over the split's blocks from that max: P
  // rounded to the pool dtype into p_s, l summed from the unrounded f32
  // P; then P.V from the V pieces, thread (vd, vpart) over its slice of V
  // row vd, its 16-byte vectors taken from a rotated start so that the
  // threads of a phase read different banks
  const int tp = nt / hd, tpt = bs / tp;
  const int vd = tid / tp, vpart = tid % tp;
  const int nvv = tpt / VEC, rot = vd % nvv;
  float l[REP], acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) l[r] = acc[r] = 0.f;
  for (int jj = 0; jj < nb; ++jj) {
    float alpha[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float sc = jj == 0 ? s0[r] : keep_s[((jj - 1) * REP + r) * bs + tid];
      const float m_new = fmaxf(m[r], bm_s[jj * REP + r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      const float p = exp2f(sc - m_new);
      p_s[r * bs + tid] = from_f<T>(p);
      const float ps = warp_sum(p);
      if (lane == 0) sum_s[r * 32 + warp] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += sum_s[r * 32 + w];
      l[r] = l[r] * alpha[r] + sum;
    }
    float pv[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) pv[r] = 0.f;
    for (int pc = 0; pc < npk; ++pc, ++i) {
      const T* vt = piece_at(i);
      const int r0 = pc * prow;
      if (vd >= r0 && vd < r0 + prow) {
        const T* vrow = vt + (size_t)(vd - r0) * bs + vpart * tpt;
        const T* pr = p_s + vpart * tpt;
        int c = rot;
#pragma unroll 4
        for (int u = 0; u < nvv; ++u) {
          const uint4 vv = *reinterpret_cast<const uint4*>(vrow + c * VEC);
          const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const uint4 pp = *reinterpret_cast<const uint4*>(pr + r * bs + c * VEC);
            const T* pe = reinterpret_cast<const T*>(&pp);
#pragma unroll
            for (int x = 0; x < VEC; ++x) pv[r] += to_f(pe[x]) * to_f(ve[x]);
          }
          if (++c == nvv) c = 0;
        }
      }
    }
    // the tp threads of one V row are neighbouring lanes
    for (int o = tp >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r) pv[r] += __shfl_xor_sync(0xffffffffu, pv[r], o);
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r] = acc[r] * alpha[r] + pv[r];
    __syncthreads();  // p_s, sum_s and this block's V pieces are free
    refill(i);
  }

  // 5. one live split finalises; several leave their partial states, and
  // the last to finish combines them in split order
  if (nlive == 1) {
    if (vpart == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) out[q_off + (size_t)r * hd + vd] = acc[r] / fmaxf(l[r], 1e-30f);
    }
    return;
  }
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
  if (!last_split(gsync, nlive, &last_s)) return;
  combine_splits<REP>(gpart, pstride, nlive, hd, nt, out + q_off, part_s, gsync);
}

// int8 decode, grid (nkv, b), blockDim.x == bs. WRITE (row 5): write row
// b's pre-quantized column (this kv-head's hd bytes of new_k/new_v, its K
// and V scale) at positions[b], then attend over 0..positions[b]. !WRITE
// (row 4): attend over 0..rows[b]-1, rows = lengths; a row of length 0
// gets 0. new_* are unused when !WRITE.
template <typename Q, int REP, bool WRITE>
__global__ void paged_decode_quant_kernel(const Q* __restrict__ q,
                                          const int8_t* __restrict__ new_k,
                                          const int8_t* __restrict__ new_v,
                                          const float* __restrict__ new_ks,
                                          const float* __restrict__ new_vs, int8_t* k_pool,
                                          int8_t* v_pool, float* k_scale, float* v_scale,
                                          const int* __restrict__ tables,
                                          const int* __restrict__ rows,
                                          float* __restrict__ out, int layer, int np, int nkv,
                                          int hd, int bs, int max_nb) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int kvd = nkv * hd;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* q_s = smem;

  const int last = WRITE ? rows[b] : rows[b] - 1;
  const int* trow = tables + (size_t)b * max_nb;
  const size_t head_off = (size_t)g * hd;

  // 1. the new token's column: this kv-head's bytes and its two scales
  if constexpr (WRITE) {
    const size_t blk = (size_t)trow[last / bs];
    const int col = last % bs;
    const size_t base = (((size_t)layer * np + blk) * kvd + head_off) * bs + col;
    const size_t src = (size_t)b * kvd + head_off;
    for (int d = tid; d < hd; d += blockDim.x) {
      k_pool[base + (size_t)d * bs] = new_k[src + d];
      v_pool[base + (size_t)d * bs] = new_v[src + d];
    }
    if (tid == 0) {
      const size_t so = (((size_t)layer * np + blk) * nkv + g) * bs + col;
      k_scale[so] = new_ks[(size_t)b * nkv + g];
      v_scale[so] = new_vs[(size_t)b * nkv + g];
    }
  }
  // 2. queries
  const size_t q_off = ((size_t)b * nkv * REP + (size_t)g * REP) * hd;
  for (int i = tid; i < REP * hd; i += blockDim.x) q_s[i] = to_f(q[q_off + i]);
  __syncthreads();  // orders the column write above before the reads below

  // 3. online softmax over the row's live blocks (none for a length-0 row)
  float m[REP], l[REP], acc[REP];
  if (last >= 0) {  // uniform over the CTA
    walk_blocks<int8_t, REP, true>(k_pool, v_pool, trow, layer, np, kvd, head_off, hd, bs, last,
                                   smem, m, l, acc, Scales{k_scale, v_scale, nkv, g});
  } else {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      l[r] = 0.f;
      acc[r] = 0.f;
    }
  }

  // 4. finalise: attn [B, NH, HD] f32
  const int tp = blockDim.x / hd, vd = tid / tp, vpart = tid % tp;
  if (vpart == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) out[q_off + (size_t)r * hd + vd] = acc[r] / fmaxf(l[r], 1e-30f);
  }
}

// grid (nkv, b, ceil(t_fed * rep / RC)), blockDim.x == bs. Local query row
// i = t * rep + rr of kv-head g is fed token t's head g * rep + rr; this
// CTA takes rows blockIdx.z * RC + [0, RC). q of type Q, pools of type T.
template <typename Q, typename T, int RC, bool QUANT>
__device__ __forceinline__ void verify_body(const Q* __restrict__ q, const T* k_pool,
                                            const T* v_pool, const int* __restrict__ tables,
                                            const int* __restrict__ qstart,
                                            float* __restrict__ acc_out,
                                            float* __restrict__ m_out,
                                            float* __restrict__ l_out, int layer, int np,
                                            int nkv, int rep, int t_fed, int hd, int bs,
                                            int max_nb, Scales sc) {
  const int g = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * RC;
  const int nh = nkv * rep, nrows = t_fed * rep;
  const int kvd = nkv * hd;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* q_s = smem;
  const int qs = qstart[b];

  // query rows; rows past the last (chunk padding) are zeros and never stored
  for (int i = tid; i < RC * hd; i += blockDim.x) {
    const int row = row0 + i / hd, d = i % hd;
    float v = 0.f;
    if (row < nrows) {
      const int t = row / rep, h = g * rep + row % rep;
      v = to_f(q[(((size_t)b * t_fed + t) * nh + h) * hd + d]);
    }
    q_s[i] = v;
  }

  float m[RC], l[RC], acc[RC];
  if (qs > 0) {  // uniform over the CTA
    __syncthreads();
    walk_blocks<T, RC, QUANT>(k_pool, v_pool, tables + (size_t)b * max_nb, layer, np, kvd,
                              (size_t)g * hd, hd, bs, qs - 1, smem, m, l, acc, sc);
  } else {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      m[r] = -1e30f;
      l[r] = 0.f;
      acc[r] = 0.f;
    }
  }

  // unfinalised partials: acc [B, T, NH, HD], m and l [B, T, NH]
  const int tp = blockDim.x / hd, vd = tid / tp, vpart = tid % tp;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int row = row0 + r;
    if (row >= nrows) break;
    const size_t o = ((size_t)b * t_fed + row / rep) * nh + g * rep + row % rep;
    if (vpart == 0) acc_out[o * hd + vd] = acc[r];
    if (tid == 0) {
      m_out[o] = m[r];
      l_out[o] = l[r];
    }
  }
}

template <typename T, int RC>
__global__ void paged_verify_kernel(const T* __restrict__ q, const T* k_pool, const T* v_pool,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ qstart, float* __restrict__ acc_out,
                                    float* __restrict__ m_out, float* __restrict__ l_out,
                                    int layer, int np, int nkv, int rep, int t_fed, int hd,
                                    int bs, int max_nb) {
  verify_body<T, T, RC, false>(q, k_pool, v_pool, tables, qstart, acc_out, m_out, l_out, layer,
                               np, nkv, rep, t_fed, hd, bs, max_nb, Scales{});
}

// int8 pools, q of type Q (f32 or bf16)
template <typename Q, int RC>
__global__ void paged_verify_quant_kernel(const Q* __restrict__ q, const int8_t* k_pool,
                                          const int8_t* v_pool, const float* k_scale,
                                          const float* v_scale, const int* __restrict__ tables,
                                          const int* __restrict__ qstart,
                                          float* __restrict__ acc_out,
                                          float* __restrict__ m_out, float* __restrict__ l_out,
                                          int layer, int np, int nkv, int rep, int t_fed,
                                          int hd, int bs, int max_nb) {
  verify_body<Q, int8_t, RC, true>(q, k_pool, v_pool, tables, qstart, acc_out, m_out, l_out,
                                   layer, np, nkv, rep, t_fed, hd, bs, max_nb,
                                   Scales{k_scale, v_scale, nkv, (int)blockIdx.x});
}

// The commit of one CTA of grid (ceil(kvd / kCommitSlice), b_rows,
// n_layers), kCommitSlice threads: elements [d0, d0 + kCommitSlice) of the
// T columns of (layer, row b). W is an unsigned type of the element's
// width: the commit copies bits. On return blk[t] and col[t] hold fed
// token t's pool block (0 when rejected) and column, for every thread.
template <typename W>
__device__ __forceinline__ void commit_slice(const W* __restrict__ new_k,
                                             const W* __restrict__ new_v, W* k_pool, W* v_pool,
                                             const int* __restrict__ tables,
                                             const int* __restrict__ qstart,
                                             const int* __restrict__ commit_len, int np,
                                             int b_rows, int t_fed, int kvd, int bs, int max_nb,
                                             int* blk, int* col) {
  __shared__ W sk[kMaxFed][kCommitSlice];
  __shared__ W sv[kMaxFed][kCommitSlice];
  __shared__ size_t dst[kMaxFed];  // element offset of (layer, block, row 0, column)
  const int d0 = blockIdx.x * kCommitSlice, b = blockIdx.y, layer = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid < t_fed) {
    const int pos = qstart[b] + tid;
    const int slot = min(max(pos / bs, 0), max_nb - 1);
    blk[tid] = tid < commit_len[b] ? tables[(size_t)b * max_nb + slot] : 0;
    col[tid] = pos % bs;
    dst[tid] = ((size_t)layer * np + (size_t)blk[tid]) * kvd * bs + col[tid];
  }
  const int d = d0 + tid;
  if (d < kvd) {
    for (int t = 0; t < t_fed; ++t) {
      const size_t src = (((size_t)layer * b_rows + b) * t_fed + t) * kvd + d;
      sk[t][tid] = new_k[src];
      sv[t][tid] = new_v[src];
    }
  }
  __syncthreads();
  // token index fastest: a pool row's consecutive columns go out together
  const int n = min(kCommitSlice, kvd - d0);
  for (int i = tid; i < n * t_fed; i += blockDim.x) {
    const int dd = i / t_fed, t = i % t_fed;
    const size_t o = dst[t] + (size_t)(d0 + dd) * bs;
    k_pool[o] = sk[t][dd];
    v_pool[o] = sv[t][dd];
  }
}

template <typename W>
__global__ void paged_commit_kernel(const W* __restrict__ new_k, const W* __restrict__ new_v,
                                    W* k_pool, W* v_pool, const int* __restrict__ tables,
                                    const int* __restrict__ qstart,
                                    const int* __restrict__ commit_len, int np, int b_rows,
                                    int t_fed, int kvd, int bs, int max_nb) {
  __shared__ int blk[kMaxFed], col[kMaxFed];
  commit_slice<W>(new_k, new_v, k_pool, v_pool, tables, qstart, commit_len, np, b_rows, t_fed,
                  kvd, bs, max_nb, blk, col);
}

// int8 commit: the bytes as above, then the T scales [n_layers, b_rows,
// t_fed, nkv] of the kv-heads whose rows start in this CTA's slice, token
// index fastest (consecutive columns of one scale row)
__global__ void paged_commit_quant_kernel(const uint8_t* __restrict__ new_k,
                                          const uint8_t* __restrict__ new_v,
                                          const float* __restrict__ new_ks,
                                          const float* __restrict__ new_vs, uint8_t* k_pool,
                                          uint8_t* v_pool, float* k_scale, float* v_scale,
                                          const int* __restrict__ tables,
                                          const int* __restrict__ qstart,
                                          const int* __restrict__ commit_len, int np,
                                          int b_rows, int t_fed, int kvd, int nkv, int bs,
                                          int max_nb) {
  __shared__ int blk[kMaxFed], col[kMaxFed];
  commit_slice<uint8_t>(new_k, new_v, k_pool, v_pool, tables, qstart, commit_len, np, b_rows,
                        t_fed, kvd, bs, max_nb, blk, col);
  const int d0 = blockIdx.x * kCommitSlice, b = blockIdx.y, layer = blockIdx.z;
  const int hd = kvd / nkv;
  const int g0 = (d0 + hd - 1) / hd, g1 = min(nkv, (d0 + kCommitSlice + hd - 1) / hd);
  for (int i = threadIdx.x; i < (g1 - g0) * t_fed; i += blockDim.x) {
    const int g = g0 + i / t_fed, t = i % t_fed;
    const size_t src = (((size_t)layer * b_rows + b) * t_fed + t) * nkv + g;
    const size_t o = (((size_t)layer * np + (size_t)blk[t]) * nkv + g) * bs + col[t];
    k_scale[o] = new_ks[src];
    v_scale[o] = new_vs[src];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The split walk's pieces and shared memory for one launch: pieces of at
// most kPieceBytes (whole slices where they fit; fewer rows where the rest
// of the layout leaves less room). A split of one block takes one ring
// slot (V's copy issued once K is read: half the shared memory, more CTAs
// an SM, 7% faster on even rows on an H100 than K and V in flight together,
// tools/paged_choices.py); a longer split a ring of two blocks' K and V
// pieces at most. False if no piece of 8 rows fits.
template <typename T, int REP>
bool split_geometry(int hd, int bs, int bps, int* prow, int* nbuf, size_t* smem) {
  const size_t row = (size_t)bs * sizeof(T);
  int pr = (int)(kPieceBytes / row) / 8 * 8;
  pr = pr < hd ? pr : hd;
  for (; pr >= 8; pr = pr / 16 * 8) {
    const int npk = (hd + pr - 1) / pr;
    const int nb = bps == 1 ? 1 : 2 * bps * npk < kRing ? 2 * bps * npk : kRing;
    const size_t bytes = SplitSmem<T, REP>(hd, bs, bps, pr, nb).total;
    if (bytes + 64 <= 227 * 1024) {  // and the static split_s, last_s
      *prow = pr;
      *nbuf = nb;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

template <typename T, int REP, bool WRITE, int MAXT>
cudaError_t launch_split_bounded(const void* q, const void* nk, const void* nv, void* kp,
                                 void* vp, const void* tables, const void* rows, void* out,
                                 void* part, void* sync, int b, int layer, int np, int nkv,
                                 int hd, int bs, int max_nb, int nsplit, cudaStream_t stream) {
  const int bps = (max_nb + nsplit - 1) / nsplit;  // blocks per split
  int prow, nbuf;
  size_t smem;
  if (!split_geometry<T, REP>(hd, bs, bps, &prow, &nbuf, &smem)) return cudaErrorInvalidValue;
  cudaError_t e = set_smem(paged_split_kernel<T, REP, WRITE, MAXT>, smem);
  if (e != cudaSuccess) return e;
  paged_split_kernel<T, REP, WRITE, MAXT><<<dim3(nkv, b, nsplit), bs, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(rows), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(sync), layer, np, nkv, hd, bs, max_nb, nsplit, bps, prow, nbuf);
  return cudaSuccess;
}

template <typename T, int REP, bool WRITE>
cudaError_t launch_split(const void* q, const void* nk, const void* nv, void* kp, void* vp,
                         const void* tables, const void* rows, void* out, void* part,
                         void* sync, int b, int layer, int np, int nkv, int hd, int bs,
                         int max_nb, int nsplit, cudaStream_t stream) {
  if (bs <= 256)
    return launch_split_bounded<T, REP, WRITE, 256>(q, nk, nv, kp, vp, tables, rows, out, part,
                                                    sync, b, layer, np, nkv, hd, bs, max_nb,
                                                    nsplit, stream);
  return launch_split_bounded<T, REP, WRITE, 1024>(q, nk, nv, kp, vp, tables, rows, out, part,
                                                   sync, b, layer, np, nkv, hd, bs, max_nb,
                                                   nsplit, stream);
}

template <typename T, int RC>
cudaError_t launch_verify(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* qstart, void* acc, void* m, void* l, int b, int t_fed,
                          int layer, int np, int nkv, int rep, int hd, int bs, int max_nb,
                          cudaStream_t stream) {
  const size_t smem = walk_smem_bytes<T, RC>(hd, bs);
  cudaError_t e = set_smem(paged_verify_kernel<T, RC>, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (t_fed * rep + RC - 1) / RC;
  paged_verify_kernel<T, RC><<<dim3(nkv, b, chunks), bs, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(qstart),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), layer, np,
      nkv, rep, t_fed, hd, bs, max_nb);
  return cudaSuccess;
}

// the chunk height: the query rows of one (row, kv-head), rounded up to a
// power of two, at most 8
template <typename T>
cudaError_t verify_rows(const void* q, const void* kp, const void* vp, const void* tables,
                        const void* qstart, void* acc, void* m, void* l, int b, int t_fed,
                        int layer, int np, int nkv, int rep, int hd, int bs, int max_nb,
                        cudaStream_t s) {
  const int r = t_fed * rep;
  if (r <= 1) return launch_verify<T, 1>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer, np, nkv, rep, hd, bs, max_nb, s);
  if (r <= 2) return launch_verify<T, 2>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer, np, nkv, rep, hd, bs, max_nb, s);
  if (r <= 4) return launch_verify<T, 4>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer, np, nkv, rep, hd, bs, max_nb, s);
  return launch_verify<T, 8>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer, np, nkv, rep, hd, bs, max_nb, s);
}

// the geometry both attention entries take
bool bad_geometry(int nh, int nkv, int hd, int bs) {
  if (nkv < 1 || nh % nkv) return true;
  const int rep = nh / nkv;
  if (rep != 1 && rep != 2 && rep != 4 && rep != 8) return true;
  return bs % 128 || bs > 1024 || hd < 1 || bs % hd || hd % 8 || (bs / hd) > 32 ||
         ((bs / hd) & (bs / hd - 1));
}

// the int8 walks load 16 codes a vector, so a V row slice of hd bytes
// must hold whole vectors
bool bad_quant_geometry(int nh, int nkv, int hd, int bs) {
  return bad_geometry(nh, nkv, hd, bs) || hd % 16;
}

// rows 3 (WRITE) and 2 (read-only; nk, nv null): the shared entry
template <bool WRITE>
int split_entry(const void* q, const void* nk, const void* nv, void* kp, void* vp,
                const void* tables, const void* rows, void* out, void* part, void* sync, int b,
                int layer, int np, int nh, int nkv, int hd, int bs, int max_nb, int nsplit,
                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(nh, nkv, hd, bs) || max_nb < 1 || nsplit < 1 || nsplit > max_nb ||
      nsplit > kMaxSplits || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
#define PA_SPLIT(T, REP)                                                                       \
  launch_split<T, REP, WRITE>(q, nk, nv, kp, vp, tables, rows, out, part, sync, b, layer, np, nkv, \
                              hd, bs, max_nb, nsplit, s)
    cudaError_t e;
    switch (nh / nkv * 2 + dtype) {
      case 2: e = PA_SPLIT(float, 1); break;
      case 3: e = PA_SPLIT(__nv_bfloat16, 1); break;
      case 4: e = PA_SPLIT(float, 2); break;
      case 5: e = PA_SPLIT(__nv_bfloat16, 2); break;
      case 8: e = PA_SPLIT(float, 4); break;
      case 9: e = PA_SPLIT(__nv_bfloat16, 4); break;
      case 16: e = PA_SPLIT(float, 8); break;
      case 17: e = PA_SPLIT(__nv_bfloat16, 8); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef PA_SPLIT
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <typename Q, int REP, bool WRITE>
cudaError_t launch_decode_quant(const void* q, const void* nk, const void* nv, const void* nks,
                                const void* nvs, void* kp, void* vp, void* ks, void* vs,
                                const void* tables, const void* rows, void* out, int b,
                                int layer, int np, int nkv, int hd, int bs, int max_nb,
                                cudaStream_t stream) {
  const size_t smem = walk_smem_bytes<int8_t, REP>(hd, bs);
  cudaError_t e = set_smem(paged_decode_quant_kernel<Q, REP, WRITE>, smem);
  if (e != cudaSuccess) return e;
  paged_decode_quant_kernel<Q, REP, WRITE><<<dim3(nkv, b), bs, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const int8_t*>(nk), static_cast<const int8_t*>(nv),
      static_cast<const float*>(nks), static_cast<const float*>(nvs), static_cast<int8_t*>(kp),
      static_cast<int8_t*>(vp), static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(rows), static_cast<float*>(out),
      layer, np, nkv, hd, bs, max_nb);
  return cudaSuccess;
}

// rows 5 (WRITE) and 4 (read-only; nk, nv, nks, nvs null): the shared entry
template <bool WRITE>
int decode_quant_entry(const void* q, const void* nk, const void* nv, const void* nks,
                       const void* nvs, void* kp, void* vp, void* ks, void* vs,
                       const void* tables, const void* rows, void* out, int b, int layer,
                       int np, int nh, int nkv, int hd, int bs, int max_nb, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_quant_geometry(nh, nkv, hd, bs) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
#define PA_DECODE_QUANT(Q, REP)                                                            \
  launch_decode_quant<Q, REP, WRITE>(q, nk, nv, nks, nvs, kp, vp, ks, vs, tables, rows, out, b, \
                                     layer, np, nkv, hd, bs, max_nb, s)
    cudaError_t e;
    switch (nh / nkv * 2 + dtype) {
      case 2: e = PA_DECODE_QUANT(float, 1); break;
      case 3: e = PA_DECODE_QUANT(__nv_bfloat16, 1); break;
      case 4: e = PA_DECODE_QUANT(float, 2); break;
      case 5: e = PA_DECODE_QUANT(__nv_bfloat16, 2); break;
      case 8: e = PA_DECODE_QUANT(float, 4); break;
      case 9: e = PA_DECODE_QUANT(__nv_bfloat16, 4); break;
      case 16: e = PA_DECODE_QUANT(float, 8); break;
      case 17: e = PA_DECODE_QUANT(__nv_bfloat16, 8); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef PA_DECODE_QUANT
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <typename Q, int RC>
cudaError_t launch_verify_quant(const void* q, const void* kp, const void* vp, const void* ks,
                                const void* vs, const void* tables, const void* qstart,
                                void* acc, void* m, void* l, int b, int t_fed, int layer,
                                int np, int nkv, int rep, int hd, int bs, int max_nb,
                                cudaStream_t stream) {
  const size_t smem = walk_smem_bytes<int8_t, RC>(hd, bs);
  cudaError_t e = set_smem(paged_verify_quant_kernel<Q, RC>, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (t_fed * rep + RC - 1) / RC;
  paged_verify_quant_kernel<Q, RC><<<dim3(nkv, b, chunks), bs, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(qstart),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), layer, np,
      nkv, rep, t_fed, hd, bs, max_nb);
  return cudaSuccess;
}

// the chunk height as for verify_rows
template <typename Q>
cudaError_t verify_quant_rows(const void* q, const void* kp, const void* vp, const void* ks,
                              const void* vs, const void* tables, const void* qstart,
                              void* acc, void* m, void* l, int b, int t_fed, int layer, int np,
                              int nkv, int rep, int hd, int bs, int max_nb, cudaStream_t s) {
#define PA_VERIFY_QUANT(RC)                                                                   \
  launch_verify_quant<Q, RC>(q, kp, vp, ks, vs, tables, qstart, acc, m, l, b, t_fed, layer, np, \
                             nkv, rep, hd, bs, max_nb, s)
  const int r = t_fed * rep;
  if (r <= 1) return PA_VERIFY_QUANT(1);
  if (r <= 2) return PA_VERIFY_QUANT(2);
  if (r <= 4) return PA_VERIFY_QUANT(4);
  return PA_VERIFY_QUANT(8);
#undef PA_VERIFY_QUANT
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, new_k/new_v and pools share it).
// The caller guarantees contiguous tensors with 16-byte aligned storage,
// nh / nkv in {1, 2, 4, 8}, bs % 128 == 0 and bs <= 1024, hd dividing bs
// with (bs / hd) a power of two <= 32 and hd % 8 == 0, and
// positions[b] / bs < max_nb. The context of each row is cut into nsplit
// <= min(max_nb, 256) runs of ceil(max_nb / nsplit) blocks; part is f32
// scratch of b * nkv * nsplit * (3 + hd) * nh / nkv floats, sync b * nkv *
// (2 + nsplit) ints, zero (each launch leaves it zero; launches sharing it
// run in stream order).
extern "C" int paged_attend_update_fwd(const void* q, const void* nk, const void* nv,
                                       void* kp, void* vp, const void* tables,
                                       const void* positions, void* out, void* part,
                                       void* sync, int b, int layer, int np, int nh, int nkv,
                                       int hd, int bs, int max_nb, int nsplit, int dtype,
                                       void* stream) {
  return split_entry<true>(q, nk, nv, kp, vp, tables, positions, out, part, sync, b, layer, np,
                           nh, nkv, hd, bs, max_nb, nsplit, dtype, stream);
}

// Row 2: the same geometry and scratch, nothing written; lengths[b] tokens
// read, with (lengths[b] - 1) / bs < max_nb.
extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, void* out,
                                   void* part, void* sync, int b, int layer, int np, int nh,
                                   int nkv, int hd, int bs, int max_nb, int nsplit, int dtype,
                                   void* stream) {
  return split_entry<false>(q, nullptr, nullptr, const_cast<void*>(kp), const_cast<void*>(vp),
                            tables, lengths, out, part, sync, b, layer, np, nh, nkv, hd, bs,
                            max_nb, nsplit, dtype, stream);
}

// q [b, t_fed, nh, hd] pre-scaled, in the pools' dtype; acc [b, t_fed, nh,
// hd], m and l [b, t_fed, nh], all f32. The geometry is that of
// paged_attend_update_fwd, with 1 <= t_fed <= 8 and (qstart[b] - 1) / bs <
// max_nb for every row with qstart[b] > 0.
extern "C" int paged_attention_verify_fwd(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* qstart, void* acc,
                                          void* m, void* l, int b, int t_fed, int layer,
                                          int np, int nh, int nkv, int hd, int bs,
                                          int max_nb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_geometry(nh, nkv, hd, bs) || t_fed < 1 || t_fed > kMaxFed)
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
    cudaError_t e;
    if (dtype == 0)
      e = verify_rows<float>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer, np, nkv,
                             nh / nkv, hd, bs, max_nb, s);
    else if (dtype == 1)
      e = verify_rows<__nv_bfloat16>(q, kp, vp, tables, qstart, acc, m, l, b, t_fed, layer,
                                     np, nkv, nh / nkv, hd, bs, max_nb, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// new_k/new_v [n_layers, b, t_fed, kvd] in the pools' dtype, pools [n_layers,
// np, kvd, bs]; tables [b, max_nb], qstart and commit_len [b] int32, with
// 1 <= t_fed <= 8 and (qstart[b] + commit_len[b] - 1) / bs < max_nb.
extern "C" int paged_verify_commit_fwd(const void* nk, const void* nv, void* kp, void* vp,
                                       const void* tables, const void* qstart,
                                       const void* commit_len, int n_layers, int b,
                                       int t_fed, int np, int kvd, int bs, int max_nb,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_fed < 1 || t_fed > kMaxFed || kvd < 1 || bs < 1 || max_nb < 1)
    return (int)cudaErrorInvalidValue;
  if (b > 0 && n_layers > 0) {
    const dim3 grid((kvd + kCommitSlice - 1) / kCommitSlice, b, n_layers);
    const int* tb = static_cast<const int*>(tables);
    const int* qs = static_cast<const int*>(qstart);
    const int* cl = static_cast<const int*>(commit_len);
    if (dtype == 0)
      paged_commit_kernel<uint32_t><<<grid, kCommitSlice, 0, s>>>(
          static_cast<const uint32_t*>(nk), static_cast<const uint32_t*>(nv),
          static_cast<uint32_t*>(kp), static_cast<uint32_t*>(vp), tb, qs, cl, np, b, t_fed,
          kvd, bs, max_nb);
    else if (dtype == 1)
      paged_commit_kernel<uint16_t><<<grid, kCommitSlice, 0, s>>>(
          static_cast<const uint16_t*>(nk), static_cast<const uint16_t*>(nv),
          static_cast<uint16_t*>(kp), static_cast<uint16_t*>(vp), tb, qs, cl, np, b, t_fed,
          kvd, bs, max_nb);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The int8 entries: pools int8 [n_layers, np, kvd, bs], scale pools f32
// [n_layers, np, nkv, bs]; q [b, nh, hd] (verify: [b, t_fed, nh, hd])
// pre-scaled, dtype 0 = float32, 1 = bfloat16. The geometry is that of the
// entries above with hd % 16 == 0. Row 5: new_k/new_v int8 [b, kvd],
// new_ks/new_vs f32 [b, nkv], written at positions[b]; row 4: lengths[b]
// tokens read, (lengths[b] - 1) / bs < max_nb.
extern "C" int paged_attend_update_quant_fwd(const void* q, const void* nk, const void* nv,
                                             const void* nks, const void* nvs, void* kp,
                                             void* vp, void* ks, void* vs, const void* tables,
                                             const void* positions, void* out, int b,
                                             int layer, int np, int nh, int nkv, int hd,
                                             int bs, int max_nb, int dtype, void* stream) {
  return decode_quant_entry<true>(q, nk, nv, nks, nvs, kp, vp, ks, vs, tables, positions, out,
                                  b, layer, np, nh, nkv, hd, bs, max_nb, dtype, stream);
}

extern "C" int paged_attention_quant_fwd(const void* q, const void* kp, const void* vp,
                                         const void* ks, const void* vs, const void* tables,
                                         const void* lengths, void* out, int b, int layer,
                                         int np, int nh, int nkv, int hd, int bs, int max_nb,
                                         int dtype, void* stream) {
  return decode_quant_entry<false>(q, nullptr, nullptr, nullptr, nullptr,
                                   const_cast<void*>(kp), const_cast<void*>(vp),
                                   const_cast<void*>(ks), const_cast<void*>(vs), tables,
                                   lengths, out, b, layer, np, nh, nkv, hd, bs, max_nb, dtype,
                                   stream);
}

extern "C" int paged_attention_verify_quant_fwd(const void* q, const void* kp, const void* vp,
                                                const void* ks, const void* vs,
                                                const void* tables, const void* qstart,
                                                void* acc, void* m, void* l, int b, int t_fed,
                                                int layer, int np, int nh, int nkv, int hd,
                                                int bs, int max_nb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_quant_geometry(nh, nkv, hd, bs) || t_fed < 1 || t_fed > kMaxFed)
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
    cudaError_t e;
    if (dtype == 0)
      e = verify_quant_rows<float>(q, kp, vp, ks, vs, tables, qstart, acc, m, l, b, t_fed,
                                   layer, np, nkv, nh / nkv, hd, bs, max_nb, s);
    else if (dtype == 1)
      e = verify_quant_rows<__nv_bfloat16>(q, kp, vp, ks, vs, tables, qstart, acc, m, l, b,
                                           t_fed, layer, np, nkv, nh / nkv, hd, bs, max_nb, s);
    else
      return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// new_k/new_v int8 [n_layers, b, t_fed, kvd], new_ks/new_vs f32 [n_layers,
// b, t_fed, nkv]; otherwise paged_verify_commit_fwd's contract
extern "C" int paged_verify_commit_quant_fwd(const void* nk, const void* nv, const void* nks,
                                             const void* nvs, void* kp, void* vp, void* ks,
                                             void* vs, const void* tables, const void* qstart,
                                             const void* commit_len, int n_layers, int b,
                                             int t_fed, int np, int kvd, int nkv, int bs,
                                             int max_nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_fed < 1 || t_fed > kMaxFed || kvd < 1 || nkv < 1 || kvd % nkv || bs < 1 || max_nb < 1)
    return (int)cudaErrorInvalidValue;
  if (b > 0 && n_layers > 0) {
    const dim3 grid((kvd + kCommitSlice - 1) / kCommitSlice, b, n_layers);
    paged_commit_quant_kernel<<<grid, kCommitSlice, 0, s>>>(
        static_cast<const uint8_t*>(nk), static_cast<const uint8_t*>(nv),
        static_cast<const float*>(nks), static_cast<const float*>(nvs),
        static_cast<uint8_t*>(kp), static_cast<uint8_t*>(vp), static_cast<float*>(ks),
        static_cast<float*>(vs), static_cast<const int*>(tables),
        static_cast<const int*>(qstart), static_cast<const int*>(commit_len), np, b, t_fed,
        kvd, nkv, bs, max_nb);
  }
  return (int)cudaGetLastError();
}

namespace {
template <typename K>
int occupancy(K kernel, int bs, size_t smem) {
  int n = -1;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, bs, smem) != cudaSuccess)
    return -1;
  return n;
}

template <int R>
int quant_occupancy(int kind, int hd, int bs) {
  const size_t smem = walk_smem_bytes<int8_t, R>(hd, bs);
  if (kind == 0) return occupancy(paged_decode_quant_kernel<__nv_bfloat16, R, true>, bs, smem);
  return occupancy(paged_verify_quant_kernel<__nv_bfloat16, R>, bs, smem);
}
}  // namespace

// CTAs per SM that the int8 walks reach with bf16 q, bs threads and their
// shared memory: kind 0 the decode kernel at REP = rows, kind 1 the verify
// kernel at RC = rows; -1 on a bad argument or a CUDA error
extern "C" int paged_quant_occupancy(int kind, int rows, int hd, int bs) {
  switch (rows) {
    case 1: return quant_occupancy<1>(kind, hd, bs);
    case 2: return quant_occupancy<2>(kind, hd, bs);
    case 4: return quant_occupancy<4>(kind, hd, bs);
    case 8: return quant_occupancy<8>(kind, hd, bs);
    default: return -1;
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
