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
// of every layer is written into the row's block. The rejected and
// padding columns, which the JAX commit schedule routes into the null
// block 0, are not written at all, and block 0 never is: every other
// block gets the JAX schedule's bits, block 0's contents are unspecified.
// A bare scatter: the TPU kernel's first-visit and revisit flags exist
// only for Pallas's aliasing rules.
//
// What bounds them on this card: bytes. The attention entries read each
// row's K and V columns once and do about 4 * R * HD operations per token
// for R query rows of a kv-head, under 2 operations per byte at R <= 8
// (B = 8 rows of 1024 tokens at KVD = 4096 in bf16 is 134 MB, 40 us per
// layer; int8 halves the bytes and adds 4 bytes of scales per kv-head
// and token, 4 operations per byte at R <= 8). The commit is bound by
// sectors, not bytes: it reads 2 * L * B * n * KVD elements (n live
// columns a row) and writes as many, but a row's window of n <= T
// consecutive columns lands in each of the KVD rows of a pool block, rows
// bs elements apart, so each (layer, row, pool row) costs one 32-byte
// sector written, two where the window crosses a sector edge. At L = 32, B
// = 8, KVD = 4096 that is 2 M pool rows of K and V: 67-84 MB, 20-25 us at
// 3.35 TB/s, against a byte bound of 12.5 us at n = T = 5 (2.5 us at n =
// 1, where the sectors stay the same). Written as scattered partial
// sectors, 256 bytes apart, they go far slower than the bandwidth (about
// 14-20 G sectors/s on an H100, see the commit's design below).
//
// Design of the attention entries (not the TPU's): the TPU walks one flat
// sequential schedule of (sequence, block) steps and pads each query row
// to the full KVD ("block-diagonal" q) so its matrix unit sees [R, KVD] x
// [KVD, bs]; for an MHA model that is NH times the useful work. Here a CTA
// of bs threads owns one (row, kv-head) pair, or a share of its context;
// its query rows sit in shared memory and the softmax is the online
// recurrence in f32 (exp2 on q pre-scaled by scale * log2(e), as the
// caller does). P is rounded to the pool dtype before P.V, and the
// normaliser sums the unrounded f32 P, as in the TPU kernels. A column
// past the row's last token never enters a product: its score is a
// selected -1e30, and in the last block's tail its V (over int8 pools its
// p times the V scale) is a selected 0, so stale NaN in a reused block
// cannot reach the result (0 * NaN is NaN). Only the
// online recurrence is implemented: the TPU default's tile-0-anchored
// "fixed-base" softmax overflows once a later tile's max exceeds tile 0's
// by ~100 log2 units.
//
// Rows 3 and 2, and over int8 pools rows 5 and 4 (paged_split_kernel), and
// rows 6 and 7 (paged_verify_split_kernel): one body (split_walk),
// redesigned for Hopper: flash-decoding.
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
// writes its result at once. Loads: one kv-head's slice of a pool block is
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
// The verify read (rows 6, 7) is the same walk over T * rep query rows of
// a (row, kv-head) in place of REP, in chunks of R rows (a height from
// {2, 4, 5, 8} that the wrapper picks so that llama_7b's 5 rows are not
// padded to 8; GQA's up to 64 rows take several chunks, each re-reading the
// blocks from L2), grid (kv-head x chunk, row, split); it writes nothing
// and returns the partial state unfinalised (the combine's unfinalised
// mode: acc = sum acc_t w_t, l = sum l_t w_t, m = max m_t). At R rows P.V
// reads R p's for every V element, so a verify thread sums DR = 2 V rows
// (int8: 4) over strided token vectors (each p read once for all of them)
// in place into its acc, and a shuffle over the row's lanes ends the sum
// after the last block. Over int8 pools K and V are 8-code loads (G = 8 partial rows),
// each block's K and V scales of the kv-head (bs f32, contiguous) arrive by
// bulk copy with the block's first K piece, and the splits skip the
// look-back (P is never rounded). The verify splits issue their first
// copies before the CTA's barrier and take no L2 warm-up. The int8 decode
// (rows 5 and 4) is the decode walk over int8 pools: REP query heads, q in
// f32 or bf16, the scales as in the verify read, no look-back, no L2
// warm-up, the first copies before the barrier (but for the owner of row
// 5's new column) and the verify read's P.V in place over 2 V rows a
// thread.
//
// Write before read, without a race (update entries, rows 3 and 5): the
// split whose run holds positions[b] writes only its own kv-head's HD rows
// of the new column (row 5: and the kv-head's one K and one V scale), then
// reads them: a proxy fence and a barrier order the writes before its
// bulk copies. No other CTA touches those bytes: the other splits of the
// row read earlier blocks only. Padding rows point their whole table at
// the reserved null block 0 with position 0; they all write block 0,
// column 0, concurrently. That is harmless: no live row ever reads block
// 0.
//
// Design of the commit (rows 8 and 9, paged_commit_kernel): around
// sectors, not elements. A window of a row's n <= T live columns is at
// most 8 consecutive elements of each pool row, so every (layer, row, pool
// row) costs one 32-byte sector written (two where the window crosses a
// sector or block edge), and on an H100 those scattered partial-sector
// writes, not bytes, set the time: about 0.15 ms (int8: 0.12) for the 2 M
// pool rows of llama_7b's commit whatever n is (tools/paged_choices.py).
// So each sector must be written once, by one store instruction, and
// nothing else written. A warp owns 16 pool rows of one (layer, row); lane
// (r, t) takes fed token t of rows r, r + 4, r + 8, r + 12, so one warp
// store writes 4 rows' whole windows (the coalescer merges a window's
// elements into one request per sector) and each lane finds its token's
// block and column once. Only live columns are written (t <
// commit_len[b]) and never block 0: at the serve-spec step's commit
// lengths (1 of T = 5 where nothing is accepted) that is one column a row
// where the JAX schedule writes five, four of them into block 0 from every
// row at once. No shared memory, no barrier, no division per element; the
// grid comes from the work, one warp an item. (One thread owning 8 rows,
// reading them as vectors and writing each row's window in the fewest
// aligned stores, issues 2-3 requests to each sector and took twice as
// long with every column accepted; an L2 prefetch of the target sectors
// before the stores cost more than it saved: tools/paged_choices.py.)
//
// The int8 entries (q in f32 or bf16, pools int8, scales f32). New
// columns arrive already quantized (the caller's kv_quant_columns, the one
// quantizer of prefill, decode and commit): the kernels copy bytes and
// scales and never requantize. One CTA owns one kv-head, so a token's K
// scale and V scale are scalars of the whole CTA: a score is s[t] = ks[t] *
// sum_d q[d] * k8[d, t], and P.V takes p'[t] = p[t] * vs[t], in f32 and NOT
// rounded (l sums the unscaled p), in the decode (rows 5, 4) and verify
// (row 7) walks alike. The TPU kernels dequantize every element first,
// f32(k8) * ks; the factored form differs from that only in f32 rounding.
// The int8 commit is the same body over 1-byte codes; the lanes of a
// kv-head's first row also write the head's window of f32 scales in the K
// and V scale pools, live columns only.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// caller's stream.
//
// The build compiles this file as several translation units at once, one
// nvcc each (paddle_tpu_torch/_build.py, PARTS), and links them into one
// library: -DBUILD_PART=n keeps only part n's entries, and so instantiates
// only the kernels they launch (the split walk's instantiations set the
// file's compile time). Without BUILD_PART one unit holds every part.
//   0 row 3 (bf16 and f32)      3 rows 5 and 4 (int8 decode)
//   1 row 2 (bf16 and f32)      4 row 7 (int8 verify)
//   2 row 6 (bf16 and f32)      5 rows 8 and 9 (the commit), the error
//                                 string and paged_quant_occupancy
#ifdef BUILD_PART
#define PAGED_PART(n) (BUILD_PART == (n))
#else
#define PAGED_PART(n) 1
#endif
#include <math.h>

#include <type_traits>

#include "split_common.cuh"
#include "vec_common.cuh"
#include "wgmma_common.cuh"  // mbarriers and 1-D bulk copies

namespace {

constexpr int kMaxFed = 8;        // verify and commit: fed tokens per row
// the commit: a lane a fed token, 32 / kMaxFed pool rows a warp store,
// kCommitSteps stores a warp item
constexpr int kCommitRowStep = 32 / kMaxFed;
constexpr int kCommitSteps = 4;
constexpr int kCommitWarpRows = kCommitRowStep * kCommitSteps;
constexpr int kCommitThreads = 256;

// ---------------------------------------------------------------------------
// rows 2-7: the split-context walk
// ---------------------------------------------------------------------------

constexpr int kRing = 4;          // ring slots at most: two blocks of K and V
constexpr int kPieceBytes = 32768;  // the most one bulk copy brings
constexpr int kMaxSplits = 256;   // the combine keeps each split's (m, l) in part_s

enum : int { kUpdate = 0, kRead = 1, kVerify = 2 };  // the walk's entries

// P's element type in shared memory: the pool's, f32 over int8 pools
template <typename T> struct PType { using type = T; };
template <> struct PType<int8_t> { using type = float; };
// elements a thread loads at once: a 16-byte vector; 8 codes (8 bytes) of
// an int8 pool, so that K's partial scores take 8 registers a row
template <typename T> constexpr int kVec = 16 / sizeof(T);
template <> constexpr int kVec<int8_t> = 8;

// four int8 codes packed in w as f32, exactly: each byte biased to
// unsigned and placed under the exponent of 2^23, then the bias removed
__device__ __forceinline__ void i8x4_to_f(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - 8388736.f;
}

// V elements of type E at p (V * sizeof(E) bytes, aligned to them, a
// multiple of 8) in shared memory, as f32
template <typename E, int V>
__device__ __forceinline__ void load_f(const E* p, float (&f)[V]) {
  if constexpr (std::is_same<E, int8_t>::value) {
    static_assert(V == 8, "int8: 8 codes a load");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f(w.x, f);
    i8x4_to_f(w.y, f + 4);
  } else {
    constexpr int E16 = 16 / sizeof(E);  // elements of one 16-byte vector
#pragma unroll
    for (int n = 0; n < V / E16; ++n) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[n];
      const E* e = reinterpret_cast<const E*>(&u);
#pragma unroll
      for (int x = 0; x < E16; ++x) f[n * E16 + x] = to_f(e[x]);
    }
  }
}

// The arguments of every entry of the split walk. q: [b, nh, hd] (decode)
// or [b, t_fed, nh, hd] (verify), pre-scaled, of the pools' type but over
// int8 pools (q_bf16: bf16, else f32). rows: positions (kUpdate), lengths
// (kRead) or qstart (kVerify). new_k, new_v: the new columns [b, kvd]
// (kUpdate), over int8 pools with their scales new_ks, new_vs [b, nkv].
// out: attn [b, nh, hd], or verify's acc [b, t_fed, nh, hd] with m_out,
// l_out [b, t_fed, nh]. part and sync: split_common.cuh's layouts, a group
// per (row, kv-head, chunk).
struct SplitArgs {
  const void* q;
  const void* new_k;
  const void* new_v;
  const float* new_ks;
  const float* new_vs;
  void* k_pool;
  void* v_pool;
  float* k_scale;
  float* v_scale;
  const int* tables;
  const int* rows;
  float* out;
  float* m_out;
  float* l_out;
  float* part;
  int* sync;
  int layer, np, nkv, hd, bs, max_nb, nsplit, bps, prow, nbuf;
  int rep, t_fed, nchunk, q_bf16;
};

// The rows of one verify chunk in the outputs: local row r is the chunk's
// query row row0 + r = t rep + rr, fed token t's head g rep + rr; row(r)
// is its index in acc [., hd], m and l, -1 for the chunk's padding
struct VerifyRows {
  float* acc;
  float* m;
  float* l;
  int bt, nh, grep, rep, row0, nrows;
  __device__ __forceinline__ int row(int r) const {
    const int x = row0 + r;
    return x < nrows ? (bt + x / rep) * nh + grep + x % rep : -1;
  }
};

// Shared memory of the split walk, byte offsets: the ring [nbuf][piece]
// | its barriers [kRing] | q_s [R, hd] f32 | part_s [G, R, bs] f32, and
// p_s [R, bs] in P's type over it once every score is summed (the combine
// takes it last) | keep_s [bps - 1, R, bs] f32 | max_s [R, bs / 32] f32 (a
// value per warp; the look-back's lb_s over it) | sum_s [R, bs / 32] f32 |
// bm_s [bps, R] f32 | int8 pools: ks_s, vs_s [bps, bs] f32, the split's K
// and V scales. Every region starts 16-byte aligned.
template <typename T, int R>
struct SplitSmem {
  size_t bars, q, part, p, keep, mx, lb, sum, bm, sc, total;
  __host__ __device__ SplitSmem(int hd, int bs, int bps, int prow, int nbuf) {
    constexpr int G = kVec<T>;
    bars = (size_t)nbuf * prow * bs * sizeof(T);
    q = bars + 16 * ((kRing + 1) / 2);  // the barriers, 16-byte aligned
    part = p = q + 4 * (size_t)R * hd;
    keep = part + 4 * (size_t)G * R * bs;
    mx = lb = keep + 4 * (size_t)(bps - 1) * R * bs;
    sum = mx + (size_t)R * bs / 8;  // R * (bs / 32) floats
    bm = sum + (size_t)R * bs / 8;
    sc = (bm + 4 * (size_t)bps * R + 15) / 16 * 16;
    total = std::is_same<T, int8_t>::value ? sc + 8 * (size_t)bps * bs
                                           : bm + 4 * (size_t)bps * R;
  }
};

// One CTA of the split walk, blockDim.x == bs. Decode (rows 3 and 2; 5
// and 4 over int8 pools): grid (nkv, b, nsplit), R = REP query heads of
// kv-head g. Verify (rows 6
// and 7): grid (nkv nchunk, b, nsplit), R = the chunk height, chunk c of
// kv-head g taking the (row, kv-head)'s query rows c R .. c R + R - 1 (past
// t_fed rep: zeros, never stored). Split z of a group takes the row's pool
// blocks [z bps, (z + 1) bps) of its live ones (the index z is a ticket in
// arrival order), a piece of prow rows of one K or V slice per bulk copy,
// nbuf pieces in flight. kUpdate (rows 3, 5): the split that owns
// positions[b] writes row b's new column there (row 5: with its K and V
// scale), then every split attends over its share of 0..positions[b].
// kRead (rows 2, 4): over 0..rows[b]-1, rows = lengths; a row of length 0
// gets 0. kVerify: over 0..qstart[b]-1, returning the unfinalised (acc, m,
// l); a row with qstart 0 gets acc = 0, l = 0, m = -1e30. int8 pools: each
// K or V slice's bs scales of kv-head g arrive by bulk copy with the
// slice's first K piece; a token's score is ks * (q . k8), and P.V takes p
// * vs in f32, unrounded (l sums p); the splits take no look-back.
template <typename T, int R, int MODE>
__device__ __forceinline__ void split_walk(const SplitArgs a) {
  constexpr bool WRITE = MODE == kUpdate, VERIFY = MODE == kVerify;
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  using PT = typename PType<T>::type;
  constexpr int VEC = kVec<T>;        // elements a thread loads at once
  constexpr int G = VEC;              // K row groups: bs threads / (bs/VEC) per row
  // P.V in place (the verify read, the int8 decode): a thread sums DR = 2
  // (the int8 verify read: 4) V rows at once into acc, a p read from shared
  // memory serving them all. Else (rows 3, 2) one V row's share a thread,
  // summed over its lanes block by block (the int8 decode ran 10-20% slower
  // so, and 13% slower at DR = 4, tools/paged_choices.py).
  constexpr bool INPLACE = VERIFY || QUANT;
  constexpr int DR = !INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;
  const int nchunk = VERIFY ? a.nchunk : 1;
  const int g = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int hd = a.hd, bs = a.bs, bps = a.bps, prow = a.prow, nbuf = a.nbuf;
  const int nkv = a.nkv, kvd = nkv * hd, layer = a.layer, np = a.np;
  const T* k_pool = static_cast<const T*>(a.k_pool);
  const T* v_pool = static_cast<const T*>(a.v_pool);
  const int last = WRITE ? a.rows[b] : a.rows[b] - 1;  // the last token attended
  const int nblk = last < 0 ? 0 : last / bs + 1;
  const int nlive = (nblk + bps - 1) / bps;
  // decode: the R heads of kv-head g are rows q_off / hd .. + R - 1 of q
  // and out; verify: the chunk's rows, vr.row(r)
  const size_t q_off = ((size_t)b * nkv * R + (size_t)g * R) * hd;
  const int nh = nkv * a.rep;
  const VerifyRows vr{a.out, a.m_out, a.l_out, b * a.t_fed, nh, g * a.rep, a.rep, chunk * R,
                      a.t_fed * a.rep};
  if ((int)blockIdx.z >= max(nlive, 1)) return;  // no live token in this split
  if (nlive == 0) {  // a length-0 row of rows 2, 4; a padding row of the verify read
    if constexpr (VERIFY) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = vr.row(r);
        if (o < 0 || tid >= hd) continue;
        a.out[(size_t)o * hd + tid] = 0.f;
        if (tid == 0) {
          a.m_out[o] = -1e30f;
          a.l_out[o] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < R * hd; i += nt) a.out[q_off + i] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitSmem<T, R> L(hd, bs, bps, prow, nbuf);
  unsigned char* ring = smem_raw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bars);
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);
  float* part_s = reinterpret_cast<float*>(smem_raw + L.part);
  float* keep_s = reinterpret_cast<float*>(smem_raw + L.keep);
  PT* p_s = reinterpret_cast<PT*>(smem_raw + L.p);
  float* max_s = reinterpret_cast<float*>(smem_raw + L.mx);
  float* lb_s = reinterpret_cast<float*>(smem_raw + L.lb);
  float* sum_s = reinterpret_cast<float*>(smem_raw + L.sum);
  float* bm_s = reinterpret_cast<float*>(smem_raw + L.bm);
  [[maybe_unused]] float* ks_s = reinterpret_cast<float*>(smem_raw + L.sc);
  [[maybe_unused]] float* vs_s = ks_s + (size_t)bps * bs;
  __shared__ int split_s, last_s;

  const int grp = (b * nkv + g) * nchunk + chunk;  // this CTA's group
  int* gsync = a.sync + (size_t)grp * (2 + a.nsplit);  // ticket, done, flags
  const int pstride = 3 * R + R * hd;
  float* gpart = a.part + (size_t)grp * a.nsplit * pstride;
  const size_t head_off = (size_t)g * hd;
  // the kv-head's bs scales of pool block blk (int8 pools)
  auto scale_off = [&](int blk) {
    return (((size_t)layer * np + (size_t)blk) * nkv + g) * bs;
  };

  // The split (set_split, from the ticket) and its pieces in the order
  // they are used: every K piece of the split's blocks (scores), then every
  // V piece (P.V); piece i lands in ring slot i % nbuf. Thread 0 keeps nbuf
  // pieces in flight; where a block's slice takes more pieces than the ring
  // holds, a barrier frees them one by one. Over int8 pools a block's first
  // K piece also brings its K and V scales into the split's own scale rows.
  int split = 0, j0 = 0, nb = 0, total = 0;  // nb: this split's blocks
  const int* trow = nullptr;
  const int npk = (hd + prow - 1) / prow;  // pieces per slice
  const size_t piece_bytes = (size_t)prow * bs * sizeof(T);
  auto set_split = [&](int z) {
    split = z;
    j0 = z * bps;
    nb = min(bps, nblk - j0);
    trow = a.tables + (size_t)b * a.max_nb + j0;
    total = 2 * nb * npk;
  };
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
      const bool scales = QUANT && issued < nb * npk && issued % npk == 0;
      mbar_expect_tx(br, bytes + (scales ? 8 * bs : 0));
      bulk_load(ring + (size_t)(issued % nbuf) * piece_bytes, piece_src(issued), bytes, br);
      if (scales) {
        const int jj = issued / npk;
        bulk_load(ks_s + (size_t)jj * bs, a.k_scale + scale_off(trow[jj]), 4 * bs, br);
        bulk_load(vs_s + (size_t)jj * bs, a.v_scale + scale_off(trow[jj]), 4 * bs, br);
      }
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

  if (tid == 0) {
    // rows 3, 2: the ticket's round trip is spent warming the L2 with the
    // blocks of split blockIdx.z (tickets follow the grid order closely,
    // and every live block is warmed by one CTA); verify and int8 decode:
    // no warm-up (it cost the verify read 10% and the int8 decode 3-15%,
    // tools/paged_choices.py), and the split's first pieces go out before
    // the barrier, but for the owner of row 5's new column, which writes
    // it first (step 1)
    int z = 0;
    if (VERIFY && nlive > 1) z = take_ticket(gsync);
    if (!VERIFY && !QUANT && nlive > 1) {
      const int z0 = blockIdx.z * bps, zn = min(bps, nblk - z0);
      const int* zrow = a.tables + (size_t)b * a.max_nb + z0;
      const uint32_t slice = (uint32_t)hd * bs * sizeof(T);
      for (int jj = 0; jj < zn; ++jj) {
        const size_t off = (((size_t)layer * np + (size_t)zrow[jj]) * kvd + head_off) * bs;
        bulk_prefetch_l2(k_pool + off, slice);
        bulk_prefetch_l2(v_pool + off, slice);
      }
    }
    if (!VERIFY && nlive > 1) z = take_ticket(gsync);
    split_s = z;
    for (int i = 0; i < nbuf; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
    if (VERIFY || (QUANT && !(WRITE && z == nlive - 1))) {
      set_split(z);
      refill(0);
    }
  }
  if constexpr (VERIFY) {
    // hd <= bs threads: thread d loads column d of the R rows, all in flight
    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = vr.row(r);
        const size_t src = (size_t)o * hd + tid;
        float v = 0.f;
        if (o >= 0) {
          if constexpr (QUANT)
            v = a.q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(a.q)[src])
                         : static_cast<const float*>(a.q)[src];
          else
            v = to_f(static_cast<const T*>(a.q)[src]);
        }
        q_s[r * hd + tid] = v;
      }
    }
  } else {
    for (int i = tid; i < R * hd; i += nt) {
      if constexpr (QUANT)
        q_s[i] = a.q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(a.q)[q_off + i])
                          : static_cast<const float*>(a.q)[q_off + i];
      else
        q_s[i] = to_f(static_cast<const T*>(a.q)[q_off + i]);
    }
  }
  __syncthreads();
  set_split(split_s);

  // 1. the new token's column, this kv-head's rows only (int8: and its K
  // and V scale), by the split that owns it, before any copy of its blocks
  // is issued; the proxy fence and the barrier order the writes before the
  // bulk copies' reads of the bytes and the scales
  if (WRITE && split == nlive - 1) {
    T* kw = static_cast<T*>(a.k_pool);
    T* vw = static_cast<T*>(a.v_pool);
    const T* new_k = static_cast<const T*>(a.new_k);
    const T* new_v = static_cast<const T*>(a.new_v);
    const int blk = trow[last / bs - j0];
    const size_t base = (((size_t)layer * np + blk) * kvd + head_off) * bs + last % bs;
    const size_t src = (size_t)b * kvd + head_off;
    for (int d = tid; d < hd; d += nt) {
      kw[base + (size_t)d * bs] = new_k[src + d];
      vw[base + (size_t)d * bs] = new_v[src + d];
    }
    if (QUANT && tid == 0) {
      a.k_scale[scale_off(blk) + last % bs] = a.new_ks[(size_t)b * nkv + g];
      a.v_scale[scale_off(blk) + last % bs] = a.new_vs[(size_t)b * nkv + g];
    }
    fence_async_global();
    __syncthreads();
  }

  if constexpr (!VERIFY) refill(0);  // (nothing more where issued above)

  // 2. scores of the split's blocks, thread t = token t of a block: the
  // first block's stay in registers, later ones in keep_s (each thread
  // reads back only its own); each block's max to bm_s, the split's to smx
  const int nv = bs / VEC, kc = tid % nv, kg = tid / nv;
  float s0[R], smx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) smx[r] = -INFINITY;
  int i = 0;  // the next piece
  for (int jj = 0; jj < nb; ++jj) {
    // a. partial scores of VEC tokens over this thread's K rows kg, kg+G, ...
    float sp[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sp[r][e] = 0.f;
    for (int pc = 0; pc < npk; ++pc, ++i) {
      const T* kt = piece_at(i);
      const int r0 = pc * prow, nr = min(prow, hd - r0);
#pragma unroll 4
      for (int d = kg; d < nr; d += G) {
        float kf[VEC];
        load_f<T, VEC>(kt + (size_t)d * bs + kc * VEC, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float qd = q_s[r * hd + r0 + d];
#pragma unroll
          for (int x = 0; x < VEC; ++x) sp[r][x] += qd * kf[x];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* dst = reinterpret_cast<float4*>(part_s + (kg * R + r) * bs + kc * VEC);
#pragma unroll
      for (int x = 0; x < VEC; x += 4)
        dst[x / 4] = make_float4(sp[r][x], sp[r][x + 1], sp[r][x + 2], sp[r][x + 3]);
    }
    __syncthreads();  // every thread is done with this block's K pieces
    refill(i);

    // b. whole scores (int8: times the token's K scale), the mask, the
    // block's max
    const bool live = (j0 + jj) * bs + tid <= last;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) v += part_s[(k * R + r) * bs + tid];
      if constexpr (QUANT) v *= ks_s[jj * bs + tid];
      v = live ? v : -1e30f;
      if (jj == 0)
        s0[r] = v;
      else
        keep_s[((jj - 1) * R + r) * bs + tid] = v;
      const float mx = warp_max(v);
      if (lane == 0) max_s[r * nwarps + warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, max_s[r * nwarps + w]);
      smx[r] = fmaxf(smx[r], mx);
      if (tid == 0) bm_s[jj * R + r] = mx;
    }
  }

  __syncthreads();  // bm_s is complete

  // 3. look back: the max of every earlier split's scores seeds the
  // recurrence, so P is rounded against one walk's running max. int8
  // pools never round P, and their splits start from their own max (the
  // look-back only moved f32 rounding there and cost row 7 10%,
  // tools/paged_choices.py; the plain version's split form does the same)
  float* mypart = gpart + (size_t)split * pstride;  // smax | m | l | acc
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -INFINITY;
  if (nlive > 1 && !QUANT) {
    if (tid == 0) publish_max<R>(gsync, mypart, split, smx);
    look_back<R>(gsync, gpart, pstride, split, nt, m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mx = warp_max(m[r]);
      if (lane == 0) lb_s[r * nwarps + warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, lb_s[r * nwarps + w]);
      m[r] = mx;
    }
  }

  // 4. the online softmax over the split's blocks from that max: P
  // rounded to the pool dtype into p_s (int8: p * vs in f32), l summed
  // from the unrounded f32 P; then P.V from the V pieces. Rows 3, 2:
  // thread (vd, vpart) over its slice of V row vd, its vectors taken from
  // a rotated start so that the threads of a phase read different banks.
  // In place: thread (dg, vp) over V rows dg DR .. dg DR + DR - 1
  // (each p read once for DR rows), token vectors vp, vp + tp, ... of the
  // block from a start rotated by dg (so the threads of a phase read
  // different banks of V and of p); the tp threads of a dgroup are
  // neighbouring lanes, and threads past hd / DR dgroups only join the
  // shuffles.
  int tp = INPLACE ? nt * DR / hd : nt / hd;
  if constexpr (INPLACE)
    while (tp > 32 || (bs / VEC) % tp) tp >>= 1;
  const int tpt = bs / tp;
  const int vd = tid / tp, vpart = tid % tp;  // in place: dgroup vd, part vpart
  const int nvv = tpt / VEC, rot = vd % nvv;
  const bool pv_on = !INPLACE || vd < hd / DR;
  float l[R], acc[R][DR];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DR; ++e) acc[r][e] = 0.f;
  }
  for (int jj = 0; jj < nb; ++jj) {
    // tokens 0..lim of this block are live: only the row's last block has
    // dead ones (its tail past `last`). A dead token never enters P.V: its
    // int8 p' is a 0 (not p * a stale scale), its bf16/f32 V a selected 0
    // (not an exact 0 weight times stale pool bytes, as 0 * NaN is NaN)
    const int lim = last - (j0 + jj) * bs;
    const bool tail = lim < bs - 1;
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sc = jj == 0 ? s0[r] : keep_s[((jj - 1) * R + r) * bs + tid];
      const float m_new = fmaxf(m[r], bm_s[jj * R + r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      const float p = exp2f(sc - m_new);
      if constexpr (QUANT)
        p_s[r * bs + tid] = tid <= lim ? p * vs_s[jj * bs + tid] : 0.f;
      else
        p_s[r * bs + tid] = from_f<T>(p);
      const float ps = warp_sum(p);
      if (lane == 0) sum_s[r * nwarps + warp] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += sum_s[r * nwarps + w];
      l[r] = l[r] * alpha[r] + sum;
    }
    // in place: acc takes the block's P.V (a thread's share of the tokens;
    // the tp lanes are summed once, after the last block); else the
    // block's P.V in pv, summed over the tp lanes here
    [[maybe_unused]] float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (INPLACE) {
#pragma unroll
        for (int e = 0; e < DR; ++e) acc[r][e] *= alpha[r];
      } else {
        pv[r] = 0.f;
      }
    }
    for (int pc = 0; pc < npk; ++pc, ++i) {
      const T* vt = piece_at(i);
      const int r0 = pc * prow, d0 = vd * DR;
      if (pv_on && d0 >= r0 && d0 < r0 + prow) {
        if constexpr (INPLACE) {
          const T* vrow = vt + (size_t)(d0 - r0) * bs;
          int c = rot;
          for (int u = 0; u < nvv; ++u) {
            const int v0 = (c * tp + vpart) * VEC;  // the vector's first token
            float vf[DR][VEC];
#pragma unroll
            for (int e = 0; e < DR; ++e) load_f<T, VEC>(vrow + (size_t)e * bs + v0, vf[e]);
            if (!QUANT && tail)
#pragma unroll
              for (int e = 0; e < DR; ++e)
#pragma unroll
                for (int x = 0; x < VEC; ++x) vf[e][x] = v0 + x <= lim ? vf[e][x] : 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float pf[VEC];
              load_f<PT, VEC>(p_s + r * bs + v0, pf);
#pragma unroll
              for (int e = 0; e < DR; ++e)
#pragma unroll
                for (int x = 0; x < VEC; ++x) acc[r][e] += pf[x] * vf[e][x];
            }
            if (++c == nvv) c = 0;
          }
        } else {
          const T* vrow = vt + (size_t)(vd - r0) * bs + vpart * tpt;
          const PT* pr = p_s + vpart * tpt;
          int c = rot;
#pragma unroll 4
          for (int u = 0; u < nvv; ++u) {
            float vf[VEC];
            load_f<T, VEC>(vrow + c * VEC, vf);
            if (tail) {
              const int v0 = vpart * tpt + c * VEC;  // the vector's first token
#pragma unroll
              for (int x = 0; x < VEC; ++x) vf[x] = v0 + x <= lim ? vf[x] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float pf[VEC];
              load_f<PT, VEC>(pr + r * bs + c * VEC, pf);
#pragma unroll
              for (int x = 0; x < VEC; ++x) pv[r] += pf[x] * vf[x];
            }
            if (++c == nvv) c = 0;
          }
        }
      }
    }
    if constexpr (!INPLACE) {
      // the tp threads of one V row are neighbouring lanes
      for (int o = tp >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) pv[r] += __shfl_xor_sync(0xffffffffu, pv[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][0] * alpha[r] + pv[r];
    }
    __syncthreads();  // p_s, sum_s and this block's V pieces are free
    refill(i);
  }
  if constexpr (INPLACE) {
    // the tp threads of one dgroup are neighbouring lanes
    for (int o = tp >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < DR; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  }

  // 5. one live split writes its result (decode: finalised; verify: the
  // partial state); several leave their partial states, and the last to
  // finish combines them in split order
  const bool owner = pv_on && vpart == 0;  // holds acc of V rows vd DR ..
  if (nlive == 1) {
    if constexpr (VERIFY) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = vr.row(r);
        if (o < 0) continue;
        if (owner)
#pragma unroll
          for (int e = 0; e < DR; ++e) a.out[(size_t)o * hd + vd * DR + e] = acc[r][e];
        if (tid == 0) {
          a.m_out[o] = m[r];
          a.l_out[o] = l[r];
        }
      }
    } else if (owner) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < DR; ++e)
          a.out[q_off + (size_t)r * hd + vd * DR + e] = acc[r][e] / fmaxf(l[r], 1e-30f);
    }
    return;
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mypart[R + r] = m[r];
      mypart[2 * R + r] = l[r];
    }
  }
  if (owner) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < DR; ++e) mypart[3 * R + r * hd + vd * DR + e] = acc[r][e];
  }
  if (!last_split(gsync, nlive, &last_s)) return;
  if constexpr (VERIFY)
    combine_splits<R, false>(gpart, pstride, nlive, hd, nt, vr, part_s, gsync);
  else
    combine_splits<R>(gpart, pstride, nlive, hd, nt, a.out + q_off, part_s, gsync);
}

// Rows 3 (WRITE) and 2, T the pools' and q's type, and rows 5 (WRITE) and
// 4, T = int8_t: the decode entries of the split walk. MAXT bounds bs:
// blocks of more than 256 tokens take the form compiled for 1024 threads
// (64 registers a thread, where 256 threads leave it 255).
template <typename T, int REP, bool WRITE, int MAXT>
__global__ void __launch_bounds__(MAXT) paged_split_kernel(const SplitArgs a) {
  split_walk<T, REP, WRITE ? kUpdate : kRead>(a);
}

// Rows 6 (T the pools' and q's type) and 7 (T = int8_t): the verify read
// of the split walk, chunks of R query rows
template <typename T, int R, int MAXT>
__global__ void __launch_bounds__(MAXT) paged_verify_split_kernel(const SplitArgs a) {
  split_walk<T, R, kVerify>(a);
}

// ---------------------------------------------------------------------------
// rows 8 and 9: the commit
// ---------------------------------------------------------------------------

struct CommitArgs {
  const void* new_k;
  const void* new_v;
  void* k_pool;
  void* v_pool;
  const float* new_ks;  // row 9: the fed columns' scales [L, B, T, NKV]
  const float* new_vs;
  float* k_scale;  // row 9: the scale pools [L, NP, NKV, bs]
  float* v_scale;
  const int* tables;
  const int* qstart;
  const int* commit_len;
  int n_layers, np, b_rows, t_fed, kvd, nkv, bs, max_nb;
};

// Rows 8 (W the pools' element width, QUANT false) and 9 (W = uint8_t,
// QUANT): warp item i of n_layers x b_rows x ceil(kvd / kCommitWarpRows)
// owns pool rows d0 .. d0 + kCommitWarpRows - 1 of (layer, row b). Lane
// (r, t) takes fed token t of rows d0 + r, d0 + r + kCommitRowStep, ...:
// one warp store writes kCommitRowStep rows' whole windows, each pool
// row's sectors once. A lane finds its token's block and column once; a
// dead token's lane (t >= commit_len[b]) and a token whose table slot is
// the null block write nothing. A grid-stride loop over the items.
template <typename W, bool QUANT>
__global__ void __launch_bounds__(kCommitThreads) paged_commit_kernel(const CommitArgs a) {
  const int lane = threadIdx.x & 31, t = lane % kMaxFed, r = lane / kMaxFed;
  const int groups = (a.kvd + kCommitWarpRows - 1) / kCommitWarpRows;
  const int items = a.n_layers * a.b_rows * groups;
  const int wpb = blockDim.x / 32;
  for (int i = blockIdx.x * wpb + threadIdx.x / 32; i < items; i += gridDim.x * wpb) {
    const int d0 = i % groups * kCommitWarpRows, b = i / groups % a.b_rows;
    const int layer = i / groups / a.b_rows;
    if (t >= min(a.commit_len[b], a.t_fed)) continue;
    const int pos = a.qstart[b] + t;
    const int blk = a.tables[(size_t)b * a.max_nb + min(max(pos / a.bs, 0), a.max_nb - 1)];
    if (blk == 0) continue;
    const int col = pos % a.bs;
    const size_t src = (((size_t)layer * a.b_rows + b) * a.t_fed + t) * a.kvd;
    const size_t dst = ((size_t)layer * a.np + blk) * a.kvd * a.bs + col;
    const W* nk = static_cast<const W*>(a.new_k);
    const W* nv = static_cast<const W*>(a.new_v);
    W ek[kCommitSteps], ev[kCommitSteps];
#pragma unroll
    for (int k = 0; k < kCommitSteps; ++k) {
      const int d = d0 + r + k * kCommitRowStep;
      if (d < a.kvd) {
        ek[k] = nk[src + d];
        ev[k] = nv[src + d];
      }
    }
#pragma unroll
    for (int k = 0; k < kCommitSteps; ++k) {
      const int d = d0 + r + k * kCommitRowStep;
      if (d < a.kvd) {
        static_cast<W*>(a.k_pool)[dst + (size_t)d * a.bs] = ek[k];
        static_cast<W*>(a.v_pool)[dst + (size_t)d * a.bs] = ev[k];
      }
    }
    if constexpr (QUANT) {
      // a kv-head's first row: its lanes write the head's window of K and
      // V scales
      const int hd = a.kvd / a.nkv;
#pragma unroll
      for (int k = 0; k < kCommitSteps; ++k) {
        const int d = d0 + r + k * kCommitRowStep;
        if (d < a.kvd && d % hd == 0) {
          const int g = d / hd;
          const size_t s = (((size_t)layer * a.b_rows + b) * a.t_fed + t) * a.nkv + g;
          const size_t o = (((size_t)layer * a.np + blk) * a.nkv + g) * a.bs + col;
          a.k_scale[o] = a.new_ks[s];
          a.v_scale[o] = a.new_vs[s];
        }
      }
    }
  }
}

// The commit's launch: one warp an item, the grid from the work
template <typename W, bool QUANT>
cudaError_t launch_commit(const CommitArgs& a, cudaStream_t s) {
  const long long items = (long long)a.n_layers * a.b_rows *
                          ((a.kvd + kCommitWarpRows - 1) / kCommitWarpRows);
  if (items == 0) return cudaSuccess;
  const int wpb = kCommitThreads / 32;
  const int grid = (int)((items + wpb - 1) / wpb);
  paged_commit_kernel<W, QUANT><<<grid, kCommitThreads, 0, s>>>(a);
  return cudaSuccess;
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
template <typename T, int R>
bool split_geometry(int hd, int bs, int bps, int* prow, int* nbuf, size_t* smem) {
  const size_t row = (size_t)bs * sizeof(T);
  int pr = (int)(kPieceBytes / row) / 8 * 8;
  pr = pr < hd ? pr : hd;
  for (; pr >= 8; pr = pr / 16 * 8) {
    const int npk = (hd + pr - 1) / pr;
    const int nb = bps == 1 ? 1 : 2 * bps * npk < kRing ? 2 * bps * npk : kRing;
    const size_t bytes = SplitSmem<T, R>(hd, bs, bps, pr, nb).total;
    if (bytes + 64 <= 227 * 1024) {  // and the static split_s, last_s
      *prow = pr;
      *nbuf = nb;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

// One launch of the split walk: rows 2-5, grid (nkv, b, nsplit); the
// verify read, grid (nkv nchunk, b, nsplit). a carries everything but the
// geometry, which is set here.
template <typename T, int R, int MODE, int MAXT>
cudaError_t launch_split_bounded(SplitArgs a, int b, cudaStream_t stream) {
  a.bps = (a.max_nb + a.nsplit - 1) / a.nsplit;  // blocks per split
  size_t smem;
  if (!split_geometry<T, R>(a.hd, a.bs, a.bps, &a.prow, &a.nbuf, &smem))
    return cudaErrorInvalidValue;
  if constexpr (MODE == kVerify) {
    cudaError_t e = set_smem(paged_verify_split_kernel<T, R, MAXT>, smem);
    if (e != cudaSuccess) return e;
    paged_verify_split_kernel<T, R, MAXT>
        <<<dim3(a.nkv * a.nchunk, b, a.nsplit), a.bs, smem, stream>>>(a);
  } else {
    cudaError_t e = set_smem(paged_split_kernel<T, R, MODE == kUpdate, MAXT>, smem);
    if (e != cudaSuccess) return e;
    paged_split_kernel<T, R, MODE == kUpdate, MAXT>
        <<<dim3(a.nkv, b, a.nsplit), a.bs, smem, stream>>>(a);
  }
  return cudaSuccess;
}

template <typename T, int R, int MODE>
cudaError_t launch_split(const SplitArgs& a, int b, cudaStream_t stream) {
  if (a.bs <= 256) return launch_split_bounded<T, R, MODE, 256>(a, b, stream);
  return launch_split_bounded<T, R, MODE, 1024>(a, b, stream);
}

// the geometry both attention entries take
bool bad_geometry(int nh, int nkv, int hd, int bs) {
  if (nkv < 1 || nh % nkv) return true;
  const int rep = nh / nkv;
  if (rep != 1 && rep != 2 && rep != 4 && rep != 8) return true;
  return bs % 128 || bs > 1024 || hd < 1 || bs % hd || hd % 8 || (bs / hd) > 32 ||
         ((bs / hd) & (bs / hd - 1));
}

// the int8 entries' head_dim: a multiple of 16 codes
bool bad_quant_geometry(int nh, int nkv, int hd, int bs) {
  return bad_geometry(nh, nkv, hd, bs) || hd % 16;
}

// the decode walk of REP query heads a kv-head, REP in {1, 2, 4, 8}
template <typename T, int MODE>
cudaError_t launch_decode(const SplitArgs& a, int b, int rep, cudaStream_t s) {
  switch (rep) {
    case 1: return launch_split<T, 1, MODE>(a, b, s);
    case 2: return launch_split<T, 2, MODE>(a, b, s);
    case 4: return launch_split<T, 4, MODE>(a, b, s);
    case 8: return launch_split<T, 8, MODE>(a, b, s);
    default: return cudaErrorInvalidValue;
  }
}

// rows 3 (WRITE) and 2 (read-only; nk, nv null), and over int8 pools
// (QUANT) rows 5 (WRITE) and 4 (nk, nv, nks, nvs null): the shared entry;
// dtype is q's type, and without QUANT the pools' and the new columns'
template <bool WRITE, bool QUANT>
int split_entry(const void* q, const void* nk, const void* nv, const void* nks,
                const void* nvs, void* kp, void* vp, void* ks, void* vs, const void* tables,
                const void* rows, void* out, void* part, void* sync, int b, int layer, int np,
                int nh, int nkv, int hd, int bs, int max_nb, int nsplit, int dtype,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((QUANT ? bad_quant_geometry(nh, nkv, hd, bs) : bad_geometry(nh, nkv, hd, bs)) ||
      max_nb < 1 || nsplit < 1 || nsplit > max_nb || nsplit > kMaxSplits ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
    SplitArgs a{};
    a.q = q;
    a.new_k = nk;
    a.new_v = nv;
    a.new_ks = static_cast<const float*>(nks);
    a.new_vs = static_cast<const float*>(nvs);
    a.k_pool = kp;
    a.v_pool = vp;
    a.k_scale = static_cast<float*>(ks);
    a.v_scale = static_cast<float*>(vs);
    a.tables = static_cast<const int*>(tables);
    a.rows = static_cast<const int*>(rows);
    a.out = static_cast<float*>(out);
    a.part = static_cast<float*>(part);
    a.sync = static_cast<int*>(sync);
    a.layer = layer;
    a.np = np;
    a.nkv = nkv;
    a.hd = hd;
    a.bs = bs;
    a.max_nb = max_nb;
    a.nsplit = nsplit;
    a.rep = nh / nkv;
    a.nchunk = 1;
    a.q_bf16 = dtype;
    constexpr int M = WRITE ? kUpdate : kRead;
    cudaError_t e;
    if constexpr (QUANT)
      e = launch_decode<int8_t, M>(a, b, a.rep, s);
    else
      e = dtype == 0 ? launch_decode<float, M>(a, b, a.rep, s)
                     : launch_decode<__nv_bfloat16, M>(a, b, a.rep, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// rows 6 (pools T of q's type) and 7 (T = int8_t): the verify read in
// chunks of `height` query rows, one of the compiled heights
template <typename T>
cudaError_t launch_verify(const SplitArgs& a, int b, int height, cudaStream_t s) {
  switch (height) {
    case 2: return launch_split<T, 2, kVerify>(a, b, s);
    case 4: return launch_split<T, 4, kVerify>(a, b, s);
    case 5: return launch_split<T, 5, kVerify>(a, b, s);
    case 8: return launch_split<T, 8, kVerify>(a, b, s);
    default: return cudaErrorInvalidValue;
  }
}

// rows 6 and 7: the shared entry (ks, vs null over float pools); QUANT
// selects int8 pools with q of type dtype, else pools and q of that type
template <bool QUANT>
int verify_entry(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* tables, const void* qstart, void* acc, void* m,
                 void* l, void* part, void* sync, int b, int t_fed, int layer, int np, int nh,
                 int nkv, int hd, int bs, int max_nb, int nsplit, int nchunk, int height,
                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = nkv > 0 ? t_fed * (nh / nkv) : 0;
  if ((QUANT ? bad_quant_geometry(nh, nkv, hd, bs) : bad_geometry(nh, nkv, hd, bs)) ||
      t_fed < 1 || t_fed > kMaxFed || max_nb < 1 || nsplit < 1 || nsplit > max_nb ||
      nsplit > kMaxSplits || (dtype != 0 && dtype != 1) || nchunk < 1 ||
      nchunk * height < rows || (nchunk - 1) * height >= rows)
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
    SplitArgs a{};
    a.q = q;
    a.k_pool = const_cast<void*>(kp);
    a.v_pool = const_cast<void*>(vp);
    a.k_scale = static_cast<float*>(const_cast<void*>(ks));
    a.v_scale = static_cast<float*>(const_cast<void*>(vs));
    a.tables = static_cast<const int*>(tables);
    a.rows = static_cast<const int*>(qstart);
    a.out = static_cast<float*>(acc);
    a.m_out = static_cast<float*>(m);
    a.l_out = static_cast<float*>(l);
    a.part = static_cast<float*>(part);
    a.sync = static_cast<int*>(sync);
    a.layer = layer;
    a.np = np;
    a.nkv = nkv;
    a.hd = hd;
    a.bs = bs;
    a.max_nb = max_nb;
    a.nsplit = nsplit;
    a.rep = nh / nkv;
    a.t_fed = t_fed;
    a.nchunk = nchunk;
    a.q_bf16 = dtype;
    cudaError_t e;
    if constexpr (QUANT)
      e = launch_verify<int8_t>(a, b, height, s);
    else
      e = dtype == 0 ? launch_verify<float>(a, b, height, s)
                     : launch_verify<__nv_bfloat16>(a, b, height, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
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
#if PAGED_PART(0)
extern "C" int paged_attend_update_fwd(const void* q, const void* nk, const void* nv,
                                       void* kp, void* vp, const void* tables,
                                       const void* positions, void* out, void* part,
                                       void* sync, int b, int layer, int np, int nh, int nkv,
                                       int hd, int bs, int max_nb, int nsplit, int dtype,
                                       void* stream) {
  return split_entry<true, false>(q, nk, nv, nullptr, nullptr, kp, vp, nullptr, nullptr, tables,
                                  positions, out, part, sync, b, layer, np, nh, nkv, hd, bs,
                                  max_nb, nsplit, dtype, stream);
}
#endif

// Row 2: the same geometry and scratch, nothing written; lengths[b] tokens
// read, with (lengths[b] - 1) / bs < max_nb.
#if PAGED_PART(1)
extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, void* out,
                                   void* part, void* sync, int b, int layer, int np, int nh,
                                   int nkv, int hd, int bs, int max_nb, int nsplit, int dtype,
                                   void* stream) {
  return split_entry<false, false>(q, nullptr, nullptr, nullptr, nullptr, const_cast<void*>(kp),
                                   const_cast<void*>(vp), nullptr, nullptr, tables, lengths, out,
                                   part, sync, b, layer, np, nh, nkv, hd, bs, max_nb, nsplit,
                                   dtype, stream);
}
#endif

// q [b, t_fed, nh, hd] pre-scaled, in the pools' dtype; acc [b, t_fed, nh,
// hd], m and l [b, t_fed, nh], all f32. The geometry is that of
// paged_attend_update_fwd, with 1 <= t_fed <= 8 and (qstart[b] - 1) / bs <
// max_nb for every row with qstart[b] > 0. The t_fed * nh / nkv query rows
// of a (row, kv-head) go in nchunk chunks of height in {2, 4, 5, 8} rows
// (the last chunk may be short, none empty); part is f32 scratch of b * nkv
// * nchunk * nsplit * (3 + hd) * height floats, sync b * nkv * nchunk * (2 +
// nsplit) ints, zero (each launch leaves it zero).
#if PAGED_PART(2)
extern "C" int paged_attention_verify_fwd(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* qstart, void* acc,
                                          void* m, void* l, void* part, void* sync, int b,
                                          int t_fed, int layer, int np, int nh, int nkv, int hd,
                                          int bs, int max_nb, int nsplit, int nchunk,
                                          int height, int dtype, void* stream) {
  return verify_entry<false>(q, kp, vp, nullptr, nullptr, tables, qstart, acc, m, l, part, sync,
                             b, t_fed, layer, np, nh, nkv, hd, bs, max_nb, nsplit, nchunk, height,
                             dtype, stream);
}
#endif

// new_k/new_v [n_layers, b, t_fed, kvd] in the pools' dtype, pools [n_layers,
// np, kvd, bs]; tables [b, max_nb], qstart and commit_len [b] int32, with
// 1 <= t_fed <= 8 and (qstart[b] + commit_len[b] - 1) / bs < max_nb. Only
// live columns (t < commit_len[b]) are written, and never into block 0.
#if PAGED_PART(5)
extern "C" int paged_verify_commit_fwd(const void* nk, const void* nv, void* kp, void* vp,
                                       const void* tables, const void* qstart,
                                       const void* commit_len, int n_layers, int b,
                                       int t_fed, int np, int kvd, int bs, int max_nb,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_fed < 1 || t_fed > kMaxFed || kvd < 1 || bs < 1 || max_nb < 1)
    return (int)cudaErrorInvalidValue;
  const CommitArgs a{nk, nv, kp, vp, nullptr, nullptr, nullptr, nullptr,
                     static_cast<const int*>(tables), static_cast<const int*>(qstart),
                     static_cast<const int*>(commit_len), n_layers, np, b, t_fed, kvd, 1, bs,
                     max_nb};
  cudaError_t e;
  if (dtype == 0)
    e = launch_commit<uint32_t, false>(a, s);
  else if (dtype == 1)
    e = launch_commit<uint16_t, false>(a, s);
  else
    e = cudaErrorInvalidValue;
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
#endif

// The int8 entries: pools int8 [n_layers, np, kvd, bs], scale pools f32
// [n_layers, np, nkv, bs], 16-byte aligned; q [b, nh, hd] (verify: [b,
// t_fed, nh, hd]) pre-scaled, dtype 0 = float32, 1 = bfloat16. The
// geometry, split and scratch are those of the entries above with hd % 16
// == 0. Row 5: new_k/new_v int8 [b, kvd], new_ks/new_vs f32 [b, nkv],
// written at positions[b]; row 4: lengths[b] tokens read, (lengths[b] - 1)
// / bs < max_nb.
#if PAGED_PART(3)
extern "C" int paged_attend_update_quant_fwd(const void* q, const void* nk, const void* nv,
                                             const void* nks, const void* nvs, void* kp,
                                             void* vp, void* ks, void* vs, const void* tables,
                                             const void* positions, void* out, void* part,
                                             void* sync, int b, int layer, int np, int nh,
                                             int nkv, int hd, int bs, int max_nb, int nsplit,
                                             int dtype, void* stream) {
  return split_entry<true, true>(q, nk, nv, nks, nvs, kp, vp, ks, vs, tables, positions, out,
                                 part, sync, b, layer, np, nh, nkv, hd, bs, max_nb, nsplit, dtype,
                                 stream);
}

extern "C" int paged_attention_quant_fwd(const void* q, const void* kp, const void* vp,
                                         const void* ks, const void* vs, const void* tables,
                                         const void* lengths, void* out, void* part, void* sync,
                                         int b, int layer, int np, int nh, int nkv, int hd,
                                         int bs, int max_nb, int nsplit, int dtype,
                                         void* stream) {
  return split_entry<false, true>(q, nullptr, nullptr, nullptr, nullptr, const_cast<void*>(kp),
                                  const_cast<void*>(vp), const_cast<void*>(ks),
                                  const_cast<void*>(vs), tables, lengths, out, part, sync, b,
                                  layer, np, nh, nkv, hd, bs, max_nb, nsplit, dtype, stream);
}
#endif

// Row 7: paged_attention_verify_fwd's contract over int8 pools and their
// scale pools (16-byte aligned), q of type dtype
#if PAGED_PART(4)
extern "C" int paged_attention_verify_quant_fwd(const void* q, const void* kp, const void* vp,
                                                const void* ks, const void* vs,
                                                const void* tables, const void* qstart,
                                                void* acc, void* m, void* l, void* part,
                                                void* sync, int b, int t_fed, int layer, int np,
                                                int nh, int nkv, int hd, int bs, int max_nb,
                                                int nsplit, int nchunk, int height, int dtype,
                                                void* stream) {
  return verify_entry<true>(q, kp, vp, ks, vs, tables, qstart, acc, m, l, part, sync, b, t_fed,
                            layer, np, nh, nkv, hd, bs, max_nb, nsplit, nchunk, height, dtype,
                            stream);
}
#endif

// new_k/new_v int8 [n_layers, b, t_fed, kvd], new_ks/new_vs f32 [n_layers,
// b, t_fed, nkv]; otherwise paged_verify_commit_fwd's contract
#if PAGED_PART(5)
extern "C" int paged_verify_commit_quant_fwd(const void* nk, const void* nv, const void* nks,
                                             const void* nvs, void* kp, void* vp, void* ks,
                                             void* vs, const void* tables, const void* qstart,
                                             const void* commit_len, int n_layers, int b,
                                             int t_fed, int np, int kvd, int nkv, int bs,
                                             int max_nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_fed < 1 || t_fed > kMaxFed || kvd < 1 || nkv < 1 || kvd % nkv || bs < 1 || max_nb < 1)
    return (int)cudaErrorInvalidValue;
  const CommitArgs a{nk, nv, kp, vp, static_cast<const float*>(nks),
                     static_cast<const float*>(nvs), static_cast<float*>(ks),
                     static_cast<float*>(vs), static_cast<const int*>(tables),
                     static_cast<const int*>(qstart), static_cast<const int*>(commit_len),
                     n_layers, np, b, t_fed, kvd, nkv, bs, max_nb};
  const cudaError_t e = launch_commit<uint8_t, true>(a, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
#endif

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
bool quant_geometry(int hd, int bs, size_t* smem) {
  int prow, nbuf;
  return split_geometry<int8_t, R>(hd, bs, 1, &prow, &nbuf, smem);
}
}  // namespace

// CTAs per SM of the int8 decode walk (row 5, the form of row 4 too) at
// REP = rows, and of the int8 verify read (row 7) in chunks of rows, with
// bs threads and their shared memory, one block a split; -1 on a bad
// argument or a CUDA error. Each lives in the part that holds its kernels.
int paged_quant_decode_occupancy(int rows, int hd, int bs);
int paged_quant_verify_occupancy(int rows, int hd, int bs);

#if PAGED_PART(3)
namespace {
template <int R>
int decode_occupancy(int hd, int bs) {
  size_t smem;
  if (!quant_geometry<R>(hd, bs, &smem)) return -1;
  return bs <= 256 ? occupancy(paged_split_kernel<int8_t, R, true, 256>, bs, smem)
                   : occupancy(paged_split_kernel<int8_t, R, true, 1024>, bs, smem);
}
}  // namespace

int paged_quant_decode_occupancy(int rows, int hd, int bs) {
  switch (rows) {
    case 1: return decode_occupancy<1>(hd, bs);
    case 2: return decode_occupancy<2>(hd, bs);
    case 4: return decode_occupancy<4>(hd, bs);
    case 8: return decode_occupancy<8>(hd, bs);
    default: return -1;
  }
}
#endif

#if PAGED_PART(4)
namespace {
template <int R>
int verify_occupancy(int hd, int bs) {
  size_t smem;
  if (!quant_geometry<R>(hd, bs, &smem)) return -1;
  return bs <= 256 ? occupancy(paged_verify_split_kernel<int8_t, R, 256>, bs, smem)
                   : occupancy(paged_verify_split_kernel<int8_t, R, 1024>, bs, smem);
}
}  // namespace

int paged_quant_verify_occupancy(int rows, int hd, int bs) {
  switch (rows) {
    case 2: return verify_occupancy<2>(hd, bs);
    case 4: return verify_occupancy<4>(hd, bs);
    case 5: return verify_occupancy<5>(hd, bs);
    case 8: return verify_occupancy<8>(hd, bs);
    default: return -1;
  }
}
#endif

#if PAGED_PART(5)
// CTAs per SM that the int8 split walks reach: kind 0 the decode walk at
// REP = rows in {1, 2, 4, 8}; kind 1 the verify read in chunks of rows in
// {2, 4, 5, 8}; -1 on a bad argument or a CUDA error
extern "C" int paged_quant_occupancy(int kind, int rows, int hd, int bs) {
  return kind == 0 ? paged_quant_decode_occupancy(rows, hd, bs)
                   : paged_quant_verify_occupancy(rows, hd, bs);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
