"""Times the design choices of the split walk (csrc/paged_attention.cu,
split_walk: rows 3 and 2, and 5 and 4 over int8 pools, paged_split_kernel;
rows 6 and 7, paged_verify_split_kernel) and of the commit (rows 8 and 9,
paged_commit_kernel) against each other on one card.

    python3 tools/paged_choices.py [FORM ...]

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, edited as its entry in FORMS says (a source edit of the kernel,
the kernel's commit replaced, or the wrapper's SPLIT_TOKENS or
VERIFY_HEIGHTS): the shipped form, and the
forms it was chosen over (FORMs pick some; the shipped form always runs):

  split_2_blocks, split_4_blocks  runs of 2 and 4 pool blocks a split
                                  (SPLIT_TOKENS 256, 512, a ring of two
                                  blocks) against one (rows 2-7);
  register_loads                  every K and V vector loaded from device
                                  memory into registers by the thread that
                                  uses it (the parent's walk's loads), no
                                  bulk copy and no ring, against one 1-D
                                  bulk copy per slice into shared memory;
  no_l2_warm                      no L2 prefetch of a split's blocks while
                                  its ticket is taken;
  k_and_v_together                a split of one block with K and V in
                                  flight together (two ring slots) against
                                  one slot, V's copy issued once K is read;
  half_pieces_two_slots           16 KB pieces through two slots against
                                  one 32 KB slot;

of the int8 decode (rows 5 and 4):

  quant_l2_warm                   the L2 warm-up of rows 3 and 2 against
                                  none;
  quant_look_back                 the look-back over int8 pools (P never
                                  rounded) against each split's recurrence
                                  from its own max;
  quant_copy_after_barrier        the first copies issued after the CTA's
                                  barrier, as rows 3 and 2 do, against
                                  before it (row 5's owner of the new
                                  column after its write);
  quant_pv_per_row                one V row's share a thread, summed over
                                  its lanes block by block (rows 3 and 2's
                                  P.V), against P.V in place over 2 V rows
                                  a thread as the verify read sums it;
  quant_pv_in_place_dr_4          in place over 4 V rows a thread (as the
                                  int8 verify read) against 2;

and of the verify read (rows 6 and 7):

  verify_pow2_heights             chunks of 2, 4 or 8 rows (llama_7b's 5
                                  rows padded to 8, as the parent's walk)
                                  against heights 2, 4, 5 and 8;
  verify_look_back_int8           int8 pools (P never rounded) with the
                                  look-back against each split's
                                  recurrence from its own max;
  verify_k_and_v_together         K and V of a one-block split in flight
                                  together (two slots) against one slot;
  verify_copy_after_barrier       the first copy issued after the CTA's
                                  barrier, as rows 3 and 2 do, against
                                  before it;
  verify_dr_2, verify_dr_4        P.V over 2 or 4 V rows a thread in
                                  every pool type against 2 (bf16, f32)
                                  and 4 (int8; the int8 decode keeps 2);
  verify_l2_warm                  the L2 warm-up of rows 3 and 2 (a split's
                                  blocks prefetched while its ticket is
                                  taken) against none;

and of the commit (rows 8 and 9):

  commit_thread_rows              one thread owns 8 pool rows of a
                                  (layer, row), reads its live columns as
                                  vectors of new_k/new_v and writes each
                                  row's window from registers in the
                                  fewest aligned stores (16, 8, 4, 2 or 1
                                  bytes), against a lane a fed token and
                                  one warp store over 4 rows' windows;
  commit_l2_prefetch              the target sectors prefetched to L2
                                  before the stores;
  commit_persistent               a persistent grid (8 CTAs of 256 threads
                                  an SM, each walking items by grid
                                  stride) against one warp an item;
  commit_32_rows_a_warp           a warp item of 32 pool rows (8 stores a
                                  lane) against 16 (4).

Every copy builds at once, in a process of its own; then each copy runs
alone, in the order of FORMS and again in reverse, so that a drift of the
card over the call shows. A run of a decode form holds rows 3, 2, 5 and
4 to their plain versions (chip_smoke's ``check_paged_update``,
``check_paged_read`` and ``check_quant``), a run of a verify form rows 6
and 7 (``check_verify`` and ``check_quant``; the shipped form takes all
four), 
a run of an int8 decode form rows 5 and 4 (``check_quant``), a run of a
commit form rows 8 and 9 (``check_commit``, which the shipped form takes
too) and times only them: at L = 32, B = 8, T = 5, KVD = 4096 (bf16 and
int8 pools, chip_smoke's ``commit_timing_inputs``) with every column
accepted and with one (the serve-spec step's commit lengths). Every other
run times rows 3, 2, 5, 4, 6 and 7 at chip_smoke's timing shape (B = 8, NH =
NKV = 32, HD = 128, bf16 or int8 pools, 3,865 context tokens, T = 5 fed
tokens for rows 6 and 7; device ms per call, 100 calls queued ahead,
chip_smoke's ``_time_ms``), rows 3 and 5 at the serve phase's profiled
decode step (the same heads, 8 rows of 1,001 tokens, 16-block tables) and
rows 6 and 7 at the profiled verify step's (8 rows of 600 cached tokens).
ptxas's registers and spills of each form's split kernels at bf16 and
int8, REP 1, and of its verify kernels at 5 rows are printed too. Needs one CUDA device and nvcc;
exits non-zero if a form fails its check; writes
chiprun_out/paged_choices.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RING_RULE = ("    const int nb = bps == 1 ? 1 : 2 * bps * npk < kRing ? 2 * bps * npk "
              ": kRing;")
_PIECE_AT = """  auto piece_at = [&](int i) -> const T* {  // piece i's rows, once landed
    if (i >= freed + nbuf) {  // the ring holds pieces still read: free them first
      __syncthreads();
      refill(i);
    }
    mbar_wait(&bar[i % nbuf], (i / nbuf) & 1);
    return reinterpret_cast<const T*>(ring + (size_t)(i % nbuf) * piece_bytes);
"""
REGISTER_LOADS = [
    (_PIECE_AT, "  auto piece_at = [&](int i) -> const T* {\n"
                "    return piece_src(i);\n"),
    ("    for (; issued < min(done + nbuf, total); ++issued) {",
     "    for (; issued < min(done + nbuf, total) && nbuf > 0; ++issued) {"),
    (_RING_RULE, "    const int nb = 0;"),
]
NO_L2_WARM = [
    ("        bulk_prefetch_l2(k_pool + off, slice);\n"
     "        bulk_prefetch_l2(v_pool + off, slice);\n", ""),
]
K_AND_V_TOGETHER = [(_RING_RULE, _RING_RULE.replace("bps == 1 ? 1", "bps == 1 ? 2"))]
HALF_PIECES = K_AND_V_TOGETHER + [("constexpr int kPieceBytes = 32768;",
                                   "constexpr int kPieceBytes = 16384;")]

# The commit of one thread a run of 8 pool rows (the design the shipped
# lanes replaced): its kernel and launch in place of the shipped ones
_THREAD_ROWS = r"""constexpr int kThreadRows = 8;  // pool rows a thread owns

// e[t..t+S) packed into one store of S * sizeof(W) bytes at dst (aligned
// to its width)
template <typename W, int S, int t>
__device__ __forceinline__ void put(W* dst, const W (&e)[kMaxFed]) {
  constexpr int B = S * (int)sizeof(W);
  if constexpr (B < 4) {
    using U = std::conditional_t<B == 1, uint8_t, uint16_t>;
    U v = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) v |= (U)((U)e[t + i] << (8 * sizeof(W) * i));
    *reinterpret_cast<U*>(dst) = v;
  } else {
    constexpr int NW = B / 4, PER = 4 / (int)sizeof(W);
    uint32_t w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[k] = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) w[k] |= (uint32_t)e[t + k * PER + i] << (8 * sizeof(W) * i);
    }
    if constexpr (NW == 1)
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    else if constexpr (NW == 2)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One pool row's window: e[t] for fed tokens t in [next, tb) to p + t (p +
// t is token t's column), as the fewest aligned stores: from each token
// where a store starts, the widest of 16, 8, 4, 2 or 1 bytes that its
// address's alignment and the tokens left allow. t is a template argument,
// so e stays in registers.
template <typename W, int t = 0>
__device__ __forceinline__ void store_window(W* p, const W (&e)[kMaxFed], int next, int tb) {
  if constexpr (t < kMaxFed) {
    if (t == next && t < tb) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p + t);
      const int left = tb - t;
      bool done = false;
      if constexpr (t + 8 <= kMaxFed && 8 * sizeof(W) <= 16)
        if (left >= 8 && a % (8 * sizeof(W)) == 0) {
          put<W, 8, t>(p + t, e);
          next = t + 8;
          done = true;
        }
      if constexpr (t + 4 <= kMaxFed)
        if (!done && left >= 4 && a % (4 * sizeof(W)) == 0) {
          put<W, 4, t>(p + t, e);
          next = t + 4;
          done = true;
        }
      if constexpr (t + 2 <= kMaxFed)
        if (!done && left >= 2 && a % (2 * sizeof(W)) == 0) {
          put<W, 2, t>(p + t, e);
          next = t + 2;
          done = true;
        }
      if (!done) {
        p[t] = e[t];
        next = t + 1;
      }
    }
    store_window<W, t + 1>(p, e, next, tb);
  }
}

// kThreadRows consecutive elements of W at p (one thread's pool rows of
// one fed column) as 32-bit words: one 8-byte or 16-byte vector, two for
// f32
template <typename W>
__device__ __forceinline__ void load_rows(const W* p, uint32_t (&r)[2 * sizeof(W)]) {
  if constexpr (sizeof(W) == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < (int)sizeof(W) / 2; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  }
}

// Where a row's live fed tokens land: tokens [ta, tb) of the n live ones
// at columns col .. of pool block blk (0: the segment is skipped), one
// segment per pool block the window touches
struct CommitSegment {
  int ta, tb, col, blk;
};

__device__ __forceinline__ CommitSegment commit_segment(const int* __restrict__ tables, int b,
                                                        int max_nb, int bs, int pos0, int ta,
                                                        int n) {
  const int pos = pos0 + ta;
  const int slot = min(max(pos / bs, 0), max_nb - 1);
  const int col = pos % bs;
  return {ta, min(n, ta + bs - col), col, tables[(size_t)b * max_nb + slot]};
}


// The thread's kThreadRows pool rows of one pool: its T x kThreadRows
// elements of the fed columns read as vectors (live tokens only), then each
// row's window written from registers, segment by segment
template <typename W>
__device__ __forceinline__ void commit_rows(const W* __restrict__ src, W* pool,
                                            const CommitArgs& a, size_t src0, size_t row0,
                                            const CommitSegment (&seg)[2], int nseg, int n) {
  constexpr int NW = 2 * sizeof(W);
  uint32_t r[kMaxFed][NW];
#pragma unroll
  for (int t = 0; t < kMaxFed; ++t) {
    if (t < n) {
      load_rows<W>(src + src0 + (size_t)t * a.kvd, r[t]);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) r[t][k] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kThreadRows; ++j) {
    W e[kMaxFed];
#pragma unroll
    for (int t = 0; t < kMaxFed; ++t)
      e[t] = (W)(r[t][j * sizeof(W) / 4] >> (8 * (j * sizeof(W) % 4)));
    for (int s = 0; s < nseg; ++s)
      if (seg[s].blk != 0)
        store_window<W>(pool + (((size_t)seg[s].blk * a.kvd) * a.bs + row0) +
                            (size_t)j * a.bs + seg[s].col - seg[s].ta,
                        e, seg[s].ta, seg[s].tb);
  }
}

// Rows 8 (W the pools' element width, QUANT false) and 9 (W = uint8_t,
// QUANT): thread item i of n_layers x b_rows x kvd / kThreadRows owns pool
// rows d0 .. d0 + kThreadRows - 1 of (layer, row b), adjacent items
// adjacent rows; a grid-stride loop over the items.
template <typename W, bool QUANT>
__global__ void __launch_bounds__(kCommitThreads) paged_commit_kernel(const CommitArgs a) {
  const int groups = a.kvd / kThreadRows;
  const int items = a.n_layers * a.b_rows * groups;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const int d0 = i % groups * kThreadRows, b = i / groups % a.b_rows;
    const int layer = i / groups / a.b_rows;
    const int n = min(max(a.commit_len[b], 0), a.t_fed);
    if (n == 0) continue;
    // a window of <= kMaxFed columns touches two blocks at most when bs >=
    // kMaxFed, which the entries require
    const int pos0 = a.qstart[b];
    CommitSegment seg[2];
    seg[0] = commit_segment(a.tables, b, a.max_nb, a.bs, pos0, 0, n);
    seg[1] = seg[0].tb < n ? commit_segment(a.tables, b, a.max_nb, a.bs, pos0, seg[0].tb, n)
                           : seg[0];
    const int nseg = seg[0].tb < n ? 2 : 1;
    const size_t src0 = ((size_t)layer * a.b_rows + b) * a.t_fed * a.kvd + d0;
    // (layer, block 0, row d0, column 0); blocks are kvd * bs elements apart
    const size_t row0 = (size_t)layer * a.np * a.kvd * a.bs + (size_t)d0 * a.bs;
    commit_rows<W>(static_cast<const W*>(a.new_k), static_cast<W*>(a.k_pool), a, src0, row0,
                   seg, nseg, n);
    commit_rows<W>(static_cast<const W*>(a.new_v), static_cast<W*>(a.v_pool), a, src0, row0,
                   seg, nseg, n);
    if constexpr (QUANT) {
      // the owner of a kv-head's first row writes the head's T-float
      // windows of K and V scales
      const int hd = a.kvd / a.nkv;
      for (int g = (d0 + hd - 1) / hd; g * hd < d0 + kThreadRows && g < a.nkv; ++g) {
        const size_t s0 = ((size_t)layer * a.b_rows + b) * a.t_fed * a.nkv + g;
        uint32_t ek[kMaxFed], ev[kMaxFed];
#pragma unroll
        for (int t = 0; t < kMaxFed; ++t) {
          ek[t] = t < n ? __float_as_uint(a.new_ks[s0 + (size_t)t * a.nkv]) : 0u;
          ev[t] = t < n ? __float_as_uint(a.new_vs[s0 + (size_t)t * a.nkv]) : 0u;
        }
        for (int s = 0; s < nseg; ++s) {
          if (seg[s].blk == 0) continue;
          const size_t o = (((size_t)layer * a.np + seg[s].blk) * a.nkv + g) * a.bs +
                           seg[s].col - seg[s].ta;
          store_window<uint32_t>(reinterpret_cast<uint32_t*>(a.k_scale) + o, ek, seg[s].ta,
                                 seg[s].tb);
          store_window<uint32_t>(reinterpret_cast<uint32_t*>(a.v_scale) + o, ev, seg[s].ta,
                                 seg[s].tb);
        }
      }
    }
  }
}


// The commit's launch: one thread an item, the grid from the work
template <typename W, bool QUANT>
cudaError_t launch_commit(const CommitArgs& a, cudaStream_t s) {
  const long long items = (long long)a.n_layers * a.b_rows * (a.kvd / kThreadRows);
  if (items == 0) return cudaSuccess;
  const int grid = (int)((items + kCommitThreads - 1) / kCommitThreads);
  paged_commit_kernel<W, QUANT><<<grid, kCommitThreads, 0, s>>>(a);
  return cudaSuccess;
}
"""
_COMMIT_FROM = "// Rows 8 (W the pools' element width, QUANT false) and 9 (W = uint8_t,\n"
_COMMIT_TO = "  paged_commit_kernel<W, QUANT><<<grid, kCommitThreads, 0, s>>>(a);\n" \
    "  return cudaSuccess;\n}\n"


def _thread_rows(src):
    a = src.index(_COMMIT_FROM)
    b = src.index(_COMMIT_TO, a) + len(_COMMIT_TO)
    return src[:a] + _THREAD_ROWS + src[b:]


_GEOMETRY = "bool split_geometry(int hd, int bs, int bps, int* prow, int* nbuf, size_t* smem) {"
_GEOMETRY_CALL = "  if (!split_geometry<T, R>(a.hd, a.bs, a.bps, &a.prow, &a.nbuf, &smem))"
VERIFY_K_AND_V = [
    (_GEOMETRY, _GEOMETRY.replace("size_t* smem)", "size_t* smem, bool pair = false)")),
    (_RING_RULE, _RING_RULE.replace("bps == 1 ? 1", "bps == 1 ? (pair ? 2 : 1)")),
    (_GEOMETRY_CALL, _GEOMETRY_CALL.replace("&smem)", "&smem, MODE == kVerify)")),
]
_EARLY = "    if (VERIFY || (QUANT && !(WRITE && z == nlive - 1))) {\n"
_LATE = "  if constexpr (!VERIFY) refill(0);"
VERIFY_AFTER_BARRIER = [
    ("    if (VERIFY && nlive > 1) z = take_ticket(gsync);\n", ""),
    ("    if (!VERIFY && nlive > 1) z = take_ticket(gsync);\n",
     "    if (nlive > 1) z = take_ticket(gsync);\n"),
    (_EARLY, _EARLY.replace("VERIFY || ", "")),
    (_LATE, "  refill(0);"),
]

# name -> {"edits": edits of csrc/paged_attention.cu, "tokens": SPLIT_TOKENS,
# "heights": VERIFY_HEIGHTS, "rows": the rows it changes}
FORMS = {
    "shipped": dict(rows="all"),
    "split_2_blocks": dict(tokens=256),
    "split_4_blocks": dict(tokens=512),
    "register_loads": dict(edits=REGISTER_LOADS),
    "no_l2_warm": dict(edits=NO_L2_WARM),
    "k_and_v_together": dict(edits=K_AND_V_TOGETHER),
    "half_pieces_two_slots": dict(edits=HALF_PIECES),
    "verify_pow2_heights": dict(heights=(2, 4, 8), rows="verify"),
    "verify_look_back_int8": dict(edits=[(
        "  if (nlive > 1 && !QUANT) {\n    if (tid == 0) publish_max",
        "  if (nlive > 1) {\n    if (tid == 0) publish_max")],
        rows="verify"),
    "verify_k_and_v_together": dict(edits=VERIFY_K_AND_V, rows="verify"),
    "verify_copy_after_barrier": dict(edits=VERIFY_AFTER_BARRIER,
                                      rows="verify"),
    "verify_dr_2": dict(edits=[("!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
                                "!INPLACE ? 1 : 2;")],
                        rows="verify"),
    "verify_dr_4": dict(edits=[("!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
                                "!INPLACE ? 1 : VERIFY ? 4 : 2;")],
                        rows="verify"),
    "verify_l2_warm": dict(edits=[(
        "    if (!VERIFY && !QUANT && nlive > 1) {\n      const int z0",
        "    if ((VERIFY || !QUANT) && nlive > 1 && chunk == 0) {\n"
        "      const int z0")],
        rows="verify"),
    "quant_l2_warm": dict(edits=[(
        "    if (!VERIFY && !QUANT && nlive > 1) {\n      const int z0",
        "    if (!VERIFY && nlive > 1) {\n      const int z0")],
        rows="quant"),
    "quant_look_back": dict(edits=[(
        "  if (nlive > 1 && !QUANT) {\n    if (tid == 0) publish_max",
        "  if (nlive > 1 && (!QUANT || !VERIFY)) {\n    if (tid == 0) publish_max")],
        rows="quant"),
    "quant_copy_after_barrier": dict(edits=[(
        _EARLY, _EARLY.replace(" || (QUANT && !(WRITE && z == nlive - 1))", ""))],
        rows="quant"),
    "quant_pv_per_row": dict(edits=[(
        "  constexpr bool INPLACE = VERIFY || QUANT;",
        "  constexpr bool INPLACE = VERIFY;")], rows="quant"),
    "quant_pv_in_place_dr_4": dict(edits=[(
        "!INPLACE ? 1 : VERIFY && QUANT ? 4 : 2;",
        "!INPLACE ? 1 : QUANT ? 4 : 2;")], rows="quant"),
    "commit_thread_rows": dict(edits=[_thread_rows], rows="commit"),
    "commit_l2_prefetch": dict(edits=[(
        "    const W* nk = static_cast<const W*>(a.new_k);\n",
        "#pragma unroll\n"
        "    for (int k = 0; k < kCommitSteps; ++k) {\n"
        "      const int d = d0 + r + k * kCommitRowStep;\n"
        "      if (d < a.kvd) {\n"
        "        asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"(\n"
        "            static_cast<W*>(a.k_pool) + dst + (size_t)d * a.bs));\n"
        "        asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"(\n"
        "            static_cast<W*>(a.v_pool) + dst + (size_t)d * a.bs));\n"
        "      }\n"
        "    }\n"
        "    const W* nk = static_cast<const W*>(a.new_k);\n")],
        rows="commit"),
    "commit_persistent": dict(edits=[(
        "  const int grid = (int)((items + wpb - 1) / wpb);\n",
        "  int sms = 0;\n"
        "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
        "  const long long need = (items + wpb - 1) / wpb;\n"
        "  const int grid = (int)(need < 8LL * sms ? need : 8LL * sms);\n")],
        rows="commit"),
    "commit_32_rows_a_warp": dict(edits=[(
        "constexpr int kCommitSteps = 4;", "constexpr int kCommitSteps = 8;")],
        rows="commit"),
}


def _chip_smoke():
    sys.path.append(ROOT)
    import chip_smoke
    return chip_smoke


def build_one():
    """In a copy's process: build, print ptxas's lines as JSON."""
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch import _build
    _build.build_all(["paged_attention"])
    lines = [ln for ln in chip_smoke.ptxas_lines(
        _build.BUILD_LOGS.get("paged_attention", ""))
        if ln.startswith(("paged_commit_kernel",
                          "paged_split_kernelI13__nv_bfloat16Li1E",
                          "paged_split_kernelIaLi1E",
                          "paged_verify_split_kernelI13__nv_bfloat16Li5E",
                          "paged_verify_split_kernelIaLi5E"))]
    print(json.dumps(lines))


def _check(checks, dev):
    """{name: "passes" or "fails: ..."} of chip_smoke checks."""
    import traceback
    out = {}
    for cname, fn in checks.items():
        try:
            fn(dev, {})
            out[cname] = "passes"
        except AssertionError:
            out[cname] = "fails: " + traceback.format_exc(limit=1)[-600:]
    return out


def commit_ms(cs, dev):
    """Rows 8 and 9 at chip_smoke's commit timing inputs, every column
    accepted and one: device ms per call."""
    import torch
    ms = {}
    for quant in (False, True):
        kern, _, a, new, pools, qs = cs.commit_timing_inputs(dev, quant)
        row = "row 9" if quant else "row 8"
        for n_live in (cs.SPEC_K + 1, 1):
            clen = torch.full((qs.shape[0],), n_live, dtype=torch.int32,
                              device=dev)
            args = (*new, *pools, a["tables"], qs, clen)
            ms[f"{kern.__name__} ({row}), commit_len={n_live}"] = \
                cs._time_ms(lambda: kern(*args), 200)[0]
        del a, new, pools
        torch.cuda.empty_cache()
    return ms


def run_one(name):
    """In a copy's process: check and time, as one JSON line."""
    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.ops import paged_attention as pa
    assert not pa.__file__.startswith(ROOT), pa.__file__
    form = FORMS[name]
    if form.get("tokens"):
        pa.SPLIT_TOKENS = form["tokens"]
    if form.get("heights"):
        pa.VERIFY_HEIGHTS = form["heights"]
    dev = torch.device("cuda", 0)
    rows = form.get("rows", "decode")
    if rows == "commit":
        check = _check({"check_commit": cs.check_commit}, dev)
        print(json.dumps({"ok": all(v == "passes" for v in check.values()),
                          "splits": None, "ms": commit_ms(cs, dev),
                          "check": check}))
        return
    checks = []
    if rows in ("all", "decode"):
        checks += [("check_paged_update", cs.check_paged_update),
                   ("check_paged_read", cs.check_paged_read)]
    if rows in ("all", "verify"):
        checks += [("check_verify", cs.check_verify)]
    checks += [("check_quant", cs.check_quant)]
    if rows == "all":
        checks += [("check_commit", cs.check_commit)]
    check = _check(dict(checks), dev)
    a = cs._paged_inputs(32, 32, cs.PAGED_POSITIONS, cs.SEED + 32, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    rd = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["positions"] + 1,
          a["layer"])
    ms = {"paged_attend_update (row 3)":
          cs._time_ms(lambda: pa.paged_attend_update(*upd), 100)[0],
          "paged_attention (row 2)":
          cs._time_ms(lambda: pa.paged_attention(*rd), 100)[0]}
    a = cs._paged_inputs(32, 32, cs.PAGED_STEP_POSITIONS, cs.SEED + 33, dev)
    upd = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
           a["tables"], a["positions"], a["layer"])
    ms["paged_attend_update (row 3), even rows"] = cs._time_ms(
        lambda: pa.paged_attend_update(*upd), 100)[0]
    splits = pa.kernel_splits(a["tables"].shape[1], 128)
    del a, upd, rd
    for key, positions, width, seed in (
            ("", cs.PAGED_POSITIONS, None, 71),
            (", even rows", cs.PAGED_STEP_POSITIONS, 16, 75)):
        a = cs._quant_inputs(32, 32, positions, cs.SEED + seed, dev,
                             torch.bfloat16, max_nb=width)
        pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        new = [a[k][-1, :, 0].contiguous()
               for k in ("new_k", "new_v", "new_ks", "new_vs")]
        upd = (a["q"], *new, *pools, a["tables"], a["rows"], a["layer"])
        rd = (a["q"], *pools, a["tables"], a["rows"] + 1, a["layer"])
        ms[f"paged_attend_update_quant (row 5){key}"] = cs._time_ms(
            lambda: pa.paged_attend_update_quant(*upd), 100)[0]
        ms[f"paged_attention_quant (row 4){key}"] = cs._time_ms(
            lambda: pa.paged_attention_quant(*rd), 100)[0]
        del a, pools, new, upd, rd
    T = cs.SPEC_K + 1
    qstart = [p + 1 for p in cs.PAGED_POSITIONS]
    for key, rows_q, width, seed in (
            ("", qstart, None, 0),
            (", even rows", cs.VERIFY_STEP_QSTART, cs.VERIFY_STEP_MAX_NB, 2)):
        a = cs._verify_inputs(32, 32, rows_q, T, cs.SEED + 61 + seed, dev,
                              max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                a["layer"])
        ms[f"paged_attention_verify (row 6){key}"] = cs._time_ms(
            lambda: pa.paged_attention_verify(*call), 100)[0]
        a = cs._quant_inputs(32, 32, rows_q, cs.SEED + 72 + seed, dev,
                             torch.bfloat16, T=T, max_nb=width)
        call = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        ms[f"paged_attention_verify_quant (row 7){key}"] = cs._time_ms(
            lambda: pa.paged_attention_verify_quant(*call), 100)[0]
        del a, call
    if rows == "all":
        ms.update(commit_ms(cs, dev))
    print(json.dumps({"ok": all(v == "passes" for v in check.values()),
                      "splits": splits, "ms": ms, "check": check}))


def _run(args, copy):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _last_json(name, p, timeout):
    stdout, stderr = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def main(names):
    unknown = set(names) - set(FORMS)
    if unknown:
        sys.exit(f"unknown forms {sorted(unknown)}; known: {list(FORMS)}")
    forms = {n: f for n, f in FORMS.items()
             if n == "shipped" or not names or n in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    tmp = tempfile.mkdtemp(prefix="paged_choices_")
    copies, procs = {}, []
    record = {"nvidia_smi": smi, "ptxas": {}, "runs": []}
    good = True
    try:
        for name, form in forms.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "paged_attention.cu")
            src = open(cu).read()
            for edit in form.get("edits", []):
                if callable(edit):
                    src = edit(src)
                    continue
                old, new = edit
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(cu, "w") as f:
                f.write(src)
        procs = [(name, _run(["--build"], copies[name])) for name in forms]
        for name, p in procs:
            record["ptxas"][name] = _last_json(name, p, 900)
            for line in record["ptxas"][name]:
                print(f"{name} ptxas {line}")
        for name in list(forms) + list(reversed(forms)):
            p = _run(["--one", name], copies[name])
            procs.append((name, p))
            run = dict(form=name, **_last_json(name, p, 900))
            record["runs"].append(run)
            good &= run["ok"]
            print(json.dumps({k: run[k] for k in ("form", "ok", "splits",
                                                  "ms")}))
            if not run["ok"]:
                print(f"{name} FAILED its check: {run['check']}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_choices.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main(sys.argv[1:])
