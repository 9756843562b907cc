"""Paged attention for the serving engine: the CUDA kernels
``csrc/paged_attention.cu`` and their plain PyTorch versions (port of
``paddle_tpu/ops/paged_attention.py``).

  paged_attend_update     ports ``paged_attend_update``
                          (``_paged_update_kernel``): write one column,
                          then decode attention
  paged_attention         ports ``paged_attention`` (``_paged_kernel``):
                          read-only decode attention (the update with
                          the write off)
  paged_attention_verify  ports ``paged_attention_verify``
                          (``_paged_verify_kernel``): T fed tokens per row
                          over the cached prefix, unfinalised partials
  paged_verify_commit     ports ``paged_verify_commit``
                          (``_paged_commit_kernel``): the accepted columns
                          of every layer into the pools

and their int8 twins over int8 pools with f32 per-column scale pools
(``kv_quant_columns`` is the one quantizer of both sides):

  paged_attend_update_quant     ports ``paged_attend_update_quant``
  paged_attention_quant         ports ``paged_attention_quant`` (the
                                update with the write off)
  paged_attention_verify_quant  ports ``paged_attention_verify_quant``
  paged_verify_commit_quant     ports ``paged_verify_commit_quant``

Layouts (the JAX package's pools, so they compare directly):
  q          [B, NH, HD]          PRE-SCALED by scale * log2(e)
  q (verify) [B, T, NH, HD]       the same, per fed token
  new_k/v    [B, KVD]             KVD = NKV * HD
  new_k/v    [L, B, T, KVD]       (commit) every layer's fed columns
  pools      [L, NP, KVD, bs]     time in the minor dimension
  scales     [L, NP, NKV, bs]     (int8 pools) f32, one per (block,
                                  kv-head, column); zero where unwritten
  tables     [B, max_nb] int32    pool block ids per sequence slot
  positions  [B] int32            the NEW token's position per row
  lengths    [B] int32            (read-only entries) tokens read per row
  qstart     [B] int32            (verify, commit) cached tokens per row

Unlike the TPU entries, q is per head, not the block-diagonal padding
[B, R, KVD] that the TPU's matrix unit wanted, and the verify partials
are per head (acc [B, T, NH, HD], m and l [B, T, NH]) rather than
[B, R, KVD] and [B, R, 128]. The update and the commit write the pools IN
PLACE (the JAX package donates them). A read-only row of length 0 gets
the output 0 (JAX skips it and leaves it unwritten). Padding rows point
their tables at the reserved null block 0 (position 0, qstart 0). The
commit kernels write only the live columns (t < commit_len) and never
block 0, where the plain versions (and JAX) route the rejected and
padding columns into block 0: block 0's contents are unspecified, and
every other block gets the same bits. A verify row with qstart 0 gets
the defined partials acc = 0, l = 0, m = -1e30 (JAX leaves them
unwritten and masks them).

What bounds the kernels on the card: the attention entries (rows 2-7)
read each row's K and V once at a few operations per byte, so bytes;
the commit (rows 8, 9) writes a window of at most T columns into each of
the KVD rows of a pool block, rows bs elements apart, so every pool row
costs a scattered 32-byte sector (one or two): its floor is sectors
written, not bytes (chip_smoke prints both bounds).

The softmax is the online recurrence only, per pool block, in the log2
domain; the TPU default's tile-0-anchored variant is not ported. The
merge of verify partials is exact for any anchor, so the two compare
through :func:`merge_verify_partials` or acc / l and m + log2(l).

On the card the attention entries (rows 2-7) split each row's context
across CTAs (:func:`kernel_splits` splits from the table width and the
block size). Each split starts from the max of the scores before it, so
P is rounded as in one walk (the int8 reads, which never round P, let
each split start from its own max); the partial states are combined in
split order (the same bits on every run), and only that f32 combine
differs from one walk (the verify reads leave the combined state
unfinalised). The plain versions' ``splits=n`` (``paged_attend_update_plain``,
``paged_attention_plain``, ``paged_attend_update_quant_plain``,
``paged_attention_quant_plain``, ``paged_attention_verify_plain``,
``paged_attention_verify_quant_plain``) is the same computation for n
splits. The verify kernels take a (row, kv-head)'s T * NH / NKV query
rows in chunks (:func:`verify_chunks`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .decode_attention import _sync_words

LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_REPS = (1, 2, 4, 8)    # query heads per kv head the kernels are built for
MAX_FED = 8             # fed tokens per row the verify and commit kernels take


def paged_attend_update_plain(q, new_k, new_v, k_pool, v_pool, tables,
                              positions, layer: int,
                              splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version on any device, block by block with the
    kernel's online softmax: P rounded to the pool dtype before P.V, the
    normaliser summed from the unrounded f32 P. Returns attn
    [B, NH, HD] f32; updates the pools in place.

    ``splits`` > 1 runs the kernel's split-context form (see
    :func:`_attend_plain`); pass :func:`kernel_splits` for the kernel's
    own split."""
    B = q.shape[0]
    bs = k_pool.shape[-1]
    pos = positions.long()
    rows = torch.arange(B, device=q.device)
    blk_new = tables[rows, pos // bs].long()
    k_pool[layer, blk_new, :, pos % bs] = new_k.to(k_pool.dtype)
    v_pool[layer, blk_new, :, pos % bs] = new_v.to(v_pool.dtype)
    return _attend_plain(q, k_pool, v_pool, tables, pos, layer, splits)


def paged_attention_plain(q, k_pool, v_pool, tables, lengths, layer: int,
                          splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version on any device of the read-only entry:
    attention over tokens 0..lengths[b]-1, nothing written, with
    :func:`paged_attend_update_plain`'s walk, rounding points and
    ``splits``. Returns attn [B, NH, HD] f32; a row of length 0 gets 0."""
    out = _attend_plain(q, k_pool, v_pool, tables, lengths.long() - 1, layer,
                        splits)
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.tensor(0.0, device=q.device))


def split_blocks(max_nb: int, splits: int) -> int:
    """Blocks per split when ``splits`` CTAs share a table of ``max_nb``
    blocks: contiguous runs of this many of a row's blocks."""
    return -(-max_nb // max(1, min(int(splits), max_nb)))


def _attend_plain(q, k_pool, v_pool, tables, last, layer, splits=1):
    """Online softmax of q [B, NH, HD] over tokens 0..last[b] of each row,
    block by block (P rounded to the pool dtype before P.V, the
    normaliser summed from the unrounded f32 P). Returns [B, NH, HD] f32.

    ``splits`` > 1 is the kernel's split-context form
    (:func:`_online_walk`)."""
    B, NH, HD = q.shape
    bs = k_pool.shape[-1]
    nkv = k_pool.shape[2] // HD
    acc, _, l = _online_walk(
        q.float().reshape(B, nkv, NH // nkv, HD), tables, last, bs,
        _pool_blocks(k_pool, v_pool, layer, B, nkv, HD),
        lambda p: p.to(v_pool.dtype).float(), splits)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, NH, HD)


def _pool_blocks(k_pool, v_pool, layer, B, nkv, HD):
    """K and V [B, NKV, HD, bs] f32 of the pool blocks blk [B] at
    ``layer``: the block reader of :func:`_online_walk`."""
    bs = k_pool.shape[-1]

    def block(blk):
        return (k_pool[layer, blk].float().reshape(B, nkv, HD, bs),
                v_pool[layer, blk].float().reshape(B, nkv, HD, bs))
    return block


def _online_walk(qf, tables, last, bs, block, round_p, splits=1,
                 look_back=True):
    """The kernels' online softmax of the query rows qf [B, NKV, R, HD] f32
    over tokens 0..last[b] of each row, pool block by pool block:
    ``block(blk)`` gives K and V [B, NKV, HD, bs] f32 of the blocks blk [B],
    ``round_p`` rounds P before P.V (to the pool dtype; int8 pools keep it
    f32), and l sums the unrounded P. Returns the unfinalised (acc [B, NKV,
    R, HD], m [B, NKV, R], l [B, NKV, R]); a row with last < 0 comes back
    with meaningless partials for the caller to replace. A column past
    last[b] never enters a product: its score is replaced by -1e30 and its
    V by 0 (selection, so stale NaN or Inf in a pool block, its scales
    included, cannot reach the result); every column up to last[b] lies in
    a block the row's table names.

    ``splits`` > 1 is the kernels' split-context form: a row's blocks are
    cut into runs of :func:`split_blocks` blocks, each run takes the same
    recurrence from the max of all scores before it (so P is rounded
    against the same running max as one walk), and the partial states of
    the row's live runs are combined in run order, unfinalised: acc = sum
    acc_k w_k, l = sum l_k w_k, m = max m_k, w_k = exp2(m_k - m). Without
    ``look_back`` each run starts from its own max instead (the int8 verify
    kernel's form: P is never rounded there)."""
    B, nkv, R, HD = qf.shape
    dev = qf.device
    run = split_blocks(tables.shape[1], splits)
    m = torch.full((B, nkv, R), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, R), device=dev)
    acc = torch.zeros((B, nkv, R, HD), device=dev)
    col = torch.arange(bs, device=dev)
    parts = []
    for j in range(int(last.max()) // bs + 1 if B else 0):
        if j and j % run == 0:     # a run ends; the next starts from m
            parts.append((m, l, acc))  # (or from its own max)
            l, acc = torch.zeros_like(l), torch.zeros_like(acc)
            if not look_back:
                m = torch.full_like(m, float("-inf"))
        kt, vt = block(tables[:, j].long())
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = (j * bs + col)[None, :] <= last[:, None]            # [B, bs]
        s = torch.where(live[:, None, None, :], s,
                        torch.tensor(-1e30, device=dev))
        # dead columns are selected out of V, not weighted by an exact 0:
        # 0 * NaN is NaN, and a freed block is reused without clearing
        vt = torch.where(live[:, None, None, :], vt,
                         torch.tensor(0.0, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrt,bgdt->bgrd", round_p(p), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    if parts:
        parts.append((m, l, acc))
        live = [(k * run * bs <= last)[:, None, None]
                for k in range(len(parts))]
        m = torch.stack([torch.where(lv, mk, float("-inf"))
                         for lv, (mk, _, _) in zip(live, parts)]).amax(0)
        l, acc = torch.zeros_like(l), torch.zeros_like(acc)
        for lv, (mk, lk, ak) in zip(live, parts):
            w = torch.exp2(mk - m)
            l = torch.where(lv, l + lk * w, l)
            acc = torch.where(lv[..., None], acc + ak * w[..., None], acc)
    return acc, m, l


def _check_geometry(what, NH, KVD, HD, bs):
    if KVD % HD or NH % (KVD // HD) or NH // (KVD // HD) not in _REPS:
        raise ValueError(f"{what}: NH={NH}, KVD={KVD}, HD={HD} need NKV = "
                         f"KVD/HD dividing NH with NH/NKV in {_REPS}")
    if bs % 128 or bs > 1024:
        raise ValueError(f"{what}: block size {bs} must be a multiple of "
                         f"128, at most 1024")
    tp = bs // HD if HD and bs % HD == 0 else 0
    if HD % 8 or tp < 1 or tp > 32 or tp & (tp - 1):
        raise ValueError(f"{what}: head_dim {HD} must be a multiple of 8 "
                         f"with bs/HD a power of two <= 32")


def _check_common(what, tensors, pools, tables, rows_of):
    """Device, contiguity and pool/table types shared by the entries."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{what}: all tensors must share one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if pools[0].dtype not in _DTYPE_CODE or pools[1].dtype != pools[0].dtype:
        raise TypeError(f"{what}: pools must share one dtype of "
                        f"{list(_DTYPE_CODE)}")
    if pools[1].shape != pools[0].shape or pools[0].ndim != 4:
        raise ValueError(f"{what}: pools must share one [L, NP, KVD, bs] "
                         f"shape")
    if tables.dtype != torch.int32 or any(t.dtype != torch.int32
                                          for t in rows_of):
        raise TypeError(f"{what}: tables and per-row indices must be "
                        f"int32")
    B = tables.shape[0]
    if tables.ndim != 2 or any(t.shape != (B,) for t in rows_of):
        raise ValueError(f"{what}: tables [B, max_nb] and per-row indices "
                         f"[B] must agree")


def _check(q, new_k, new_v, k_pool, v_pool, tables, positions, layer):
    B, NH, HD = q.shape
    L, NP, KVD, bs = k_pool.shape
    what = "paged_attend_update"
    _check_common(what, (q, new_k, new_v, k_pool, v_pool, tables,
                         positions), (k_pool, v_pool), tables, (positions,))
    if any(t.dtype != k_pool.dtype for t in (q, new_k, new_v)):
        raise TypeError(f"{what}: q, new_k/new_v and pools must share one "
                        f"dtype")
    _check_geometry(what, NH, KVD, HD, bs)
    if new_k.shape != (B, KVD) or new_v.shape != (B, KVD) \
            or tables.shape[0] != B:
        raise ValueError(f"{what}: new columns [B, KVD] and tables must "
                         f"match q's batch")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# The split walk of rows 2-7 (csrc/paged_attention.cu): the tokens a split
# aims to hold, and the most splits a launch takes (kMaxSplits there, which
# checks it)
SPLIT_TOKENS = 128
MAX_SPLITS = 256


def kernel_splits(max_nb: int, bs: int) -> int:
    """The split count the kernels of rows 2-7 take for tables of
    ``max_nb`` blocks of ``bs`` tokens: runs of ``SPLIT_TOKENS`` tokens
    (at least one block), more where the table is wider than
    ``MAX_SPLITS`` runs. It depends on the shapes, never on the lengths.
    Pass it to the plain versions as ``splits`` for the kernel's own
    split."""
    run = max(-(-SPLIT_TOKENS // bs), -(-max_nb // MAX_SPLITS))
    return -(-max_nb // run)


def _launch_split(what, symbol, ptrs, q, pools, tables, layer):
    """Rows 2-5 on the card: ``ptrs`` are the entry's leading tensor
    arguments, ``pools`` the K and V pools (and, int8, their scale pools);
    the output, the split scratch and the sync words follow."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q,) + pools):
        raise ValueError(f"{what}: q and the pools must start on 16-byte "
                         f"aligned storage")
    B, NH, HD = q.shape
    _, NP, KVD, bs = pools[0].shape
    nkv, max_nb = KVD // HD, tables.shape[1]
    nsplit = kernel_splits(max_nb, bs)
    out = torch.empty((B, NH, HD), dtype=torch.float32, device=q.device)
    part = torch.empty(B * nkv * nsplit * (3 + HD) * (NH // nkv),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    sync = _sync_words(B * nkv * (2 + nsplit), q.device, stream)
    fn = _build.kernel("paged_attention", symbol,
                       [ctypes.c_void_p] * (len(ptrs) + 3)
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(), part.data_ptr(),
             sync.data_ptr(), B, int(layer), NP, NH, nkv, HD, bs, max_nb,
             nsplit, _DTYPE_CODE[q.dtype], stream.cuda_stream)
    _build.check("paged_attention", err, what)
    return out


def paged_attend_update(q, new_k, new_v, k_pool, v_pool, tables,
                        positions, layer: int) -> torch.Tensor:
    """Write each row's new k/v column into the pools in place, then
    attend over the row's prefix including it. Returns attn [B, NH, HD]
    f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attend_update_plain`.
    ``paged_attend_update.launches`` counts kernel launches."""
    _check(q, new_k, new_v, k_pool, v_pool, tables, positions, layer)
    if q.device.type == "cpu":
        return paged_attend_update_plain(q, new_k, new_v, k_pool, v_pool,
                                         tables, positions, layer)
    out = _launch_split("paged_attend_update", "paged_attend_update_fwd",
                        (q, new_k, new_v, k_pool, v_pool, tables, positions),
                        q, (k_pool, v_pool), tables, layer)
    paged_attend_update.launches += 1
    return out


paged_attend_update.launches = 0


def paged_attention(q, k_pool, v_pool, tables, lengths,
                    layer: int) -> torch.Tensor:
    """Row 2, read-only paged decode attention over tokens
    0..lengths[b]-1 (row 3's kernel with the write compiled out). q
    [B, NH, HD] in the pools' dtype, pre-scaled by scale * log2(e).
    Returns attn [B, NH, HD] f32; a row of length 0 gets 0.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attention_plain`. ``paged_attention.launches``
    counts kernel launches."""
    what = "paged_attention"
    _check_common(what, (q, k_pool, v_pool, tables, lengths),
                  (k_pool, v_pool), tables, (lengths,))
    if q.ndim != 3 or q.dtype != k_pool.dtype:
        raise TypeError(f"{what}: q must be [B, NH, HD] in the pools' dtype")
    B, NH, HD = q.shape
    L, NP, KVD, bs = k_pool.shape
    _check_geometry(what, NH, KVD, HD, bs)
    if tables.shape[0] != B:
        raise ValueError(f"{what}: tables must match q's batch")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, lengths,
                                     layer)
    out = _launch_split(what, "paged_attention_fwd",
                        (q, k_pool, v_pool, tables, lengths), q,
                        (k_pool, v_pool), tables, layer)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# -- speculative verification ---------------------------------------------


def merge_verify_partials(acc_c, m_c, l_c, acc_f, m_f, l_f):
    """Exact online-softmax merge of the cached prefix's partials with the
    fed tokens' partials: rescale both exp2 sums to the common max and
    finalise once. Exact for ANY anchor m (tile-0 or running max). m and l
    broadcast against acc (trailing size-1 axis). Returns attn f32."""
    m_tot = torch.maximum(m_c, m_f)
    a_c = torch.exp2(m_c - m_tot)
    a_f = torch.exp2(m_f - m_tot)
    num = acc_c * a_c + acc_f * a_f
    den = l_c * a_c + l_f * a_f
    return num / torch.clamp(den, min=1e-30)


def paged_attention_verify_plain(q, k_pool, v_pool, tables, qstart,
                                 layer: int, splits: int = 1):
    """Plain PyTorch version on any device, block by block with the
    kernel's online softmax over tokens 0..qstart-1: P rounded to the pool
    dtype before P.V, l summed from the unrounded f32 P. Returns the
    unfinalised (acc [B, T, NH, HD], m [B, T, NH], l [B, T, NH]) f32;
    rows with qstart 0 get acc = 0, l = 0, m = -1e30.

    ``splits`` > 1 runs the kernel's split-context form
    (:func:`_online_walk`); pass :func:`kernel_splits` for the kernel's
    own split."""
    B, T, NH, HD = q.shape
    nkv = k_pool.shape[2] // HD
    partials = _online_walk(
        _verify_rows(q, nkv), tables, qstart.long() - 1, k_pool.shape[-1],
        _pool_blocks(k_pool, v_pool, layer, B, nkv, HD),
        lambda p: p.to(v_pool.dtype).float(), splits)
    return _verify_heads(partials, qstart, T)


def _verify_rows(q, nkv):
    """q [B, T, NH, HD] as the kernels' query rows of kv-head g [B, NKV,
    T * rep, HD] f32: row i = t * rep + rr is token t's head g * rep + rr."""
    B, T, NH, HD = q.shape
    rep = NH // nkv
    return q.float().reshape(B, T, nkv, rep, HD).transpose(1, 2) \
        .reshape(B, nkv, T * rep, HD)


def _verify_heads(partials, qstart, T):
    """The verify walk's (acc, m, l) over the rows of :func:`_verify_rows`
    back to per-head partials (acc [B, T, NH, HD], m and l [B, T, NH]), a
    row with qstart 0 given acc = 0, l = 0, m = -1e30."""
    acc, m, l = partials
    B, nkv, R, HD = acc.shape
    rep = R // T
    dev = acc.device
    dead = (qstart <= 0)[:, None, None]
    m = torch.where(dead, torch.tensor(-1e30, device=dev), m)
    l = torch.where(dead, torch.tensor(0.0, device=dev), l)
    acc = torch.where(dead[..., None], torch.tensor(0.0, device=dev), acc)
    acc = acc.reshape(B, nkv, T, rep, HD).transpose(1, 2) \
        .reshape(B, T, nkv * rep, HD)
    m = m.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, nkv * rep)
    l = l.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, nkv * rep)
    return acc, m, l


def _check_verify(q, k_pool, v_pool, tables, qstart, layer):
    what = "paged_attention_verify"
    _check_common(what, (q, k_pool, v_pool, tables, qstart),
                  (k_pool, v_pool), tables, (qstart,))
    if q.ndim != 4 or q.dtype != k_pool.dtype:
        raise ValueError(f"{what}: q must be [B, T, NH, HD] in the pools' "
                         f"dtype")
    B, T, NH, HD = q.shape
    L, NP, KVD, bs = k_pool.shape
    _check_geometry(what, NH, KVD, HD, bs)
    if tables.shape[0] != B:
        raise ValueError(f"{what}: tables must match q's batch")
    if not 1 <= T <= MAX_FED:
        raise ValueError(f"{what}: {T} fed tokens; the kernel takes 1 to "
                         f"{MAX_FED}")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")


# The verify read's chunks (csrc/paged_attention.cu): the query rows of a
# (row, kv-head) in chunks of one of these heights, the kernels compiled
# for them
VERIFY_HEIGHTS = (2, 4, 5, 8)


def verify_chunks(rows: int) -> tuple[int, int]:
    """(chunks, height) of the verify kernels for ``rows`` = T * NH / NKV
    query rows of a (row, kv-head): as few chunks as the largest height
    allows, each of the least compiled height that holds an even share
    (llama_7b's T = 5 at MHA: one chunk of 5, no padding row)."""
    n = -(-rows // max(VERIFY_HEIGHTS))
    height = min(h for h in VERIFY_HEIGHTS if h >= -(-rows // n))
    return -(-rows // height), height


def _launch_verify(what, symbol, ptrs, q, k_pool, tables, layer):
    """Rows 6 and 7 on the card: ``ptrs`` are the entry's leading tensor
    arguments; the outputs, the split scratch and the sync words follow.
    Returns (acc, m, l)."""
    if any(t.data_ptr() % 16 for t in ptrs[:-2]):
        raise ValueError(f"{what}: q, the pools and the scale pools must "
                         f"start on 16-byte aligned storage")
    B, T, NH, HD = q.shape
    _, NP, KVD, bs = k_pool.shape
    nkv, max_nb = KVD // HD, tables.shape[1]
    nsplit = kernel_splits(max_nb, bs)
    nchunk, height = verify_chunks(T * (NH // nkv))
    dev = q.device
    acc = torch.empty((B, T, NH, HD), dtype=torch.float32, device=dev)
    m = torch.empty((B, T, NH), dtype=torch.float32, device=dev)
    l = torch.empty((B, T, NH), dtype=torch.float32, device=dev)
    part = torch.empty(B * nkv * nchunk * nsplit * (3 + HD) * height,
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    sync = _sync_words(B * nkv * nchunk * (2 + nsplit), dev, stream)
    fn = _build.kernel("paged_attention", symbol,
                       [ctypes.c_void_p] * (len(ptrs) + 5)
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ptrs), acc.data_ptr(), m.data_ptr(),
             l.data_ptr(), part.data_ptr(), sync.data_ptr(), B, T,
             int(layer), NP, NH, nkv, HD, bs, max_nb, nsplit, nchunk, height,
             _DTYPE_CODE[q.dtype], stream.cuda_stream)
    _build.check("paged_attention", err, what)
    return acc, m, l


def paged_attention_verify(q, k_pool, v_pool, tables, qstart, layer: int):
    """Multi-token verification read over each row's CACHED prefix
    (tokens 0..qstart[b]-1). q [B, T, NH, HD] is pre-scaled by
    scale * log2(e). Returns unfinalised f32 partials (acc [B, T, NH, HD],
    m [B, T, NH], l [B, T, NH]); m is the running max, so compare
    merged or finalised values with other anchors.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attention_verify_plain`.
    ``paged_attention_verify.launches`` counts kernel launches."""
    _check_verify(q, k_pool, v_pool, tables, qstart, layer)
    if q.device.type == "cpu":
        return paged_attention_verify_plain(q, k_pool, v_pool, tables,
                                            qstart, layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_verify: unsupported device "
                         f"{q.device}")
    out = _launch_verify("paged_attention_verify",
                         "paged_attention_verify_fwd",
                         (q, k_pool, v_pool, tables, qstart), q, k_pool,
                         tables, layer)
    paged_attention_verify.launches += 1
    return out


paged_attention_verify.launches = 0


def paged_commit_schedule(qstart, commit_len, tables, n_layers: int,
                          n_tokens: int, block_size: int) -> torch.Tensor:
    """Flat commit walk [6, L*B*T] int32, layer-major then sequence then
    token, fields (layer, block, column, first, sequence, token): fed token
    t of row b commits at position qstart[b] + t iff t < commit_len[b];
    rejected and dead columns go to the null block 0. ``first`` marks a
    change of (layer, block) along the walk. Bitwise the JAX function's."""
    B, max_nb = tables.shape
    T = int(n_tokens)
    dev = tables.device
    idx = torch.arange(int(n_layers) * B * T, dtype=torch.int32, device=dev)
    li = idx // (B * T)
    bi = (idx // T) % B
    ti = idx % T
    pos = qstart[bi.long()].int() + ti
    commit = ti < commit_len[bi.long()].int()
    slot = torch.clamp(pos // block_size, 0, max_nb - 1)
    bid = torch.where(commit, tables[bi.long(), slot.long()].int(),
                      torch.zeros_like(pos))
    col = pos % block_size
    head = torch.full((1,), -1, dtype=torch.int32, device=dev)
    prev_l = torch.cat([head, li[:-1]])
    prev_b = torch.cat([head, bid[:-1]])
    first = ((li != prev_l) | (bid != prev_b)).int()
    return torch.stack([li, bid, col, first, bi, ti])


def paged_verify_commit_plain(new_k, new_v, k_pool, v_pool, tables, qstart,
                              commit_len):
    """Plain PyTorch version on any device: one advanced-index assignment
    along :func:`paged_commit_schedule`. Writes the pools in place and
    returns them. Block 0 receives the rejected columns in no set
    order."""
    L, B, T, KVD = new_k.shape
    sc = paged_commit_schedule(qstart, commit_len, tables, L, T,
                               k_pool.shape[-1]).long()
    li, bid, col, _, bi, ti = sc
    k_pool[li, bid, :, col] = new_k[li, bi, ti].to(k_pool.dtype)
    v_pool[li, bid, :, col] = new_v[li, bi, ti].to(v_pool.dtype)
    return k_pool, v_pool


def paged_verify_commit(new_k, new_v, k_pool, v_pool, tables, qstart,
                        commit_len):
    """Post-verification cache commit over all layers in one launch: fed
    token t's column of new_k/new_v [L, B, T, KVD] (pool dtype) lands at
    position qstart[b] + t for every t < commit_len[b]. Writes the pools in
    place and returns them.

    The kernel writes only those live columns and never block 0; the plain
    version routes the rejected and padding columns into block 0, as the
    JAX schedule does. Every other block gets the same bits either way
    (block 0's contents are unspecified). Each pool row takes a window of
    up to T columns bs elements from the next row's, so the kernel is
    bound by scattered 32-byte sectors, not bytes: a warp owns 16 pool
    rows of a (layer, row), a lane a fed token, so that one store writes
    4 rows' whole windows, each sector once.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_verify_commit_plain`.
    ``paged_verify_commit.launches`` counts kernel launches."""
    what = "paged_verify_commit"
    _check_common(what, (new_k, new_v, k_pool, v_pool, tables, qstart,
                         commit_len), (k_pool, v_pool), tables,
                  (qstart, commit_len))
    L, NP, KVD, bs = k_pool.shape
    if new_k.dtype != k_pool.dtype or new_v.dtype != k_pool.dtype:
        raise TypeError(f"{what}: new columns must be in the pools' dtype")
    if new_k.ndim != 4 or new_v.shape != new_k.shape \
            or new_k.shape[0] != L or new_k.shape[1] != tables.shape[0] \
            or new_k.shape[3] != KVD:
        raise ValueError(f"{what}: new_k/new_v must be [L, B, T, KVD] of "
                         f"the pools' L and KVD and the tables' B")
    T = new_k.shape[2]
    if not 1 <= T <= MAX_FED:
        raise ValueError(f"{what}: {T} fed tokens; the kernel takes 1 to "
                         f"{MAX_FED}")
    if new_k.device.type == "cpu":
        return paged_verify_commit_plain(new_k, new_v, k_pool, v_pool,
                                         tables, qstart, commit_len)
    if new_k.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {new_k.device}")
    fn = _build.kernel("paged_attention", "paged_verify_commit_fwd",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    err = fn(new_k.data_ptr(), new_v.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), tables.data_ptr(), qstart.data_ptr(),
             commit_len.data_ptr(), L, tables.shape[0], T, NP, KVD, bs,
             tables.shape[1], _DTYPE_CODE[k_pool.dtype], _stream(k_pool))
    _build.check("paged_attention", err, what)
    paged_verify_commit.launches += 1
    return k_pool, v_pool


paged_verify_commit.launches = 0


# -- int8 paged KV ----------------------------------------------------------
#
# Pools of int8 codes with f32 scale pools [L, NP, NKV, bs]: one symmetric
# absmax scale per (block, kv-head, column). Every column is quantized
# once, from its own values, by kv_quant_columns, outside the kernels, on
# the prefill scatter, the decode update and the verify commit alike; the
# kernels merge the given bytes and scales and never requantize. Reads
# dequantize per column (f32(code) * scale), q is cast to f32, and P stays
# f32 before P.V: there is no low-precision V to round it to.

KV_QMAX = 127.0
KV_SCALE_FLOOR = 1e-8
# 1/127 rounded to f32: the JAX package's jitted steps, where every pool
# byte is written, compute absmax / 127 as absmax * f32(1/127); the eager
# JAX call divides and differs by one ulp in a few scales
_INV_QMAX = np.float32(1.0 / KV_QMAX)


def kv_quant_columns(x: torch.Tensor, nkv: int):
    """Symmetric per-column, per-kv-head int8 quantization of KV columns:
    x [N, KVD] (KVD = nkv * hd, any float dtype) -> (codes int8 [N, KVD],
    scales f32 [N, NKV]) with scale = max(absmax * f32(1/127), 1e-8) over
    each column's hd-slice and code = round(x / scale) (half to even),
    clamped to +-127. Bitwise ``jax.jit(kv_quant_columns)``."""
    n, kvd = x.shape
    hd = kvd // int(nkv)
    xf = x.float().reshape(n, int(nkv), hd)
    inv = torch.tensor(_INV_QMAX, device=x.device)
    s = torch.clamp(xf.abs().amax(dim=-1) * inv, min=KV_SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / s[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8).reshape(n, kvd), s


def kv_dequant_blocks(codes: torch.Tensor, scales: torch.Tensor):
    """Pool blocks [..., KVD, bs] int8 with their scales [..., NKV, bs]
    dequantized to f32 per column: f32(code) * scale."""
    *lead, kvd, bs = codes.shape
    nkv = scales.shape[-2]
    return (codes.float().reshape(*lead, nkv, kvd // nkv, bs)
            * scales[..., None, :]).reshape(*lead, kvd, bs)


def _quant_walk(qf, k_pool, v_pool, k_scale, v_scale, tables, last, layer,
                splits=1):
    """The int8 kernels' online softmax, block by block, of query rows qf
    [B, NKV, R, HD] f32 (pre-scaled) over tokens 0..last[b] of each row:
    K and V dequantized per column, P f32 before P.V. Returns the
    unfinalised (acc [B, NKV, R, HD], m [B, NKV, R], l [B, NKV, R]); rows
    with last < 0 come back with meaningless partials for the caller to
    replace. ``splits``: :func:`_online_walk`'s, without the look-back
    (the int8 kernels')."""
    B, nkv, R, HD = qf.shape
    bs = k_pool.shape[-1]

    def block(blk):
        kt = kv_dequant_blocks(k_pool[layer, blk], k_scale[layer, blk])
        vt = kv_dequant_blocks(v_pool[layer, blk], v_scale[layer, blk])
        return kt.reshape(B, nkv, HD, bs), vt.reshape(B, nkv, HD, bs)
    return _online_walk(qf, tables, last, bs, block, lambda p: p, splits,
                        look_back=False)


def _write_quant_columns(new_k, new_v, new_ks, new_vs, k_pool, v_pool,
                         k_scale, v_scale, tables, positions, layer):
    bs = k_pool.shape[-1]
    pos = positions.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    blk = tables[rows, pos // bs].long()
    k_pool[layer, blk, :, pos % bs] = new_k
    v_pool[layer, blk, :, pos % bs] = new_v
    k_scale[layer, blk, :, pos % bs] = new_ks
    v_scale[layer, blk, :, pos % bs] = new_vs


def _attend_quant_plain(q, k_pool, v_pool, k_scale, v_scale, tables, last,
                        layer, splits=1):
    B, NH, HD = q.shape
    nkv = k_scale.shape[2]
    acc, m, l = _quant_walk(q.float().reshape(B, nkv, NH // nkv, HD), k_pool,
                            v_pool, k_scale, v_scale, tables, last, layer,
                            splits)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, NH, HD)


def paged_attend_update_quant_plain(q, new_k, new_v, new_ks, new_vs, k_pool,
                                    v_pool, k_scale, v_scale, tables,
                                    positions, layer: int,
                                    splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version on any device: writes each row's pre-quantized
    column (bytes and scales) in place, then attends over tokens
    0..positions[b] with K and V dequantized per column and P f32. Returns
    attn [B, NH, HD] f32.

    ``splits`` > 1 runs the kernel's split-context form, each run from its
    own max (P is never rounded, and the int8 kernels take no look-back;
    :func:`_quant_walk`); pass :func:`kernel_splits` for the kernel's own
    split."""
    _write_quant_columns(new_k, new_v, new_ks, new_vs, k_pool, v_pool,
                         k_scale, v_scale, tables, positions, layer)
    return _attend_quant_plain(q, k_pool, v_pool, k_scale, v_scale, tables,
                               positions.long(), layer, splits)


def paged_attention_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                tables, lengths, layer: int,
                                splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version on any device: attention over tokens
    0..lengths[b]-1 of int8 pools, nothing written, with
    :func:`paged_attend_update_quant_plain`'s walk and ``splits``. Returns
    attn [B, NH, HD] f32; a row of length 0 gets 0."""
    out = _attend_quant_plain(q, k_pool, v_pool, k_scale, v_scale, tables,
                              lengths.long() - 1, layer, splits)
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.tensor(0.0, device=q.device))


def paged_attention_verify_quant_plain(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, qstart, layer: int,
                                       splits: int = 1):
    """Plain PyTorch version on any device of the int8 verify read over
    tokens 0..qstart-1: the contract of :func:`paged_attention_verify_plain`
    with K and V dequantized per column and P f32. Rows with qstart 0 get
    acc = 0, l = 0, m = -1e30. ``splits``: the kernel's split-context form,
    as in :func:`paged_attention_verify_plain` but each run from its own
    max (P is never rounded, and the int8 kernel takes no look-back)."""
    T = q.shape[1]
    nkv = k_scale.shape[2]
    partials = _quant_walk(_verify_rows(q, nkv), k_pool, v_pool, k_scale,
                           v_scale, tables, qstart.long() - 1, layer, splits)
    return _verify_heads(partials, qstart, T)


def paged_verify_commit_quant_plain(new_k, new_v, new_ks, new_vs, k_pool,
                                    v_pool, k_scale, v_scale, tables, qstart,
                                    commit_len):
    """Plain PyTorch version on any device: one advanced-index assignment
    per pool along :func:`paged_commit_schedule`. Writes the four pools in
    place and returns them. Block 0 receives the rejected columns in no
    set order."""
    L, B, T, KVD = new_k.shape
    sc = paged_commit_schedule(qstart, commit_len, tables, L, T,
                               k_pool.shape[-1]).long()
    li, bid, col, _, bi, ti = sc
    k_pool[li, bid, :, col] = new_k[li, bi, ti]
    v_pool[li, bid, :, col] = new_v[li, bi, ti]
    k_scale[li, bid, :, col] = new_ks[li, bi, ti]
    v_scale[li, bid, :, col] = new_vs[li, bi, ti]
    return k_pool, v_pool, k_scale, v_scale


def _check_quant_pools(what, tensors, pools, scales, tables, rows_of):
    """Device, contiguity, int8 pools with their f32 scale pools, and the
    int32 tables and per-row indices: the int8 entries' common checks."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{what}: all tensors must share one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(p.dtype != torch.int8 for p in pools):
        raise TypeError(f"{what}: pools must be int8")
    if pools[0].ndim != 4 or pools[1].shape != pools[0].shape:
        raise ValueError(f"{what}: pools must share one [L, NP, KVD, bs] "
                         f"shape")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{what}: scale pools must be float32")
    L, NP, KVD, bs = pools[0].shape
    nkv = scales[0].shape[2] if scales[0].ndim == 4 else 0
    if scales[0].ndim != 4 or scales[1].shape != scales[0].shape \
            or scales[0].shape != (L, NP, nkv, bs) or nkv < 1 or KVD % nkv:
        raise ValueError(f"{what}: scale pools must be [L, NP, NKV, bs] of "
                         f"the pools' L, NP and bs, NKV dividing KVD")
    if tables.dtype != torch.int32 or any(t.dtype != torch.int32
                                          for t in rows_of):
        raise TypeError(f"{what}: tables and per-row indices must be "
                        f"int32")
    B = tables.shape[0]
    if tables.ndim != 2 or any(t.shape != (B,) for t in rows_of):
        raise ValueError(f"{what}: tables [B, max_nb] and per-row indices "
                         f"[B] must agree")
    return nkv


def _check_quant_read(what, q, pools, scales, tables, rows_of, layer,
                      q_ndim):
    """The int8 attention entries' checks: q in f32 or bf16, the pools'
    geometry, the layer, and q's batch against the tables'."""
    nkv = _check_quant_pools(what, (q,) + pools + scales + (tables,)
                             + rows_of, pools, scales, tables, rows_of)
    if q.ndim != q_ndim or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q must be a {q_ndim}-d tensor in one of "
                        f"{list(_DTYPE_CODE)}")
    L, NP, KVD, bs = pools[0].shape
    NH, HD = q.shape[-2], q.shape[-1]
    if KVD != nkv * HD:
        raise ValueError(f"{what}: KVD {KVD} must be NKV {nkv} x head_dim "
                         f"{HD}")
    _check_geometry(what, NH, KVD, HD, bs)
    if HD % 16:
        raise ValueError(f"{what}: head_dim {HD} must be a multiple of 16")
    if q.shape[0] != tables.shape[0]:
        raise ValueError(f"{what}: tables must match q's batch")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")


def _device_of(what, t):
    """'cpu' or 'cuda' for the tensor ``t``; raises on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def paged_attend_update_quant(q, new_k, new_v, new_ks, new_vs, k_pool,
                              v_pool, k_scale, v_scale, tables, positions,
                              layer: int) -> torch.Tensor:
    """Row 5, the int8 decode layer: write each row's pre-quantized column
    (new_k/new_v int8 [B, KVD], new_ks/new_vs f32 [B, NKV] from
    :func:`kv_quant_columns`) into the int8 pools and scale pools in place,
    then attend over the row's prefix including it. q [B, NH, HD] f32 or
    bf16, pre-scaled by scale * log2(e). Returns attn [B, NH, HD] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attend_update_quant_plain`.
    ``paged_attend_update_quant.launches`` counts kernel launches."""
    what = "paged_attend_update_quant"
    new = (new_k, new_v, new_ks, new_vs)
    pools, scales = (k_pool, v_pool), (k_scale, v_scale)
    _check_quant_read(what, q, pools, scales, tables, (positions,), layer, 3)
    B, KVD, NKV = q.shape[0], k_pool.shape[2], k_scale.shape[2]
    if new_k.dtype != torch.int8 or new_v.dtype != torch.int8 \
            or new_ks.dtype != torch.float32 or new_vs.dtype != torch.float32:
        raise TypeError(f"{what}: new_k/new_v must be int8 and new_ks/new_vs "
                        f"float32")
    if new_k.shape != (B, KVD) or new_v.shape != (B, KVD) \
            or new_ks.shape != (B, NKV) or new_vs.shape != (B, NKV):
        raise ValueError(f"{what}: new columns must be [B, KVD] and their "
                         f"scales [B, NKV]")
    if any(t.device != q.device or not t.is_contiguous() for t in new):
        raise ValueError(f"{what}: new columns must be contiguous on q's "
                         f"device")
    if _device_of(what, q) == "cpu":
        return paged_attend_update_quant_plain(
            q, new_k, new_v, new_ks, new_vs, k_pool, v_pool, k_scale,
            v_scale, tables, positions, layer)
    out = _launch_split(what, "paged_attend_update_quant_fwd",
                        (q, *new, *pools, *scales, tables, positions), q,
                        pools + scales, tables, layer)
    paged_attend_update_quant.launches += 1
    return out


paged_attend_update_quant.launches = 0


def paged_attention_quant(q, k_pool, v_pool, k_scale, v_scale, tables,
                          lengths, layer: int) -> torch.Tensor:
    """Row 4, read-only int8 decode attention over tokens 0..lengths[b]-1
    (row 5's kernel with the write compiled out). q [B, NH, HD] f32 or
    bf16, pre-scaled. Returns attn [B, NH, HD] f32; a row of length 0 gets
    0.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attention_quant_plain`.
    ``paged_attention_quant.launches`` counts kernel launches."""
    what = "paged_attention_quant"
    pools, scales = (k_pool, v_pool), (k_scale, v_scale)
    _check_quant_read(what, q, pools, scales, tables, (lengths,), layer, 3)
    if _device_of(what, q) == "cpu":
        return paged_attention_quant_plain(q, k_pool, v_pool, k_scale,
                                           v_scale, tables, lengths, layer)
    out = _launch_split(what, "paged_attention_quant_fwd",
                        (q, *pools, *scales, tables, lengths), q,
                        pools + scales, tables, layer)
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0


def paged_attention_verify_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 tables, qstart, layer: int):
    """Row 7, the int8 verify read over each row's CACHED prefix (tokens
    0..qstart[b]-1): the contract of :func:`paged_attention_verify` on int8
    pools with their scale pools. q [B, T, NH, HD] f32 or bf16, pre-scaled.
    Returns unfinalised f32 partials (acc [B, T, NH, HD], m [B, T, NH],
    l [B, T, NH]).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_attention_verify_quant_plain`.
    ``paged_attention_verify_quant.launches`` counts kernel launches."""
    what = "paged_attention_verify_quant"
    pools, scales = (k_pool, v_pool), (k_scale, v_scale)
    _check_quant_read(what, q, pools, scales, tables, (qstart,), layer, 4)
    T = q.shape[1]
    if not 1 <= T <= MAX_FED:
        raise ValueError(f"{what}: {T} fed tokens; the kernel takes 1 to "
                         f"{MAX_FED}")
    if _device_of(what, q) == "cpu":
        return paged_attention_verify_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, tables, qstart, layer)
    out = _launch_verify(what, "paged_attention_verify_quant_fwd",
                         (q, k_pool, v_pool, k_scale, v_scale, tables,
                          qstart), q, k_pool, tables, layer)
    paged_attention_verify_quant.launches += 1
    return out


paged_attention_verify_quant.launches = 0


def paged_verify_commit_quant(new_k, new_v, new_ks, new_vs, k_pool, v_pool,
                              k_scale, v_scale, tables, qstart, commit_len):
    """Row 9, the int8 post-verification commit over all layers in one
    launch: the contract of :func:`paged_verify_commit` with pre-quantized
    columns (new_k/new_v int8 [L, B, T, KVD], new_ks/new_vs f32
    [L, B, T, NKV] from :func:`kv_quant_columns`) into the int8 pools and
    the scale pools. Writes the four pools in place and returns them.

    The kernel is row 8's body over 1-byte codes; the lanes of a
    kv-head's first row also write the head's window of K and V scales.
    It too writes live columns only and never block 0.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`paged_verify_commit_quant_plain`.
    ``paged_verify_commit_quant.launches`` counts kernel launches."""
    what = "paged_verify_commit_quant"
    pools, scales = (k_pool, v_pool), (k_scale, v_scale)
    nkv = _check_quant_pools(
        what, (new_k, new_v, new_ks, new_vs) + pools + scales
        + (tables, qstart, commit_len), pools, scales, tables,
        (qstart, commit_len))
    L, NP, KVD, bs = k_pool.shape
    if new_k.dtype != torch.int8 or new_v.dtype != torch.int8 \
            or new_ks.dtype != torch.float32 or new_vs.dtype != torch.float32:
        raise TypeError(f"{what}: new_k/new_v must be int8 and new_ks/new_vs "
                        f"float32")
    if new_k.ndim != 4 or new_v.shape != new_k.shape \
            or new_k.shape[0] != L or new_k.shape[1] != tables.shape[0] \
            or new_k.shape[3] != KVD \
            or new_ks.shape != new_k.shape[:3] + (nkv,) \
            or new_vs.shape != new_ks.shape:
        raise ValueError(f"{what}: new_k/new_v must be [L, B, T, KVD] and "
                         f"new_ks/new_vs [L, B, T, NKV] of the pools' L, KVD "
                         f"and NKV and the tables' B")
    T = new_k.shape[2]
    if not 1 <= T <= MAX_FED:
        raise ValueError(f"{what}: {T} fed tokens; the kernel takes 1 to "
                         f"{MAX_FED}")
    if _device_of(what, new_k) == "cpu":
        return paged_verify_commit_quant_plain(
            new_k, new_v, new_ks, new_vs, k_pool, v_pool, k_scale, v_scale,
            tables, qstart, commit_len)
    fn = _build.kernel("paged_attention", "paged_verify_commit_quant_fwd",
                       [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    err = fn(new_k.data_ptr(), new_v.data_ptr(), new_ks.data_ptr(),
             new_vs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
             qstart.data_ptr(), commit_len.data_ptr(), L, tables.shape[0], T,
             NP, KVD, nkv, bs, tables.shape[1], _stream(k_pool))
    _build.check("paged_attention", err, what)
    paged_verify_commit_quant.launches += 1
    return k_pool, v_pool, k_scale, v_scale


paged_verify_commit_quant.launches = 0
