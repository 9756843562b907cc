"""Packed varlen flash attention: the CUDA kernels ``csrc/flash_varlen.cu``
and their plain PyTorch versions (port of ``paddle_tpu/ops/flash_varlen.py``).

  varlen_fwd      ports ``_flash_varlen_fwd_impl`` (``_fwd_kernel_varlen``);
                  the same kernel covers ``_flash_varlen_fwd_stacked``,
                  which computes the same function at another TPU tiling
  varlen_bwd      ports ``_bwd_fused_call`` (``_bwd_fused_kernel_varlen``)
  varlen_bwd_dkv  ports the split dK/dV of ``_flash_varlen_bwd``
  varlen_bwd_dq   ports the split dQ of ``_flash_varlen_bwd``

Sequences are packed along the token axis; ``cu`` [n_seq + 1] int32 holds
their offsets (``cu[0] = 0``, ``cu[-1]`` = the total). Query row r of
segment s attends keys ``cu_k[s] .. cu_k[s + 1] - 1``, and under causal only
those at a position within the segment <= r's (top-left, also for cross-
attention with unequal lengths). A row with no live key gets o = 0 and
lse = 0. Tokens at or past ``cu[-1]`` belong to no segment.

The kernel wrappers and plain versions take JAX's [H, T, D] layout, either
contiguous or as the transposed view of a contiguous packed [T, H, D]
(what :func:`flash_varlen_attention` passes, so the kernels read the packed
tensors in place); outputs come back in the same form. lse and delta are
[H, T] f32, lse in the natural log.

Rounding points, shared by kernels and plain versions: scores are
dot(q, k) in f32 times ``scale * log2(e)`` (scale is never folded into q in
the input dtype); the forward rounds P to the input dtype before P.V while
the normaliser sums the unrounded P; the backward rounds P for dV and dS =
P (dP - delta) scale for dK and dQ, sums in f32 and casts once.

The host planning functions below are the JAX package's, with the same
names and results. The VMEM footprints (``_stacked_nh``, ``_bwd_fused_nh``)
are kept only as JAX's path selector: stacked or not, fused or split
backward, decided from shapes alone, so the same pack takes the same path
in both packages. The port's own tiles are its kernels' (64 rows / keys),
and the TPU's flat grid sizing appears only in
:func:`varlen_schedule_stats`. Of the planning, only :func:`plan_path`
runs on a call: the kernels find their live tiles from ``cu`` on the
device, and the other planning functions are kept for parity with the
JAX package's schedule statistics.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

POS_BITS = 20
SEG_LIMIT = 1 << 10          # max sequences per pack (i32 headroom)
POS_LIMIT = 1 << POS_BITS    # max tokens per sequence
PAD_CODE = SEG_LIMIT << POS_BITS

DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
STACKED_BLOCK_Q = 512
STACKED_BLOCK_K = 512

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# the forward kernel's key tile: the plain version walks the same tiles so
# that P is rounded against the same running max
BLOCK_K = 64


def _fit_block(block, n):
    """Largest useful block <= ``block`` for length n, 128-aligned."""
    return min(block, -(-n // 128) * 128)


# ---------------------------------------------------------------------------
# planning (the JAX package's functions, on torch tensors)
# ---------------------------------------------------------------------------

def _searchsorted_right(cu, t):
    return torch.searchsorted(cu, t.to(cu.dtype), right=True)


def _codes_from_cu(cu, total):
    """cu [B+1] i32 cumulative offsets -> packed [total] codes
    (segment << POS_BITS | position)."""
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = (_searchsorted_right(cu, t) - 1).to(torch.int32)
    pos = t - cu[seg.long()]
    return (seg << POS_BITS) | pos


def _live_col_tiles(cu_rows, cu_cols, n_tiles, block_rows, block_cols,
                    total_rows):
    """Per row tile, the contiguous [lo, hi] range of column tiles holding
    any same-segment pair (the segments a row tile spans occupy one
    contiguous column range). Indices past the end clamp, as JAX's
    gathers do."""
    dev = cu_rows.device
    i = torch.arange(n_tiles, device=dev)
    r0 = torch.clamp(i * block_rows, 0, total_rows - 1)
    r1 = torch.clamp((i + 1) * block_rows - 1, 0, total_rows - 1)
    seg0 = _searchsorted_right(cu_rows, r0).long() - 1
    seg1 = _searchsorted_right(cu_rows, r1).long() - 1
    last = cu_cols.shape[0] - 1

    def at(j):
        return cu_cols[torch.clamp(j, 0, last)]

    lo = (at(seg0) // block_cols).to(torch.int32)
    hi = ((torch.maximum(at(seg1 + 1), at(seg1) + 1) - 1)
          // block_cols).to(torch.int32)
    return lo, torch.maximum(hi, lo)


def _fwd_bounds(cu_q, cu_k, n_q, block_q, block_k, t, causal, self_attn):
    """Live k-tile [lo, hi] per q tile, with the causal diagonal folded in
    for self-attention packing."""
    lo, hi = _live_col_tiles(cu_q, cu_k, n_q, block_q, block_k, t)
    if causal and self_attn:
        i = torch.arange(n_q, dtype=torch.int32, device=cu_q.device)
        diag = ((i + 1) * block_q - 1) // block_k
        hi = torch.maximum(torch.minimum(hi, diag.to(torch.int32)), lo)
    return lo.to(torch.int32), hi.to(torch.int32)


def _bwd_bounds(cu_q, cu_k, n_k, block_q, block_k, tk, causal, self_attn):
    """Live q-tile [lo, hi] per k tile (the backward's k-major
    orientation), with the causal start folded in for self-attention."""
    lo, hi = _live_col_tiles(cu_k, cu_q, n_k, block_k, block_q, tk)
    if causal and self_attn:
        j = torch.arange(n_k, dtype=torch.int32, device=cu_q.device)
        lo = torch.maximum(lo, ((j * block_k) // block_q).to(torch.int32))
        hi = torch.maximum(hi, lo)
    return lo.to(torch.int32), hi.to(torch.int32)


def _inner_steps(n_full, block_rows, block_cols, max_seqlen):
    """Static bound on the live column-tile span of any row tile (self-
    attention only; callers pass max_seqlen=None for cross-attention)."""
    if not max_seqlen:
        return n_full
    return min(n_full, (block_rows + 2 * int(max_seqlen)) // block_cols + 3)


def _flat_schedule(lo, hi, n_q, n_flat):
    """The TPU's front-packed flat schedule over the live (row-tile,
    column-tile) pairs: (qi, ki, first, last, live), each [n_flat] i32."""
    dev = lo.device
    spans = (hi - lo + 1).to(torch.int32)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.cumsum(spans, 0).to(torch.int32)])
    s = torch.arange(n_flat, dtype=torch.int32, device=dev)
    qi = torch.clamp(torch.searchsorted(cum, s, right=True) - 1,
                     0, n_q - 1).long()
    ki = torch.minimum(torch.maximum(lo[qi] + (s - cum[qi]), lo[qi]),
                       hi[qi]).to(torch.int32)
    live = s < cum[n_q]
    first = (s == cum[qi]) & live
    last = (s == cum[qi + 1] - 1) & live
    return (qi.to(torch.int32), ki, first.to(torch.int32),
            last.to(torch.int32), live.to(torch.int32))


# Scoped-VMEM plans of the TPU kernels: kept only as the path selector.
_FUSED_BWD_VMEM_BUDGET = 52 * 1024 * 1024
_STACKED_VMEM_BUDGET = 14 * 1024 * 1024


def _bwd_fused_vmem_bytes(nh, itemsize, bq, bk, d, tp):
    """The TPU fused backward's scoped-VMEM footprint of one grid step."""
    scratch = 4 * (nh * tp * d + 2 * nh * bk * d)
    blocks = (2 * nh * bq * d * itemsize      # q, do
              + 2 * nh * bk * d * itemsize    # k, v
              + 2 * nh * bq * 4               # lse, delta
              + bq * 128 * 4 + 8 * bk * 4     # code tiles
              + nh * bq * d * itemsize        # dq
              + 2 * nh * bk * d * itemsize)   # dk, dv
    temps = 4 * bq * bk * 4                   # s/p/dp/ds tiles
    return scratch + 2 * blocks + temps


def _bwd_fused_nh(h, itemsize, d, bq, bk, tp):
    """JAX's head grouping of the fused backward; 0 selects the split
    backward."""
    for cand in (8, 4, 2, 1):
        if h % cand == 0 and _bwd_fused_vmem_bytes(
                cand, itemsize, bq, bk, d, tp) <= _FUSED_BWD_VMEM_BUDGET:
            return cand
    return 0


def _stacked_vmem_bytes(nh, itemsize, bq, bk, d):
    """The TPU stacked forward's scoped-VMEM footprint of one grid step."""
    scratch = 4 * (nh * bq * bk + 2 * nh * bq * 128 + nh * bq * d)
    blocks = (nh * bq * d * itemsize          # q
              + 2 * nh * bk * d * itemsize    # k, v
              + bq * 128 * 4 + 8 * bk * 4     # code tiles
              + nh * bq * d * itemsize        # o
              + nh * bq * 4)                  # lse
    return scratch + 2 * blocks


def _stacked_nh(h, itemsize=2, d=128, bq=None, bk=None):
    """JAX's head grouping of the stacked forward; 0 when none fits."""
    bq = STACKED_BLOCK_Q if bq is None else bq
    bk = STACKED_BLOCK_K if bk is None else bk
    for cand in (8, 4, 2, 1):
        if h % cand == 0 and _stacked_vmem_bytes(
                cand, itemsize, bq, bk, d) <= _STACKED_VMEM_BUDGET:
            return cand
    return 0


def _host_bounds(cu_rows, cu_cols, n_tiles, block_rows, block_cols,
                 total_rows):
    """Numpy mirror of :func:`_live_col_tiles`."""
    i = np.arange(n_tiles)
    r0 = np.clip(i * block_rows, 0, total_rows - 1)
    r1 = np.clip((i + 1) * block_rows - 1, 0, total_rows - 1)
    seg0 = np.searchsorted(cu_rows, r0, side="right") - 1
    seg1 = np.searchsorted(cu_rows, r1, side="right") - 1
    lo = cu_cols[seg0] // block_cols
    hi = (np.maximum(cu_cols[seg1 + 1], cu_cols[seg1] + 1) - 1) // block_cols
    return lo, np.maximum(hi, lo)


def _host_schedule(cuq_np, cuk_np, tq, tk, bq, bk, causal, self_attn):
    """Live (q-tile, k-tile) pair counts of both orientations:
    (n_live_fwd, n_live_bwd, n_q, n_k)."""
    n_q = -(-tq // bq)
    n_k = -(-tk // bk)
    lo, hi = _host_bounds(cuq_np, cuk_np, n_q, bq, bk, tq)
    if causal and self_attn:
        i = np.arange(n_q)
        hi = np.maximum(np.minimum(hi, ((i + 1) * bq - 1) // bk), lo)
    n_live_fwd = int(np.sum(hi - lo + 1))
    lo2, hi2 = _host_bounds(cuk_np, cuq_np, n_k, bk, bq, tk)
    if causal and self_attn:
        j = np.arange(n_k)
        lo2 = np.maximum(lo2, (j * bk) // bq)
        hi2 = np.maximum(hi2, lo2)
    n_live_bwd = int(np.sum(hi2 - lo2 + 1))
    return n_live_fwd, n_live_bwd, n_q, n_k


def _pow2_hint(n_live):
    """Next power of two (>= 8) of a live-pair count."""
    h = 8
    while h < n_live:
        h *= 2
    return h


def _host_plan(cuq_np, cuk_np, tq, tk, h, d, itemsize, causal, self_attn,
               block_q, block_k, max_seqlen=None):
    """JAX's concrete-cu kernel plan: stacked or not, fitted blocks, and
    each orientation's live / flat / rectangular step counts."""
    stacked = False
    if self_attn and len(cuq_np) > 1 \
            and (block_q, block_k) == (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
        mean_seg = tq / (len(cuq_np) - 1)
        nh_fit = _stacked_nh(h, itemsize, d,
                             _fit_block(STACKED_BLOCK_Q, tq),
                             _fit_block(STACKED_BLOCK_K, tk))
        stacked = bool(mean_seg < 1024) and nh_fit >= 2
    if stacked:
        bq = _fit_block(STACKED_BLOCK_Q, tq)
        bk = _fit_block(STACKED_BLOCK_K, tk)
    else:
        bq, bk = _fit_block(block_q, tq), _fit_block(block_k, tk)
    live_fwd, live_bwd, n_q, n_k = _host_schedule(
        cuq_np, cuk_np, tq, tk, bq, bk, causal, self_attn)
    if not self_attn:
        max_seqlen = None
    rect_fwd = n_q * _inner_steps(n_k, bq, bk, max_seqlen)
    rect_bwd = n_k * _inner_steps(n_q, bk, bq, max_seqlen)
    return {
        "stacked": stacked,
        "block_q": int(bq),
        "block_k": int(bk),
        "fwd": {"live": live_fwd, "rect": int(rect_fwd),
                "flat": int(min(_pow2_hint(live_fwd), rect_fwd)),
                "flat_hint": _pow2_hint(live_fwd)},
        "bwd": {"live": live_bwd, "rect": int(rect_bwd),
                "flat": int(min(_pow2_hint(live_bwd), rect_bwd)),
                "flat_hint": _pow2_hint(live_bwd)},
    }


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def varlen_schedule_stats(cu_q, cu_k, heads, head_dim, *, causal,
                          self_attn=True, dtype=torch.bfloat16,
                          block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                          max_seqlen=None):
    """The TPU flat schedule's dead-vs-live step accounting for a concrete
    pack (plain ints and bools), as the JAX package reports it."""
    cuq_np = np.asarray(torch.as_tensor(cu_q).cpu())
    cuk_np = cuq_np if self_attn else np.asarray(torch.as_tensor(cu_k).cpu())
    tq, tk = int(cuq_np[-1]), int(cuk_np[-1])
    plan = _host_plan(cuq_np, cuk_np, tq, tk, heads, head_dim,
                      _itemsize(dtype), causal, self_attn, block_q, block_k,
                      int(max_seqlen) if max_seqlen else None)
    out = {"stacked": bool(plan["stacked"]),
           "block_q": plan["block_q"], "block_k": plan["block_k"]}
    for pss in ("fwd", "bwd"):
        p = plan[pss]
        out[pss] = {"live_tiles": p["live"],
                    "flat_steps": p["flat"],
                    "rect_steps": p["rect"],
                    "dead_steps_flat": p["flat"] - p["live"],
                    "dead_steps_rect": p["rect"] - p["live"]}
    return out


def plan_path(tq, tk, n_seq, h, d, dtype, self_attn,
              block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """(stacked, fused): the JAX package's choice of forward tiling and of
    fused or split backward for a pack, from shapes alone (the lengths,
    the sequence count, heads, head_dim, dtype and blocks). It reads no
    ``cu`` value, so it costs no host sync."""
    it = _itemsize(dtype)
    stacked = False
    if self_attn and n_seq >= 1 and tq > 0 \
            and (block_q, block_k) == (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
        nh_fit = _stacked_nh(h, it, d, _fit_block(STACKED_BLOCK_Q, tq),
                             _fit_block(STACKED_BLOCK_K, tk))
        stacked = bool(tq / n_seq < 1024) and nh_fit >= 2
    if stacked:
        block_q, block_k = STACKED_BLOCK_Q, STACKED_BLOCK_K
    bq, bk = _fit_block(block_q, max(tq, 1)), _fit_block(block_k, max(tk, 1))
    tp = -(-tq // bq) * bq
    return stacked, _bwd_fused_nh(h, it, d, bq, bk, tp) > 0


# ---------------------------------------------------------------------------
# plain versions (any device; the kernels' references)
# ---------------------------------------------------------------------------

_DEAD_LO = 2 ** 31 - 1


def _key_ranges(cu_q, cu_k, tq, causal):
    """Live keys [lo, hi) of every query row ([tq] int64 each); a row
    with none gets (2^31 - 1, 0)."""
    n_seq = cu_q.shape[0] - 1
    cq, ck = cu_q.long(), cu_k.long()
    t = torch.arange(tq, device=cu_q.device)
    s = torch.searchsorted(cq, t, right=True) - 1
    ok = (s >= 0) & (s < n_seq)
    sc = torch.clamp(s, 0, n_seq - 1)
    lo, hi = ck[sc], ck[sc + 1]
    if causal:
        hi = torch.minimum(hi, lo + (t - cq[sc]) + 1)
    ok &= hi > lo
    return (torch.where(ok, lo, torch.full_like(lo, _DEAD_LO)),
            torch.where(ok, hi, torch.zeros_like(hi)))


def _query_ranges(cu_q, cu_k, tk, causal):
    """Live query rows [lo, hi) of every key, dead as above."""
    n_seq = cu_q.shape[0] - 1
    cq, ck = cu_q.long(), cu_k.long()
    t = torch.arange(tk, device=cu_q.device)
    s = torch.searchsorted(ck, t, right=True) - 1
    ok = (s >= 0) & (s < n_seq)
    sc = torch.clamp(s, 0, n_seq - 1)
    lo = cq[sc] + ((t - ck[sc]) if causal else 0)
    hi = cq[sc + 1]
    ok &= hi > lo
    return (torch.where(ok, lo, torch.full_like(lo, _DEAD_LO)),
            torch.where(ok, hi, torch.zeros_like(hi)))


def _key_tiles(cu_q, cu_k, tk, causal):
    """[(c0, c1, qa, qb)] for every BLOCK_K-key tile with a live query:
    keys [c0, c1) and the rows [qa, qb) that hold all its live pairs.
    Reads cu on the host (a plain version is no hot path)."""
    if tk == 0:
        return []
    qlo, qhi = _query_ranges(cu_q, cu_k, tk, causal)
    n = -(-tk // BLOCK_K)
    pad = n * BLOCK_K - tk
    lo = torch.nn.functional.pad(qlo, (0, pad), value=_DEAD_LO)
    hi = torch.nn.functional.pad(qhi, (0, pad), value=0)
    lo = lo.view(n, BLOCK_K).amin(1).tolist()
    hi = hi.view(n, BLOCK_K).amax(1).tolist()
    return [(j * BLOCK_K, min((j + 1) * BLOCK_K, tk), a, b)
            for j, (a, b) in enumerate(zip(lo, hi)) if b > a]


def _live_mask(klo, khi, qa, qb, c0, c1):
    cols = torch.arange(c0, c1, device=klo.device)
    return (cols >= klo[qa:qb, None]) & (cols < khi[qa:qb, None])


def varlen_fwd_plain(q, k, v, cu_q, cu_k, causal, scale):
    """Plain PyTorch forward over the kernel's ``BLOCK_K``-key tiles with
    its online softmax and rounding points. q [H, Tq, D], k and v
    [H, Tk, D] -> (o [H, Tq, D] in q's dtype, lse [H, Tq] f32)."""
    h, tq, d = q.shape
    tk = k.shape[1]
    dev, dt = q.device, q.dtype
    c2 = float(scale) * LOG2E
    m = torch.full((h, tq), float("-inf"), device=dev)
    l = torch.zeros((h, tq), device=dev)
    acc = torch.zeros((h, tq, d), device=dev)
    klo, khi = _key_ranges(cu_q, cu_k, tq, causal)
    for c0, c1, qa, qb in _key_tiles(cu_q, cu_k, tk, causal):
        s = (q[:, qa:qb].float() @ k[:, c0:c1].float().transpose(1, 2)) * c2
        s = s.masked_fill(~_live_mask(klo, khi, qa, qb, c0, c1), float("-inf"))
        mo = m[:, qa:qb]
        mn = torch.maximum(mo, s.amax(-1))
        base = torch.where(mn == float("-inf"), torch.zeros_like(mn), mn)
        al = torch.exp2(mo - base)
        p = torch.exp2(s - base[..., None])
        l[:, qa:qb] = l[:, qa:qb] * al + p.sum(-1)
        acc[:, qa:qb] = acc[:, qa:qb] * al[..., None] + \
            p.to(dt).float() @ v[:, c0:c1].float()
        m[:, qa:qb] = mn
    # a row with no live key (l = 0) gets o = 0 and lse = 0
    live = l > 0
    l1 = torch.where(live, l, 1.0)
    o = (acc * torch.where(live, 1.0 / l1, 0.0)[..., None]).to(dt)
    lse = torch.where(live, (m + torch.log2(l1)) * LN2, 0.0)
    return _like(o, q), lse


def _bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale, want_dq,
               want_dkv):
    h, tq, d = q.shape
    tk = k.shape[1]
    dev, dt = q.device, q.dtype
    c2 = float(scale) * LOG2E
    lse2 = lse.float() * LOG2E
    klo, khi = _key_ranges(cu_q, cu_k, tq, causal)
    dq = torch.zeros((h, tq, d), device=dev) if want_dq else None
    dk = torch.zeros((h, tk, d), device=dev) if want_dkv else None
    dv = torch.zeros((h, tk, d), device=dev) if want_dkv else None
    for c0, c1, qa, qb in _key_tiles(cu_q, cu_k, tk, causal):
        qf, dof = q[:, qa:qb].float(), do[:, qa:qb].float()
        kf, vf = k[:, c0:c1].float(), v[:, c0:c1].float()
        s = (qf @ kf.transpose(1, 2)) * c2
        p = torch.where(_live_mask(klo, khi, qa, qb, c0, c1),
                        torch.exp2(s - lse2[:, qa:qb, None]),
                        torch.zeros_like(s))
        dp = dof @ vf.transpose(1, 2)
        ds = (p * (dp - delta[:, qa:qb, None]) * scale).to(dt).float()
        if want_dkv:
            dv[:, c0:c1] = p.to(dt).float().transpose(1, 2) @ dof
            dk[:, c0:c1] = ds.transpose(1, 2) @ qf
        if want_dq:
            dq[:, qa:qb] += ds @ kf
    return tuple(_like(x.to(dt), ref) for x, ref in ((dq, q), (dk, k), (dv, v))
                 if x is not None)


def varlen_bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """Plain PyTorch fused backward with the kernels' rounding points: q,
    do [H, Tq, D]; k, v [H, Tk, D]; lse (natural log) and delta =
    sum(dO * O) [H, Tq] f32 -> (dq, dk, dv) in q's dtype."""
    return _bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
                      True, True)


def varlen_bwd_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                         scale):
    """The split backward's dK/dV: (dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
                      False, True)


def varlen_bwd_dq_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """The split backward's dQ: dq."""
    return _bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale,
                      True, False)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _packed(x):
    """1 if x [H, T, D] is the transposed view of a contiguous [T, H, D],
    0 if it is contiguous itself, None otherwise."""
    if x.is_contiguous():
        return 0
    if x.transpose(0, 1).is_contiguous():
        return 1
    return None


def _like(x, ref):
    """x [H, T, D] in the memory form of ref (contiguous or the view of a
    packed [T, H, D])."""
    if ref.is_contiguous() or not ref.transpose(0, 1).is_contiguous():
        return x.contiguous()
    return x.transpose(0, 1).contiguous().transpose(0, 1)


def _empty_like_form(shape, dtype, packed, device):
    h, t, d = shape
    if packed:
        return torch.empty((t, h, d), dtype=dtype, device=device).transpose(0, 1)
    return torch.empty((h, t, d), dtype=dtype, device=device)


def _check_shapes(name, q, k, v, cu_q, cu_k):
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: want q [H, Tq, D], k and v [H, Tk, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if cu_q.ndim != 1 or cu_k.shape != cu_q.shape or cu_q.shape[0] < 2:
        raise ValueError(f"{name}: cu_q and cu_k must be [n_seq + 1] with "
                         f"n_seq >= 1")


def _check_cuda(name, q, tensors, stats, cus):
    """The kernels' contract for CUDA tensors; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise TypeError(f"{name}: q, k, v (and dO) must share one dtype of "
                        f"{list(_DTYPE_CODE)}")
    if any(s.dtype != torch.float32 for s in stats):
        raise TypeError(f"{name}: lse and delta must be float32")
    if any(c.dtype != torch.int32 for c in cus):
        raise TypeError(f"{name}: cu_q and cu_k must be int32")
    allt = (q,) + tuple(tensors) + tuple(stats) + tuple(cus)
    if any(t.device != q.device for t in allt):
        raise ValueError(f"{name}: all tensors must share q's device")
    packed = _packed(q)
    if packed is None or any(_packed(t) != packed for t in tensors) \
            or any(not t.is_contiguous() for t in tuple(stats) + tuple(cus)):
        raise ValueError(f"{name}: q, k, v (and dO) must all be contiguous "
                         f"[H, T, D] or all views of contiguous [T, H, D]; "
                         f"lse, delta and cu contiguous")
    if any(t.data_ptr() % 16 for t in (q,) + tuple(tensors)):
        raise ValueError(f"{name}: q, k, v must start on 16-byte aligned "
                         f"storage")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not supported by "
                         f"the kernel {_HEAD_DIMS}")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: H = {q.shape[0]} exceeds 65535")
    return packed


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# cu_q, cu_k, n_seq, h, tq, tk, d, packed, causal, scale, dtype, stream
_TAIL = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]


def _tail(q, k, cu_q, cu_k, packed, causal, scale):
    return (cu_q.data_ptr(), cu_k.data_ptr(), cu_q.shape[0] - 1, q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], packed, int(bool(causal)),
            float(scale), _DTYPE_CODE[q.dtype], _stream(q))


def varlen_fwd(q, k, v, cu_q, cu_k, causal, scale):
    """q [H, Tq, D], k and v [H, Tk, D] (all contiguous, or all views of
    packed [T, H, D]); cu_q, cu_k [n_seq + 1] int32 -> (o like q, lse
    [H, Tq] f32, natural log).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`varlen_fwd_plain`. ``varlen_fwd.launches`` counts
    kernel launches."""
    _check_shapes("varlen_fwd", q, k, v, cu_q, cu_k)
    if q.device.type == "cpu":
        return varlen_fwd_plain(q, k, v, cu_q, cu_k, causal, scale)
    packed = _check_cuda("varlen_fwd", q, (k, v), (), (cu_q, cu_k))
    o = _empty_like_form(q.shape, q.dtype, packed, q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    fn = _build.kernel("flash_varlen", "varlen_fwd", [_P] * 5 + _TAIL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *_tail(q, k, cu_q, cu_k, packed, causal, scale))
    _build.check("flash_varlen", err, "varlen_fwd")
    varlen_fwd.launches += 1
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta, cu_q, cu_k):
    _check_shapes(name, q, k, v, cu_q, cu_k)
    if do.shape != q.shape or lse.shape != q.shape[:2] \
            or delta.shape != q.shape[:2]:
        raise ValueError(f"{name}: do must match q, lse and delta [H, Tq]")
    if q.device.type == "cpu":
        return None
    return _check_cuda(name, q, (k, v, do), (lse, delta), (cu_q, cu_k))


def varlen_bwd(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """Fused backward: q, do [H, Tq, D]; k, v [H, Tk, D]; lse (natural log)
    and delta = sum(dO * O) [H, Tq] f32 -> (dq, dk, dv), each like its
    input. dQ is summed across CTAs by f32 atomics into a zeroed f32
    scratch (its summation order varies from run to run). In bf16 the
    kernel is :func:`varlen_bwd_dkv`'s with dQ switched on, so dk and dv
    have the same bits as its on the same inputs, on every run.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`varlen_bwd_plain`. ``varlen_bwd.launches`` counts
    kernel launches."""
    packed = _check_bwd("varlen_bwd", q, k, v, do, lse, delta, cu_q, cu_k)
    if packed is None:
        return varlen_bwd_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                                scale)
    dq_acc = _empty_like_form(q.shape, torch.float32, packed, q.device)
    dq_acc.zero_()
    dq = _empty_like_form(q.shape, q.dtype, packed, q.device)
    dk = _empty_like_form(k.shape, k.dtype, packed, q.device)
    dv = _empty_like_form(k.shape, k.dtype, packed, q.device)
    fn = _build.kernel("flash_varlen", "varlen_bwd", [_P] * 10 + _TAIL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_tail(q, k, cu_q, cu_k, packed, causal, scale))
    _build.check("flash_varlen", err, "varlen_bwd")
    varlen_bwd.launches += 1
    return dq, dk, dv


def varlen_bwd_dkv(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """The split backward's dK/dV (same arguments as :func:`varlen_bwd`)
    -> (dk, dv). CPU tensors: :func:`varlen_bwd_dkv_plain`.
    ``varlen_bwd_dkv.launches`` counts kernel launches."""
    packed = _check_bwd("varlen_bwd_dkv", q, k, v, do, lse, delta, cu_q,
                        cu_k)
    if packed is None:
        return varlen_bwd_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k,
                                    causal, scale)
    dk = _empty_like_form(k.shape, k.dtype, packed, q.device)
    dv = _empty_like_form(k.shape, k.dtype, packed, q.device)
    fn = _build.kernel("flash_varlen", "varlen_bwd_dkv", [_P] * 8 + _TAIL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_tail(q, k, cu_q, cu_k, packed, causal, scale))
    _build.check("flash_varlen", err, "varlen_bwd_dkv")
    varlen_bwd_dkv.launches += 1
    return dk, dv


def varlen_bwd_dq(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """The split backward's dQ (same arguments as :func:`varlen_bwd`) -> dq,
    with no atomics: the same bits every run. CPU tensors:
    :func:`varlen_bwd_dq_plain`. ``varlen_bwd_dq.launches`` counts kernel
    launches."""
    packed = _check_bwd("varlen_bwd_dq", q, k, v, do, lse, delta, cu_q,
                        cu_k)
    if packed is None:
        return varlen_bwd_dq_plain(q, k, v, do, lse, delta, cu_q, cu_k,
                                   causal, scale)
    dq = _empty_like_form(q.shape, q.dtype, packed, q.device)
    fn = _build.kernel("flash_varlen", "varlen_bwd_dq", [_P] * 7 + _TAIL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_tail(q, k, cu_q, cu_k, packed, causal, scale))
    _build.check("flash_varlen", err, "varlen_bwd_dq")
    varlen_bwd_dq.launches += 1
    return dq


varlen_fwd.launches = 0
varlen_bwd.launches = 0
varlen_bwd_dkv.launches = 0
varlen_bwd_dq.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class _FlashVarlen(torch.autograd.Function):
    """Packed [T, H, D] attention; the kernels read the tensors in place
    through [H, T, D] views. Saves (q, k, v, o, lse) as the JAX custom vjp
    does; the backward is the fused kernel or the split pair, as chosen
    from shapes."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, scale, fused):
        q, k, v = (x.contiguous() for x in (q, k, v))
        o, lse = varlen_fwd(q.transpose(0, 1), k.transpose(0, 1),
                            v.transpose(0, 1), cu_q, cu_k, causal, scale)
        o = o.transpose(0, 1)
        ctx.save_for_backward(q, k, v, o, lse, cu_q, cu_k)
        ctx.causal, ctx.scale, ctx.fused = causal, scale, fused
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cu_q, cu_k = ctx.saved_tensors
        do = do.contiguous()
        # delta = sum(dO * O) in f32, outside the kernel (as JAX does)
        delta = (do.float() * o.float()).sum(-1).transpose(0, 1).contiguous()
        args = (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                do.transpose(0, 1), lse, delta, cu_q, cu_k, ctx.causal,
                ctx.scale)
        if ctx.fused:
            dq, dk, dv = varlen_bwd(*args)
        else:
            dk, dv = varlen_bwd_dkv(*args)
            dq = varlen_bwd_dq(*args)
        return (dq.transpose(0, 1), dk.transpose(0, 1), dv.transpose(0, 1),
                None, None, None, None, None)


def flash_varlen_attention(q, k, v, cu_seqlens_q, cu_seqlens_k, scale,
                           causal, self_attn=None,
                           block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                           max_seqlen=None):
    """Kernel-backed packed varlen attention.

    q: [total_q, H, D]; k, v: [total_k, Hkv, D] (GQA repeats kv heads);
    cu_seqlens_*: [B+1] int32 cumulative offsets. Returns [total_q, H, D].
    Differentiable. ``self_attn`` defaults to ``cu_seqlens_q is
    cu_seqlens_k``; it and the blocks only choose the path as JAX does
    (:func:`plan_path`: fused or split backward), since the kernels find
    their own live tiles from cu.

    ``max_seqlen`` (self-attention) is checked against the longest segment
    when cu lies on the CPU and raises ValueError if smaller, as JAX checks
    a concrete cu. On the card the check is skipped rather than sync: the
    kernels do not use max_seqlen to bound their work, so a wrong value
    cannot change the output. Cross-attention ignores it."""
    if self_attn is None:
        self_attn = cu_seqlens_q is cu_seqlens_k
    tq, h, d = q.shape
    tk, hkv = k.shape[0], k.shape[1]
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if max_seqlen and self_attn and cu_seqlens_q.device.type == "cpu":
        longest = int((cu_seqlens_q[1:] - cu_seqlens_q[:-1]).max())
        if longest > int(max_seqlen):
            raise ValueError(
                f"flash_varlen_attention: max_seqlen={int(max_seqlen)} "
                f"is smaller than the longest packed segment "
                f"({longest}); the static live-tile bound would skip "
                f"live tiles and produce wrong attention output")
    cu_q = cu_seqlens_q.to(device=q.device, dtype=torch.int32).contiguous()
    cu_k = cu_q if self_attn else \
        cu_seqlens_k.to(device=q.device, dtype=torch.int32).contiguous()
    _, fused = plan_path(tq, tk, cu_q.shape[0] - 1, h, d, q.dtype,
                         bool(self_attn), block_q, block_k)
    return _FlashVarlen.apply(q, k, v, cu_q, cu_k, bool(causal),
                              float(scale), fused)
