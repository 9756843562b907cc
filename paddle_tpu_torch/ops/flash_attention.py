"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` and their
plain PyTorch versions (port of ``paddle_tpu/ops/flash_attention.py``).

  flash_fwd      ports ``_flash_fwd`` (its online kernel ``_fwd_kernel``)
  flash_bwd      ports ``_bwd_fused_flat_call`` (``_bwd_fused_flat_kernel``)
  flash_bwd_dkv  ports ``_bwd_pallas_calls``'s ``_bwd_dkv_kernel``
  flash_bwd_dq   ports ``_bwd_pallas_calls``'s ``_bwd_dq_kernel``

Dispatch, JAX path by JAX path. The TPU's choices come from its 16 MiB of
scoped VMEM: the forward streams K/V through a third grid dimension once
2 Sk D itemsize > ``STREAM_KV_BYTES`` (S > 6144 at D = 128 in bf16), and
the fused backward gives up when its [S, D] f32 dQ scratch passes the
52 MiB budget (about S >= 100k at D = 128). Hopper has no such ceiling:
the forward kernel streams 64-key K/V tiles through shared memory at any
length, and the fused backward keeps dQ's f32 scratch in device memory.
So the port has two kernels where JAX has three paths each:

  JAX forward ``resident`` (``_fwd_kernel``)           -> flash_fwd
  JAX forward ``stream`` (``_fwd_kernel_stream``)      -> flash_fwd
  JAX backward ``fused_flat`` (auto)                   -> flash_bwd
  JAX backward ``fused_stream`` (auto past the budget,
      or split past streaming)                         -> flash_bwd (auto)
                                                          flash_bwd_dkv +
                                                          flash_bwd_dq (split)
  JAX backward ``split_resident`` (split)              -> flash_bwd_dkv +
                                                          flash_bwd_dq

:func:`dense_bwd_mode` reads ``PADDLE_TPU_TORCH_FLASH_BWD`` on every call
(``auto``, the default, or ``split``), as JAX reads
``PADDLE_TPU_FLASH_BWD``: ``auto`` launches flash_bwd at every length,
``split`` the dK/dV pass then the dQ pass at every length.
:func:`dense_bwd_schedule_stats` names the path JAX would take for a
shape (a host-only call), so a timing can say which TPU site it stands
for.

Layouts are the JAX package's: q, k, v, o [BH, S, D]; lse [BH, S] f32 in
the natural log. The kernels take q PRE-SCALED by scale * log2(e) (scores
in the log2 domain, exp2 in the softmax). The softmax is the online
recurrence only; the JAX package's default tile-0-anchored "fixed-base"
variant is not ported (it overflows once a later tile's row max exceeds
tile 0's by about 100 log2 units).

On the card, bf16's fused backward and its dK/dV pass (rows 16, 17) run
on Hopper's warpgroup products (wgmma, 128 keys a CTA) and sum dQ across
CTAs with bulk reduce-adds into a zeroed f32 scratch; f32 and the other
kernels take warp-level mma.sync (csrc/flash_attention.cu).

Rounding points, shared by kernels and plain versions: scores and every
product accumulate in f32; the forward rounds P to the input dtype before
P.V while the normaliser sums the unrounded P; the backward rounds P for
dV += P^T dO and dS = P (dP - delta) for dK and dQ. Causal masks
key > query position (top-left, as JAX's kernels do).

:func:`flash_attention_bshd` is the differentiable entry ([B, S, H, D],
GQA by repeating kv heads), a ``torch.autograd.Function`` whose backward
goes through :func:`_bwd_calls`. :func:`flash_block_fwd` and
:func:`flash_block_bwd` are the block entries that context parallelism
composes: raw q, the partial (o, lse) of one KV block, and the backward
of one block under the caller's GLOBAL lse and delta.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_MASK = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# the forward kernel's K/V tile: the plain version walks the same tiles so
# that P is rounded against the same running max
BLOCK_K = 64


# ---------------------------------------------------------------------------
# plain versions (any device; the kernels' references)
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, causal=False, kv_len=None):
    """Plain PyTorch forward over ``BLOCK_K``-key tiles with the kernel's
    online softmax and rounding points, in memory linear in S. q
    pre-scaled. Returns (o, lse)."""
    bh, sq, d = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    dev = q.device
    qf = q.float()
    m = torch.full((bh, sq), float("-inf"), device=dev)
    l = torch.zeros((bh, sq), device=dev)
    acc = torch.zeros((bh, sq, d), device=dev)
    for c0 in range(0, kv_len, BLOCK_K):
        c1 = min(c0 + BLOCK_K, kv_len)
        # under causal, rows above c0 see none of these keys: their update
        # would be alpha = 1, p = 0, so they are left as they are
        r0 = min(c0, sq) if causal else 0
        s = qf[:, r0:] @ k[:, c0:c1].float().transpose(1, 2)
        if causal:
            cols = torch.arange(c0, c1, device=dev)[None, :]
            rows = torch.arange(r0, sq, device=dev)[:, None]
            s = s.masked_fill(cols > rows, _MASK)
        m_new = torch.maximum(m[:, r0:], s.amax(dim=-1))
        alpha = torch.exp2(m[:, r0:] - m_new)
        p = torch.exp2(s - m_new[..., None])
        l[:, r0:] = l[:, r0:] * alpha + p.sum(dim=-1)
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + \
            p.to(q.dtype).float() @ v[:, c0:c1].float()
        m[:, r0:] = m_new
    lf = torch.clamp(l, min=1e-30)
    return (acc / lf[..., None]).to(q.dtype), (m + torch.log2(lf)) * LN2


# elements of one [heads, q rows, keys] f32 tile of the plain backward
_PLAIN_TILE = 1 << 26


def _bwd_walk(q, k, v, do, lse, delta, causal, scale, want_dq=True,
              want_dkv=True):
    """The plain backward's one walk, with the kernels' rounding points:
    a group of heads and a chunk of query rows at a time (the score tile
    stays under ``_PLAIN_TILE`` elements, so any S runs in bounded
    memory; under causal a chunk sees only the keys below its last row).
    dK and dV accumulate in f32 across chunks and round once at the end;
    each chunk's dQ is whole and rounds at once. Returns (dq or None, dk
    or None, dv or None)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dt, dev = q.dtype, q.device
    dq = torch.empty_like(q) if want_dq else None
    if want_dkv:
        dk_acc = torch.zeros((bh, sk, d), dtype=torch.float32, device=dev)
        dv_acc = torch.zeros_like(dk_acc)
    lse2 = lse.float() * LOG2E
    heads = max(1, min(bh, _PLAIN_TILE // max(1, sq * sk)))
    rows = max(1, min(sq, _PLAIN_TILE // max(1, heads * sk)))
    for h0 in range(0, bh, heads):
        hs = slice(h0, h0 + heads)
        kf, vf = k[hs].float(), v[hs].float()
        for r0 in range(0, sq, rows):
            r1 = min(r0 + rows, sq)
            kn = min(r1, sk) if causal else sk
            qf, dof = q[hs, r0:r1].float(), do[hs, r0:r1].float()
            s = qf @ kf[:, :kn].transpose(1, 2)
            if causal:
                dead = (torch.arange(kn, device=dev)[None, :]
                        > torch.arange(r0, r1, device=dev)[:, None])
                s = s.masked_fill(dead, _MASK)
            p = torch.exp2(s - lse2[hs, r0:r1, None])
            dp = dof @ vf[:, :kn].transpose(1, 2)
            ds = (p * (dp - delta[hs, r0:r1, None])).to(dt).float()
            if want_dkv:
                dv_acc[hs, :kn] += p.to(dt).float().transpose(1, 2) @ dof
                dk_acc[hs, :kn] += ds.transpose(1, 2) @ qf
            if want_dq:
                dq[hs, r0:r1] = ((ds @ kf[:, :kn]) * scale).to(dt)
    if not want_dkv:
        return dq, None, None
    return dq, (dk_acc * LN2).to(dt), dv_acc.to(dt)


def flash_bwd_plain(q, k, v, do, lse, delta, causal, scale):
    """Plain PyTorch fused backward (:func:`_bwd_walk`). q pre-scaled, lse
    natural log, delta = sum(dO * O). Returns (dq, dk, dv) in q's dtype,
    dq with respect to the unscaled q."""
    return _bwd_walk(q, k, v, do, lse, delta, causal, scale)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale):
    """Plain dK/dV pass of the split backward: (dk, dv), the same walk
    and bits as :func:`flash_bwd_plain`'s."""
    return _bwd_walk(q, k, v, do, lse, delta, causal, scale,
                     want_dq=False)[1:]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale):
    """Plain dQ pass of the split backward: dq, the same walk and bits as
    :func:`flash_bwd_plain`'s."""
    return _bwd_walk(q, k, v, do, lse, delta, causal, scale,
                     want_dkv=False)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, q, tensors, stats):
    """The kernels' contract for CUDA tensors; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise TypeError(f"{name}: q, k, v (and dO) must share one dtype of "
                        f"{list(_DTYPE_CODE)}")
    if any(s.dtype != torch.float32 for s in stats):
        raise TypeError(f"{name}: lse and delta must be float32")
    allt = (q,) + tuple(tensors) + tuple(stats)
    if any(t.device != q.device for t in allt):
        raise ValueError(f"{name}: all tensors must share q's device")
    if any(not t.is_contiguous() for t in allt):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q,) + tuple(tensors)):
        raise ValueError(f"{name}: q, k, v must start on 16-byte aligned "
                         f"storage")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not supported by "
                         f"the kernel {_HEAD_DIMS}")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: BH = {q.shape[0]} exceeds 65535")


def _check_shapes(name, q, k, v):
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: want q [BH, Sq, D], k and v [BH, Sk, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[1] < 1:
        raise ValueError(f"{name}: no keys")


def flash_fwd(q, k, v, causal=False, kv_len=None):
    """q pre-scaled [BH, Sq, D], k and v [BH, Sk, D] of which the first
    ``kv_len`` keys (default all) are live -> (o [BH, Sq, D] in q's dtype,
    lse [BH, Sq] f32, natural log). Causal masks key > query position.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`flash_fwd_plain`. ``flash_fwd.launches`` counts kernel
    launches."""
    _check_shapes("flash_fwd", q, k, v)
    sk = k.shape[1]
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"flash_fwd: kv_len {kv_len} outside [1, {sk}]")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, kv_len)
    _check_cuda("flash_fwd", q, (k, v), ())
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("flash_attention", "flash_fwd",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, sq, sk, kv_len, d, int(bool(causal)),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta):
    _check_shapes(name, q, k, v)
    bh, sq, _ = q.shape
    if do.shape != q.shape or lse.shape != (bh, sq) \
            or delta.shape != (bh, sq):
        raise ValueError(f"{name}: do must match q, lse and delta "
                         f"[BH, Sq]")


def flash_bwd(q, k, v, do, lse, delta, causal, scale):
    """q pre-scaled, do [BH, Sq, D]; k, v [BH, Sk, D]; lse (natural log)
    and delta = sum(dO * O) [BH, Sq] f32 -> (dq, dk, dv) in q's dtype,
    dq with respect to the UNSCALED q (``scale`` is the softmax scale).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`flash_bwd_plain`. ``flash_bwd.launches`` counts kernel
    launches."""
    _check_bwd("flash_bwd", q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd", q, (k, v, do), (lse, delta))
    # 64-row q tiles: the bf16 kernel adds whole tiles
    dq_acc = torch.zeros((bh, -(-sq // 64) * 64, d), dtype=torch.float32,
                         device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    fn = _build.kernel("flash_attention", "flash_bwd",
                       [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
             k.shape[1], d, int(bool(causal)), float(scale),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """The split backward's dK/dV pass: :func:`flash_bwd`'s arguments ->
    (dk, dv) in q's dtype, bitwise :func:`flash_bwd`'s on the card (its
    kernel with the dQ product compiled out). ``scale`` is unused (dK
    needs none: q is pre-scaled); it is taken so both passes share one
    signature.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`flash_bwd_dkv_plain`. ``flash_bwd_dkv.launches``
    counts kernel launches."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd_dkv", q, (k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.kernel("flash_attention", "flash_bwd_dkv",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             bh, sq, k.shape[1], d, int(bool(causal)), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """The split backward's dQ pass: :func:`flash_bwd`'s arguments -> dq
    in q's dtype, with respect to the unscaled q; the same bits on every
    run (no atomics).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`flash_bwd_dq_plain`. ``flash_bwd_dq.launches`` counts
    kernel launches."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd_dq", q, (k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    fn = _build.kernel("flash_attention", "flash_bwd_dq",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq,
             k.shape[1], d, int(bool(causal)), float(scale),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


# ---------------------------------------------------------------------------
# backward dispatch
# ---------------------------------------------------------------------------

ENV_FLASH_BWD = "PADDLE_TPU_TORCH_FLASH_BWD"
_BWD_MODES = ("auto", "split")


def dense_bwd_mode() -> str:
    """'auto' (the fused kernel, the default) or 'split' (the dK/dV pass,
    then the dQ pass), read from ``PADDLE_TPU_TORCH_FLASH_BWD`` on every
    call; any other value raises a ValueError naming the variable."""
    raw = os.environ.get(ENV_FLASH_BWD)
    mode = (raw if raw is not None else "auto").strip().lower()
    if mode not in _BWD_MODES:
        raise ValueError(f"{ENV_FLASH_BWD} must be 'auto' or 'split', got "
                         f"{mode!r}")
    return mode


def _bwd_calls(qs, k, v, do, lse, delta, causal, scale):
    """The backward under :func:`dense_bwd_mode`, counterpart of JAX's
    ``_bwd_pallas_calls``: q pre-scaled, lse and delta [BH, Sq] f32 ->
    (dq, dk, dv). ``auto`` launches :func:`flash_bwd` and ``split``
    :func:`flash_bwd_dkv` then :func:`flash_bwd_dq`, at every length
    (module docstring: each JAX path's kernel)."""
    if dense_bwd_mode() == "split":
        dk, dv = flash_bwd_dkv(qs, k, v, do, lse, delta, causal, scale)
        return flash_bwd_dq(qs, k, v, do, lse, delta, causal, scale), dk, dv
    return flash_bwd(qs, k, v, do, lse, delta, causal, scale)


# JAX's path choice, copied with its names: what decides which TPU kernel
# a shape runs (see dense_bwd_schedule_stats)
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
STREAM_KV_BYTES = 3 * 2 ** 20
_FLAT_BWD_VMEM_BUDGET = 52 * 1024 * 1024


def _small_d_blocks(d, block_q, block_k):
    if d <= 64:
        return min(block_q, 512), min(block_k, 512)
    return block_q, block_k


def _fit_block(block, n):
    return min(block, -(-n // 128) * 128)


def _bwd_flat_vmem_bytes(bq, bk, sp, d, itemsize):
    scratch = 4 * (sp * d + 2 * bk * d)
    blocks = (2 * bq * d * itemsize + 2 * bk * d * itemsize + 2 * bq * 4
              + bq * d * itemsize + 2 * bk * d * itemsize)
    temps = 4 * bq * bk * 4
    return scratch + 2 * blocks + temps


def _shrink_block(b, n):
    b -= 128
    while b > 128 and n % b:
        b -= 128
    return max(b, 128)


def _fit_bwd_flat_blocks(block_q, block_k, sp, skp, d, itemsize):
    bq, bk = block_q, block_k
    while _bwd_flat_vmem_bytes(bq, bk, sp, d, itemsize) \
            > _FLAT_BWD_VMEM_BUDGET:
        if bq <= 128 and bk <= 128:
            return None
        if bq >= bk and bq > 128:
            bq = _shrink_block(bq, sp)
        else:
            bk = _shrink_block(bk, skp)
    return bq, bk


def dense_bwd_schedule_stats(bh, sq, sk, d, dtype, causal,
                             block_q=DEFAULT_BLOCK_Q,
                             block_k=DEFAULT_BLOCK_K):
    """The TPU path JAX's ``dense_bwd_schedule_stats`` reports for this
    shape (same keys and values, under :func:`dense_bwd_mode` for JAX's
    ``PADDLE_TPU_FLASH_BWD``), plus ``fwd_path``: ``stream`` where JAX's
    ``_flash_fwd`` streams K/V (row 13's kernel), else ``resident``. A
    host-only call; the port's own kernels are the module docstring's."""
    item = dtype.itemsize
    block_q, block_k = _small_d_blocks(d, block_q, block_k)
    block_q = _fit_block(block_q, sq)
    block_k = _fit_block(block_k, sk)
    sp = -(-sq // block_q) * block_q
    skp = -(-sk // block_k) * block_k
    stats = {"mode": dense_bwd_mode(), "bh": bh, "seq_q": sq, "seq_k": sk,
             "head_dim": d}
    fit = (_fit_bwd_flat_blocks(block_q, block_k, sp, skp, d, item)
           if stats["mode"] == "auto" else None)
    if fit is not None:
        bq, bk = fit
        n_q, n_k = sp // bq, skp // bk
        # JAX's _dense_bwd_lo: k tile j's first live q tile under causal
        dead = sum(min(j * bk // bq, n_q - 1) for j in range(n_k)) \
            if causal else 0
        stats.update(path="fused_flat", block_q=bq, block_k=bk,
                     n_flat=n_q * n_k - dead, dead_pairs=dead,
                     fetches_per_block_pair=1, matmuls_per_pair=5,
                     dq_scratch_bytes=4 * sp * d)
    elif (2 * sp * d * item > STREAM_KV_BYTES
          or 2 * skp * d * item > STREAM_KV_BYTES):
        stats.update(path="fused_stream", block_q=block_q, block_k=block_k,
                     fetches_per_block_pair=1, matmuls_per_pair=5)
    else:
        stats.update(path="split_resident", block_q=block_q,
                     block_k=block_k, fetches_per_block_pair=2,
                     matmuls_per_pair=7)
    stats["fwd_path"] = ("stream" if 2 * skp * d * item > STREAM_KV_BYTES
                         else "resident")
    return stats


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """[BH, S, D] attention; saves (q~, k, v, o, lse) as the JAX custom
    vjp does, so the backward reuses the pre-scaled q."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qs = _prescale(q, scale)
        o, lse = flash_fwd(qs, k, v, causal)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = _bwd_calls(qs, k, v, do, lse, delta, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q [B, S, H, D]; k, v [B, Sk, Hkv, D] (GQA repeats kv heads) ->
    [B, S, H, D]. Differentiable; scale defaults to 1/sqrt(D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)

    def to_bh(x, n):
        return x.transpose(1, 2).reshape(b * h, n, d).contiguous()

    o = _FlashAttention.apply(to_bh(q, s), to_bh(k, sk), to_bh(v, sk),
                              bool(causal), scale)
    return o.reshape(b, h, s, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# block entries (context parallelism composes them)
# ---------------------------------------------------------------------------

def _prescale(q, scale):
    return (q.float() * (float(scale) * LOG2E)).to(q.dtype)


def flash_block_fwd(q, k, v, causal, scale):
    """One KV block's flash forward with the partials exposed: q RAW
    [BH, Sq, D] (pre-scaled here), k, v [BH, Sk, D] -> (o [BH, Sq, D],
    lse [BH, Sq] f32, natural log), so a caller can merge blocks by
    log-sum-exp. Port of JAX's ``flash_block_fwd``."""
    return flash_fwd(_prescale(q, scale), k, v, causal)


def flash_block_bwd(q, k, v, do, lse, delta, causal, scale):
    """One KV block's backward under the caller's GLOBAL statistics: q
    RAW and do [BH, Sq, D], k, v [BH, Sk, D], lse and delta [BH, Sq] f32
    of the whole (all-block) attention -> (dq, dk, dv) of this block,
    which the caller sums over blocks. P is never renormalised per block
    (its rows sum to the block's share of 1). Through the same dispatch as
    the differentiable entry (:func:`_bwd_calls`). Sq and Sk must be
    128-aligned, as JAX requires. Port of JAX's ``flash_block_bwd``."""
    s, sk = q.shape[1], k.shape[1]
    if s % 128 or sk % 128:
        raise ValueError(f"flash_block_bwd needs 128-aligned lengths, got "
                         f"q={s}, k={sk}")
    return _bwd_calls(_prescale(q, scale), k, v, do, lse, delta, causal,
                      float(scale))
