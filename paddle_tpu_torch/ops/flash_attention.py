"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` and their
plain PyTorch versions (port of ``paddle_tpu/ops/flash_attention.py``).

  flash_fwd  ports ``_flash_fwd`` (its online kernel ``_fwd_kernel``)
  flash_bwd  ports ``_bwd_fused_flat_call`` (``_bwd_fused_flat_kernel``)

Layouts are the JAX package's: q, k, v, o [BH, S, D]; lse [BH, S] f32 in
the natural log. The kernels take q PRE-SCALED by scale * log2(e) (scores
in the log2 domain, exp2 in the softmax). The softmax is the online
recurrence only; the JAX package's default tile-0-anchored "fixed-base"
variant is not ported (it overflows once a later tile's row max exceeds
tile 0's by about 100 log2 units).

Rounding points, shared by kernel and plain version: scores and every
product accumulate in f32; the forward rounds P to the input dtype before
P.V while the normaliser sums the unrounded P; the backward rounds P for
dV += P^T dO and dS = P (dP - delta) for dK and dQ.

:func:`flash_attention_bshd` is the differentiable entry ([B, S, H, D],
GQA by repeating kv heads), a ``torch.autograd.Function`` whose backward
is :func:`flash_bwd`.
"""
from __future__ import annotations

import ctypes

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
    online softmax and rounding points. q pre-scaled. Returns (o, lse)."""
    bh, sq, d = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    dev = q.device
    qf = q.float()
    m = torch.full((bh, sq), float("-inf"), device=dev)
    l = torch.zeros((bh, sq), device=dev)
    acc = torch.zeros((bh, sq, d), device=dev)
    rows = torch.arange(sq, device=dev)[:, None]
    for c0 in range(0, kv_len, BLOCK_K):
        c1 = min(c0 + BLOCK_K, kv_len)
        s = qf @ k[:, c0:c1].float().transpose(1, 2)
        if causal:
            cols = torch.arange(c0, c1, device=dev)[None, :]
            s = s.masked_fill(cols > rows, _MASK)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ \
            v[:, c0:c1].float()
        m = m_new
    lf = torch.clamp(l, min=1e-30)
    return (acc / lf[..., None]).to(q.dtype), (m + torch.log2(lf)) * LN2


def flash_bwd_plain(q, k, v, do, lse, delta, causal, scale):
    """Plain PyTorch fused backward with the kernel's rounding points, a
    few heads at a time so the [S, S] f32 tiles stay bounded. q
    pre-scaled, lse natural log, delta = sum(dO * O). Returns (dq, dk,
    dv) in q's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dt = q.dtype
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    lse2 = lse.float() * LOG2E
    dead = (torch.arange(sk, device=q.device)[None, :]
            > torch.arange(sq, device=q.device)[:, None]) if causal else None
    step = max(1, (1 << 26) // max(1, sq * sk))
    for b0 in range(0, bh, step):
        sl = slice(b0, b0 + step)
        qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, do))
        s = qf @ kf.transpose(1, 2)
        if causal:
            s = s.masked_fill(dead, _MASK)
        p = torch.exp2(s - lse2[sl, :, None])
        dv[sl] = (p.to(dt).float().transpose(1, 2) @ dof).to(dt)
        dp = dof @ vf.transpose(1, 2)
        ds = (p * (dp - delta[sl, :, None])).to(dt).float()
        dk[sl] = ((ds.transpose(1, 2) @ qf) * LN2).to(dt)
        dq[sl] = ((ds @ kf) * scale).to(dt)
    return dq, dk, dv


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


def flash_bwd(q, k, v, do, lse, delta, causal, scale):
    """q pre-scaled, do [BH, Sq, D]; k, v [BH, Sk, D]; lse (natural log)
    and delta = sum(dO * O) [BH, Sq] f32 -> (dq, dk, dv) in q's dtype,
    dq with respect to the UNSCALED q (``scale`` is the softmax scale).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`flash_bwd_plain`. ``flash_bwd.launches`` counts kernel
    launches."""
    _check_shapes("flash_bwd", q, k, v)
    bh, sq, d = q.shape
    if do.shape != q.shape or lse.shape != (bh, sq) \
            or delta.shape != (bh, sq):
        raise ValueError("flash_bwd: do must match q, lse and delta "
                         "[BH, Sq]")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd", q, (k, v, do), (lse, delta))
    dq_acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
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


flash_fwd.launches = 0
flash_bwd.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """[BH, S, D] attention; saves (q~, k, v, o, lse) as the JAX custom
    vjp does, so the backward reuses the pre-scaled q."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qs = (q.float() * (scale * LOG2E)).to(q.dtype)
        o, lse = flash_fwd(qs, k, v, causal)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_bwd(qs, k, v, do, lse, delta, ctx.causal,
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
