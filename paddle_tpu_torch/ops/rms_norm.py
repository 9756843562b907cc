"""RMSNorm: the CUDA kernel ``csrc/rms_norm.cu`` and its plain PyTorch
version (port of ``paddle_tpu/ops/rms_norm.py``).

Numerics follow the TPU kernel ``_rms_kernel``: f32 mean of squares,
``rsqrt(ms + eps)``, ``x * inv * w`` in f32, cast to x's dtype. The
gradient is the closed form of the JAX ``_rms_bwd`` in plain PyTorch (the
JAX backward is plain jnp, not a Pallas kernel): dx in f32 cast to x's
dtype, dw summed over rows in f32.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# 16-byte vectors a row that the kernel holds in registers: 8 a thread over
# at most 512 threads (kMaxThreads in csrc/rms_norm.cu), so bf16 rows of up
# to 32,768 elements and f32 rows of up to 16,384
MAX_VECTORS = 4096


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch RMSNorm on any device; the kernel's reference."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + epsilon)
    return (x32 * inv * weight.float()).to(x.dtype)


def _launch(x2d: torch.Tensor, weight: torch.Tensor, eps: float
            ) -> torch.Tensor:
    n, h = x2d.shape
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rms_norm: dtype {x2d.dtype} not supported "
                        f"(float32, bfloat16)")
    if weight.dtype != x2d.dtype or weight.shape != (h,):
        raise ValueError(f"fused_rms_norm: weight {tuple(weight.shape)} "
                         f"{weight.dtype} does not match x [.., {h}] "
                         f"{x2d.dtype}")
    if weight.device != x2d.device or not weight.is_contiguous():
        raise ValueError("fused_rms_norm: weight must be a contiguous "
                         "tensor on x's device")
    if (h * x2d.element_size()) % 16 or x2d.data_ptr() % 16 \
            or weight.data_ptr() % 16:
        raise ValueError("fused_rms_norm: rows must be whole 16-byte "
                         "vectors on 16-byte aligned storage")
    if h * x2d.element_size() > 16 * MAX_VECTORS:
        raise ValueError(f"fused_rms_norm: H = {h} is over the kernel's "
                         f"{MAX_VECTORS} 16-byte vectors a row")
    out = torch.empty_like(x2d)
    fn = _build.kernel("rms_norm", "rms_norm_fwd",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(x2d.data_ptr(), weight.data_ptr(), out.data_ptr(), n, h,
             float(eps), _DTYPE_CODE[x2d.dtype],
             torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check("rms_norm", err, "fused_rms_norm")
    fused_rms_norm.launches += 1
    return out


def rms_norm_bwd(x2d: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                 epsilon: float):
    """Closed-form gradient of RMSNorm for x [N, H], weight [H] and the
    output's gradient g [N, H] -> (dx, dw), as the JAX ``_rms_bwd``."""
    x = x2d.float()
    g32 = g.float()
    inv = torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + epsilon)
    xhat = x * inv
    gw = g32 * weight.float()
    # d/dx [x * inv]: inv * (gw - xhat * mean(gw * xhat))
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (g32 * xhat).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(weight.dtype)


def _forward(x2d, weight, eps):
    if x2d.device.type == "cpu":
        return rms_norm_plain(x2d, weight, eps)
    return _launch(x2d, weight, eps)


class _RmsNorm(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain version (CPU);
    backward by :func:`rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x2d, weight, eps):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        return _forward(x2d, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x2d, weight, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """x [..., H], weight [H] -> same shape and dtype as x; differentiable
    in both.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`rms_norm_plain`. ``fused_rms_norm.launches`` counts
    kernel launches. Without a gradient to track (the serving steps) the
    call skips the autograd Function, which costs 9-16 us of host time per
    call on an H100 machine (``rms_host_cost`` in chip_smoke.py)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("fused_rms_norm: x must be contiguous")
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x2d, weight, float(epsilon)).reshape(shape)
    return _forward(x2d, weight, float(epsilon)).reshape(shape)


fused_rms_norm.launches = 0
