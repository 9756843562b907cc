"""Grouped matmul for the dropless MoE expert FFN: the CUDA kernels
``csrc/grouped_matmul.cu`` and their plain PyTorch versions (port of
``paddle_tpu/ops/grouped_matmul.py``).

  gmm_fwd  ports ``_gmm_fwd_call`` (kernel ``_gmm_kernel``)
  gmm_dx   ports ``_gmm_dx_call``  (kernel ``_gmm_dx_kernel``)
  gmm_dw   ports ``_gmm_dw_call``  (kernel ``_gmm_dw_kernel``)

The token buffer ``lhs`` [M, K] is expert-sorted with every expert's group
starting on a ``tile_rows`` boundary, so each row tile belongs to one
expert. :func:`tile_schedule` turns per-expert row counts into the flat
per-tile schedule on the device (no host sync), :func:`chunk_schedule`
that of one chunk of the ragged all-to-all; the kernels read its
``(tile_expert, live)`` from device memory. Dead tiles (past the
last group) come back zero from the forward and dX; dW of an expert with
no tile is exactly zero. Every product accumulates in f32; the forward
writes ``promote(lhs, rhs)``, dX dout's dtype, dW lhs's dtype (rounded
once from the f32 sum, as the JAX backward casts its f32 dW); autograd
casts each gradient to its input's dtype.

On the card the kernels take ``tile_rows`` = 128 only, bf16 or f32
operands of one dtype, K a multiple of 128 and N a multiple of 64; bf16
runs on Hopper's warpgroup products fed by TMA (csrc/grouped_matmul.cu),
f32 on scalar FMAs. The plain versions take any tile size (the CPU tests
use 8 and 128), any shapes and dtypes. :func:`grouped_matmul` is
the differentiable entry.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE_ROWS = 128    # also the only row tile the kernels take
# the multiples K and N must be of on the card (csrc/grouped_matmul.cu)
K_MULTIPLE = 128
N_MULTIPLE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(n, m):
    return -(-n // m) * m


def tile_schedule(counts: torch.Tensor, n_tiles: int,
                  tile_rows: int = TILE_ROWS):
    """Per-tile flat schedule from per-expert row counts [E] (int32, on
    any device; nothing is read back to the host).

    Returns int32 tensors ``(tile_expert, live, first, last)`` of length
    ``n_tiles`` and ``offsets`` [E+1] (tile-aligned group starts). Tiles
    past the last live row clamp their expert id to E-1 and carry live=0,
    as the JAX ``tile_schedule``. The kernels and the plain versions read
    only the first two."""
    E = counts.shape[0]
    dev = counts.device
    aligned = _round_up(counts.to(torch.int32), tile_rows)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(aligned, 0).to(torch.int32)])
    row0 = torch.arange(n_tiles, dtype=torch.int32, device=dev) * tile_rows
    expert = (torch.searchsorted(offsets, row0, right=True).to(torch.int32)
              - 1).clamp(0, E - 1)
    e = expert.long()
    live = row0 < offsets[E]
    first = (row0 == offsets[e]) & live
    last = (row0 + tile_rows == offsets[e + 1]) & live
    i32 = torch.int32
    return expert, live.to(i32), first.to(i32), last.to(i32), offsets


def chunk_schedule(counts: torch.Tensor, chunk_rows: int,
                   tile_rows: int = TILE_ROWS):
    """The tile schedule of ONE chunk of the ragged all-to-all dispatch:
    ``counts`` [E_local] are the group sizes one source rank packed into
    its ``chunk_rows``-row chunk, tile-aligned as :func:`tile_schedule`
    lays them. Returns ``(tile_expert, live, first, last)`` over
    ``chunk_rows // tile_rows`` tiles; the tiles past the chunk's groups
    are dead (live 0). The kernels read the first two."""
    if chunk_rows % tile_rows:
        raise ValueError(f"chunk_schedule: chunk_rows {chunk_rows} is not a "
                         f"multiple of tile_rows {tile_rows}")
    return tile_schedule(counts, chunk_rows // tile_rows, tile_rows)[:4]


# ---------------------------------------------------------------------------
# plain versions (any device; the kernels' references)
# ---------------------------------------------------------------------------

def _live_tiles(sched, tile_rows):
    """[(row slice, expert)] of the live tiles, in tile order."""
    expert, live = sched[0].tolist(), sched[1].tolist()
    return [(slice(t * tile_rows, (t + 1) * tile_rows), e)
            for t, (e, lv) in enumerate(zip(expert, live)) if lv]


def gmm_fwd_plain(lhs, rhs, sched, tile_rows=TILE_ROWS):
    """out [M, N] in promote(lhs, rhs): each live tile's rows times its
    expert's rhs, f32 accumulation; dead tiles zero."""
    out_dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    out = torch.zeros((lhs.shape[0], rhs.shape[2]), dtype=out_dtype,
                      device=lhs.device)
    for rows, e in _live_tiles(sched, tile_rows):
        out[rows] = (lhs[rows].float() @ rhs[e].float()).to(out_dtype)
    return out


def gmm_dx_plain(dout, rhs, sched, tile_rows=TILE_ROWS):
    """dlhs [M, K] = dout @ rhs[e]^T per live tile in dout's dtype, f32
    accumulation; dead tiles zero."""
    dlhs = torch.zeros((dout.shape[0], rhs.shape[1]), dtype=dout.dtype,
                       device=dout.device)
    for rows, e in _live_tiles(sched, tile_rows):
        dlhs[rows] = (dout[rows].float() @ rhs[e].float().T).to(dout.dtype)
    return dlhs


def gmm_dw_plain(lhs, dout, sched, tile_rows=TILE_ROWS, num_experts=None):
    """drhs [E, K, N] = sum over each expert's live tiles, in tile order,
    of lhs_t^T @ dout_t in f32, cast once to lhs's dtype; experts with no
    tile are exactly zero."""
    E = int(num_experts)
    acc = torch.zeros((E, lhs.shape[1], dout.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for rows, e in _live_tiles(sched, tile_rows):
        acc[e] += lhs[rows].float().T @ dout[rows].float()
    return acc.to(lhs.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_shapes(name, a, b, sched, tile_rows, a_cols, b_dim):
    """a [M, a_cols]; b of rank 3 (rhs [E, K, N]) or 2 (dout [M, N]);
    sched (tile_expert, live), int tensors of M // tile_rows tiles."""
    if a.ndim != 2 or b.ndim != b_dim:
        raise ValueError(f"{name}: got operands of shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.shape[1] != a_cols:
        raise ValueError(f"{name}: contraction mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if tile_rows < 1 or a.shape[0] % tile_rows:
        raise ValueError(f"{name}: M = {a.shape[0]} is not a multiple of "
                         f"tile_rows = {tile_rows}")
    n_t = a.shape[0] // tile_rows
    if len(sched) != 2 or any(s.shape != (n_t,) for s in sched):
        raise ValueError(f"{name}: the schedule must be two [{n_t}] "
                         f"tensors (tile_expert, live)")


def _check_cuda(name, tensors, sched, tile_rows, k, n, num_experts):
    """The kernels' contract for CUDA tensors; raises on anything else."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t0.device}")
    if t0.dtype not in _DTYPE_CODE or any(t.dtype != t0.dtype
                                          for t in tensors):
        raise TypeError(f"{name}: operands must share one dtype of "
                        f"{list(_DTYPE_CODE)}; got "
                        f"{[t.dtype for t in tensors]}")
    if any(s.dtype != torch.int32 for s in sched):
        raise TypeError(f"{name}: the schedule must be int32")
    allt = tuple(tensors) + tuple(sched)
    if any(t.device != t0.device for t in allt):
        raise ValueError(f"{name}: all tensors must share one device")
    if any(not t.is_contiguous() for t in allt):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must start on 16-byte aligned "
                         f"storage")
    if tile_rows != TILE_ROWS:
        raise ValueError(f"{name}: tile_rows {tile_rows}; the kernel takes "
                         f"{TILE_ROWS} only")
    if k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(f"{name}: K = {k} must be a multiple of "
                         f"{K_MULTIPLE} and N = {n} of {N_MULTIPLE} (the "
                         f"kernel's tile)")
    if sched[0].shape[0] > 65535:
        raise ValueError(f"{name}: {sched[0].shape[0]} row tiles exceed "
                         f"65535")
    if num_experts > 65535 or num_experts * k >= 2 ** 31:
        raise ValueError(f"{name}: {num_experts} experts of K = {k} exceed "
                         f"65535 experts or 2^31 rows of rhs")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def gmm_fwd(lhs, rhs, sched, tile_rows=TILE_ROWS):
    """lhs [M, K], rhs [E, K, N], sched (tile_expert, live) -> out
    [M, N] in promote(lhs, rhs).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`gmm_fwd_plain`. ``gmm_fwd.launches`` counts kernel
    launches."""
    _check_shapes("gmm_fwd", lhs, rhs, sched, tile_rows, rhs.shape[1], 3)
    if lhs.device.type == "cpu":
        return gmm_fwd_plain(lhs, rhs, sched, tile_rows)
    m, k = lhs.shape
    n = rhs.shape[2]
    E = rhs.shape[0]
    _check_cuda("gmm_fwd", (lhs, rhs), sched, tile_rows, k, n, E)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    fn = _build.kernel("grouped_matmul", "gmm_fwd", _ARGS)
    err = fn(lhs.data_ptr(), rhs.data_ptr(), sched[0].data_ptr(),
             sched[1].data_ptr(), out.data_ptr(), m // tile_rows, E, k, n,
             _DTYPE_CODE[lhs.dtype], _stream(lhs))
    _build.check("grouped_matmul", err, "gmm_fwd")
    gmm_fwd.launches += 1
    return out


def gmm_dx(dout, rhs, sched, tile_rows=TILE_ROWS):
    """dout [M, N], rhs [E, K, N] -> dlhs [M, K] in dout's dtype.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`gmm_dx_plain`. ``gmm_dx.launches`` counts kernel
    launches."""
    _check_shapes("gmm_dx", dout, rhs, sched, tile_rows, rhs.shape[2], 3)
    if dout.device.type == "cpu":
        return gmm_dx_plain(dout, rhs, sched, tile_rows)
    m, n = dout.shape
    k = rhs.shape[1]
    E = rhs.shape[0]
    _check_cuda("gmm_dx", (dout, rhs), sched, tile_rows, k, n, E)
    dlhs = torch.empty((m, k), dtype=dout.dtype, device=dout.device)
    fn = _build.kernel("grouped_matmul", "gmm_dx", _ARGS)
    err = fn(dout.data_ptr(), rhs.data_ptr(), sched[0].data_ptr(),
             sched[1].data_ptr(), dlhs.data_ptr(), m // tile_rows, E, k, n,
             _DTYPE_CODE[dout.dtype], _stream(dout))
    _build.check("grouped_matmul", err, "gmm_dx")
    gmm_dx.launches += 1
    return dlhs


def gmm_dw(lhs, dout, sched, tile_rows=TILE_ROWS, num_experts=None):
    """lhs [M, K], dout [M, N] -> drhs [E, K, N] in lhs's dtype: each
    expert's live tiles summed in tile order in f32; no tile, exact zero.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`gmm_dw_plain`. ``gmm_dw.launches`` counts kernel
    launches."""
    _check_shapes("gmm_dw", lhs, dout, sched, tile_rows, lhs.shape[1], 2)
    if dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"gmm_dw: lhs {tuple(lhs.shape)} and dout "
                         f"{tuple(dout.shape)} have different rows")
    if num_experts is None or int(num_experts) < 1:
        raise ValueError("gmm_dw: num_experts must be a positive int")
    if lhs.device.type == "cpu":
        return gmm_dw_plain(lhs, dout, sched, tile_rows, num_experts)
    m, k = lhs.shape
    n = dout.shape[1]
    E = int(num_experts)
    _check_cuda("gmm_dw", (lhs, dout), sched, tile_rows, k, n, E)
    drhs = torch.empty((E, k, n), dtype=lhs.dtype, device=lhs.device)
    fn = _build.kernel("grouped_matmul", "gmm_dw", _ARGS)
    err = fn(lhs.data_ptr(), dout.data_ptr(), sched[0].data_ptr(),
             sched[1].data_ptr(), drhs.data_ptr(), m // tile_rows, E, k, n,
             _DTYPE_CODE[lhs.dtype], _stream(lhs))
    _build.check("grouped_matmul", err, "gmm_dw")
    gmm_dw.launches += 1
    return drhs


gmm_fwd.launches = 0
gmm_dx.launches = 0
gmm_dw.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------

class _GroupedMatmul(torch.autograd.Function):
    """Forward :func:`gmm_fwd`; backward :func:`gmm_dx` for lhs and
    :func:`gmm_dw` for rhs, as the JAX custom vjp. The schedule gets no
    gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, expert, live, tile_rows):
        sched = (expert, live)
        ctx.save_for_backward(lhs, rhs, *sched)
        ctx.tile_rows = tile_rows
        return gmm_fwd(lhs, rhs, sched, tile_rows)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, *sched = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_dx(g, rhs, sched, ctx.tile_rows)
        if ctx.needs_input_grad[1]:
            drhs = gmm_dw(lhs, g, sched, ctx.tile_rows, rhs.shape[0])
        return dlhs, drhs, None, None, None


def grouped_matmul(lhs, rhs, sched, tile_rows=TILE_ROWS):
    """Ragged grouped GEMM: rows of ``lhs`` [M, K] in group e times ``rhs``
    [E, K, N] -> out [M, N]; ``sched`` is the (tile_expert, live) of
    :func:`tile_schedule`. Rows of dead tiles come back zero.
    Differentiable in lhs and rhs."""
    if lhs.shape[0] % tile_rows:
        raise ValueError(f"grouped_matmul: M = {lhs.shape[0]} is not a "
                         f"multiple of tile_rows = {tile_rows}")
    return _GroupedMatmul.apply(lhs, rhs, *sched, tile_rows)
