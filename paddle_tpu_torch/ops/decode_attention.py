"""Slab decode attention for one decode layer: the CUDA kernels
``csrc/decode_attention.cu`` and their plain PyTorch versions (port of
``paddle_tpu/ops/decode_attention.py``).

  decode_attend_update_slab  ports ``decode_attend_update_slab``
                             (``_kernel_update``): write, then attend
  decode_attention_slab      ports ``decode_attention_slab`` (``_kernel``):
                             attend only

Layouts (the JAX package's caches, so they compare directly):
  q          [B, NH, HD]        PRE-SCALED by scale * log2(e), cache dtype
  new_k/v    [B, KVD]           KVD = NKV * HD
  caches     [L, B, KVD, T]     time in the minor dimension, T % 128 == 0
  layer, pos host ints          ``pos``: the slot of the new token, one
                                for the whole batch

Unlike the TPU entries, q is per head, not the block-diagonal [B, NH, KVD]
padding that the TPU's matrix unit wanted, and the output is [B, NH, HD]
f32, not [B, NH, KVD]. Attention covers columns 0..pos inclusive. The
update entry writes its column into the caches IN PLACE (the JAX package
aliases them) and returns only the attention. A ragged T raises here;
``llama_decode_step`` sends such caches down its plain einsum path before
any launch, as the JAX model does.

The softmax is the online recurrence only, per 128-column tile, in the
log2 domain; the TPU default's tile-0-anchored variant is not ported.
The PADDLE_TPU_DECODE_HD64_STACK pair kernel (``_kernel_pair``) computes
``decode_attention_slab``'s function on the diagonal blocks its caller
keeps; its pairing is a TPU lane tiling, and :func:`decode_attention_slab`
covers it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LOG2E = 1.4426950408889634
TILE_T = 128    # columns per tile, the kernel's and the plain version's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_REPS = (1, 2, 4, 8)            # query heads per kv head the kernel takes
_HEAD_DIMS = (8, 16, 32, 64, 128)


def decode_attention_plain(q, k_cache, v_cache, layer: int, pos: int
                           ) -> torch.Tensor:
    """Plain PyTorch version on any device, tile by tile with the
    kernels' online softmax: P rounded to the cache dtype before P.V, the
    normaliser summed from the unrounded f32 P. Returns attn
    [B, NH, HD] f32."""
    B, NH, HD = q.shape
    T = k_cache.shape[-1]
    nkv = k_cache.shape[2] // HD
    rep = NH // nkv
    dev = q.device
    kl = k_cache[layer].reshape(B, nkv, HD, T)
    vl = v_cache[layer].reshape(B, nkv, HD, T)
    qf = q.float().reshape(B, nkv, rep, HD)
    m = torch.full((B, nkv, rep), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, rep), device=dev)
    acc = torch.zeros((B, nkv, rep, HD), device=dev)
    for c0 in range(0, pos + 1, TILE_T):
        kt = kl[..., c0:c0 + TILE_T].float()
        vt = vl[..., c0:c0 + TILE_T].float()
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = torch.arange(c0, c0 + TILE_T, device=dev) <= pos
        s = torch.where(live, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrt,bgdt->bgrd", p.to(v_cache.dtype).float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, NH, HD)


def decode_attend_update_plain(q, new_k, new_v, k_cache, v_cache,
                               layer: int, pos: int) -> torch.Tensor:
    """Plain version of the update entry: the column write, then
    :func:`decode_attention_plain`."""
    k_cache[layer, :, :, pos] = new_k.to(k_cache.dtype)
    v_cache[layer, :, :, pos] = new_v.to(v_cache.dtype)
    return decode_attention_plain(q, k_cache, v_cache, layer, pos)


def _check(name, q, k_cache, v_cache, layer, pos, new=()):
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"{name}: want q [B, NH, HD] and caches "
                         f"[L, B, KVD, T]")
    B, NH, HD = q.shape
    L, Bc, KVD, T = k_cache.shape
    tensors = (q, k_cache, v_cache) + tuple(new)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must share q's device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise TypeError(f"{name}: q, the caches (and new_k/new_v) must "
                        f"share one dtype of {list(_DTYPE_CODE)}")
    if v_cache.shape != k_cache.shape or Bc != B \
            or any(t.shape != (B, KVD) for t in new):
        raise ValueError(f"{name}: cache or new column shapes disagree")
    if HD not in _HEAD_DIMS or KVD % HD or NH % (KVD // HD) \
            or NH // (KVD // HD) not in _REPS:
        raise ValueError(f"{name}: NH={NH}, KVD={KVD}, HD={HD} need HD in "
                         f"{_HEAD_DIMS} and NKV = KVD/HD dividing NH with "
                         f"NH/NKV in {_REPS}")
    if T % TILE_T:
        raise ValueError(f"{name}: cache extent {T} is not a multiple of "
                         f"{TILE_T}")
    if not 0 <= layer < L or not 0 <= pos < T:
        raise ValueError(f"{name}: layer {layer} outside [0, {L}) or pos "
                         f"{pos} outside [0, {T})")


def _launch(name, symbol, args, q, k_cache, layer, pos):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError(f"{name}: tensors must start on 16-byte aligned "
                         f"storage")
    B, NH, HD = q.shape
    T = k_cache.shape[-1]
    out = torch.empty((B, NH, HD), dtype=torch.float32, device=q.device)
    fn = _build.kernel("decode_attention", symbol,
                       [ctypes.c_void_p] * (len(args) + 1)
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, int(layer),
             NH, k_cache.shape[2] // HD, HD, T, int(pos),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err, name)
    return out


def decode_attend_update_slab(q, new_k, new_v, k_cache, v_cache,
                              layer: int, pos: int) -> torch.Tensor:
    """Write new_k/new_v into column ``pos`` of layer ``layer`` of the
    caches in place, then attend over columns 0..pos. Returns attn
    [B, NH, HD] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`decode_attend_update_plain`.
    ``decode_attend_update_slab.launches`` counts kernel launches."""
    layer, pos = int(layer), int(pos)
    _check("decode_attend_update_slab", q, k_cache, v_cache, layer, pos,
           (new_k, new_v))
    if q.device.type == "cpu":
        return decode_attend_update_plain(q, new_k, new_v, k_cache, v_cache,
                                          layer, pos)
    out = _launch("decode_attend_update_slab", "slab_attend_update_fwd",
                  (q, new_k, new_v, k_cache, v_cache), q, k_cache, layer,
                  pos)
    decode_attend_update_slab.launches += 1
    return out


def decode_attention_slab(q, k_cache, v_cache, layer: int, pos: int
                          ) -> torch.Tensor:
    """Attend over columns 0..pos of layer ``layer``, read-only. Returns
    attn [B, NH, HD] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`decode_attention_plain`.
    ``decode_attention_slab.launches`` counts kernel launches."""
    layer, pos = int(layer), int(pos)
    _check("decode_attention_slab", q, k_cache, v_cache, layer, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, layer, pos)
    out = _launch("decode_attention_slab", "slab_attention_fwd",
                  (q, k_cache, v_cache), q, k_cache, layer, pos)
    decode_attention_slab.launches += 1
    return out


decode_attend_update_slab.launches = 0
decode_attention_slab.launches = 0
