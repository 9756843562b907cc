"""Scaled dot-product attention (port of
``paddle_tpu/nn/functional/attention.py``).

Layout matches the reference: [batch, seq, num_heads, head_dim], and
[total_tokens, num_heads, head_dim] for the packed varlen entry. Dispatch
follows the JAX package's ``_use_pallas`` by the query's device: a CUDA
tensor takes the port's kernels (the dense flash kernels, or the varlen
kernels), a CPU tensor the plain softmax path with f32 logits, which is
JAX's own branch off the TPU.

``dropout`` / ``dropout_p`` are accepted and never applied, as in the JAX
package (its ``_xla_sdpa`` ignores ``dropout_p``; its kernel branches
require 0). ``sdp_kernel`` needs the flag registry, which is not ported.
"""
from __future__ import annotations

import torch

from ...ops.flash_attention import flash_attention_bshd
from ...ops.flash_varlen import flash_varlen_attention


def _xla_sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
              scale=None):
    """Plain attention: q [B, Sq, H, D], k and v [B, Sk, Hkv, D] (GQA by
    repeating kv heads); f32 logits with an additive -1e30 causal mask
    (bottom-right aligned when Sq != Sk) and an optional boolean (True =
    keep) or additive mask; P cast to v's dtype before P.V. Returns
    [B, Sq, H, D] in q's dtype. ``dropout_p`` is ignored."""
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2)
    hq, hk = qh.shape[1], kh.shape[1]
    if hk != hq:
        rep = hq // hk
        kh = torch.repeat_interleave(kh, rep, dim=1)
        vh = torch.repeat_interleave(vh, rep, dim=1)
    d = q.shape[-1]
    s = scale if scale is not None else \
        1.0 / torch.sqrt(torch.full((), float(d), device=q.device))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * s
    if is_causal:
        sq, sk = logits.shape[-2:]
        neg = torch.triu(torch.full((sq, sk), -1e30, device=q.device),
                         diagonal=sk - sq + 1)
        logits = logits + neg
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, -1e30)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(vh.dtype), vh)
    return out.transpose(1, 2).to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """On a CUDA tensor with no mask and no dropout, the flash kernels
    (``flash_attention_bshd``); otherwise :func:`_xla_sdpa`."""
    if query.device.type == "cuda" and attn_mask is None \
            and dropout_p == 0.0:
        return flash_attention_bshd(query, key, value, causal=is_causal,
                                    scale=scale)
    return _xla_sdpa(query, key, value, attn_mask, dropout_p, is_causal,
                     scale)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, name=None):
    """paddle.nn.functional.flash_attention parity wrapper: (out, None)."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal)
    return out, None


def _varlen_attention(q, k, v, cu_q, cu_k, max_q, max_k, scale, causal):
    """Packed varlen attention by a padded batch: q [total_q, H, D], k and
    v [total_k, Hkv, D], cu_* [B+1] offsets. Scatters the tokens into
    [B, max, H, D], runs :func:`_xla_sdpa` under the validity (and
    per-sequence top-left causal) mask, and gathers the valid rows back.
    Returns [total_q, H, D]."""
    dev = q.device
    cq, ck = cu_q.long(), cu_k.long()
    b = cq.shape[0] - 1
    lens_q = cq[1:] - cq[:-1]
    lens_k = ck[1:] - ck[:-1]
    iq = torch.arange(max_q, device=dev)
    ik = torch.arange(max_k, device=dev)
    idx_q = torch.clamp(cq[:-1, None] + iq[None], 0, q.shape[0] - 1)
    idx_k = torch.clamp(ck[:-1, None] + ik[None], 0, k.shape[0] - 1)
    valid_q = iq[None] < lens_q[:, None]                      # [B, max_q]
    valid_k = ik[None] < lens_k[:, None]                      # [B, max_k]
    qp, kp, vp = q[idx_q], k[idx_k], v[idx_k]                 # [B,max,H,D]
    mask = valid_q[:, None, :, None] & valid_k[:, None, None, :]
    if causal:
        mask = mask & (iq[:, None] >= ik[None, :])[None, None]
    out = _xla_sdpa(qp, kp, vp, attn_mask=mask, scale=scale)  # [B,max_q,H,D]
    t = torch.arange(q.shape[0], device=dev)
    seg = torch.searchsorted(cq, t, right=True) - 1
    src = seg * max_q + (t - cq[seg])
    flat = out.reshape(b * max_q, *out.shape[2:])
    return flat[src].to(q.dtype)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (unpadded) attention over packed sequences: query
    [total_q, H, D], key and value [total_k, Hkv, D], cu_seqlens_q/k
    [batch+1] int32 offsets (cu[0] = 0, cu[-1] = total). Returns (out
    [total_q, H, D], None). Differentiable.

    On a CUDA tensor this runs the varlen kernels on the packed tensors
    in place (:func:`~paddle_tpu_torch.ops.flash_varlen.flash_varlen_attention`;
    ``cu_seqlens_q is cu_seqlens_k`` marks self-attention); on the CPU the
    padded-batch path :func:`_varlen_attention`, as the JAX package does
    off its kernel branch. JAX's kernel gate (dropout 0, fewer than 1024
    sequences, max_seqlen < 2^20) is not kept on the card: its limits
    come from the TPU kernels' int32 segment codes, which the port's
    kernels do not use (they search cu), and dropout is ignored on both
    branches, so every pack takes the kernels and none builds the padded
    batch's [B, max_q, max_k] logits on the card."""
    max_q, max_k = int(max_seqlen_q), int(max_seqlen_k)
    if query.device.type == "cuda":
        s = (1.0 / float(query.shape[-1]) ** 0.5) if scale is None \
            else scale
        out = flash_varlen_attention(
            query, key, value, cu_seqlens_q, cu_seqlens_k, s, causal,
            self_attn=cu_seqlens_q is cu_seqlens_k,
            max_seqlen=max(max_q, max_k))
        return out, None
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.full((), float(query.shape[-1]),
                                            device=query.device))
    out = _varlen_attention(query, key, value, cu_seqlens_q.int(),
                            cu_seqlens_k.int(), max_q, max_k, scale, causal)
    return out, None
