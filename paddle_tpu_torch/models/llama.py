"""Llama for the paged serving path, generation and the single-GPU train
step (port of ``paddle_tpu/models/llama.py``).

Parameters are a plain dict with every decoder layer STACKED on a leading
axis, the JAX package's layout and names, so weights (and AdamW state)
move between the two through numpy (:func:`params_from_numpy`). Matrix
weights take the JAX ``_mat``'s three forms: plain, weight-only int8
``{'w', 's'}`` (:func:`quantize_llama_int8`) and decode-transposed
``{'wT'[, 's']}`` (:func:`prepare_decode_params`); the paged and train
paths take plain weights. Matrix products are ``torch.matmul`` (XLA's own
in JAX), RMSNorm and the attention kernels are this package's CUDA
kernels, RoPE and the short-prompt prefill attention are plain PyTorch
(plain XLA in JAX).

The paged decode step and prefill chunk mirror ``llama_paged_decode_step``
/ ``llama_paged_prefill_chunk`` op for op, over pools in the model dtype or
int8 pools with f32 scale pools (``kv_scales``); with ``tp`` (an mp group)
they and the verify step run on this rank's weight shards and pool heads,
JAX's shard_map serving island one process a rank. Generation (:func:`generate`:
greedy, sampling, beam search) mirrors the JAX entry points over the
stacked KV cache of :func:`init_kv_cache`: the slab ``[L, B, KV*HD, T]``
below head_dim 128, through the fused slab attend+update kernel, and the
head-major ``[L, B, KV, T, HD]`` with plain grouped einsums above. The
token loop runs eagerly (``lax.scan`` in JAX) and keeps every token on
the device until one copy at the end.

The train step (:func:`build_train_step`) mirrors the JAX one at
parallel = 1: ``llama_loss`` (flash attention, or with ``use_flash=False``
the plain ``_xla_sdpa``; RMSNorm with its gradient; dense f32 cross
entropy) differentiated by autograd, then AdamW. The layer loop replaces
``lax.scan``; with ``remat`` each layer runs under
``torch.utils.checkpoint``, and a remat policy other than ``full`` keeps
what it names across the boundary (:class:`_Keep`, JAX's
``_remat_policy``). :func:`chunked_ce_loss` is JAX's sequence-chunked
head and cross entropy. Over ranks, one process each, it runs dp, ZeRO
sharding (stages 1-3), Megatron tensor parallelism (mp: column and
row splits, the vocabulary-parallel embedding and cross entropy, the
fused FFN ring of ``parallel.collective_matmul``) and pipeline
parallelism (pp: stage-stacked layers over the schedule of
``parallel.pipeline``), held to JAX's mesh step.

The KV pools and caches are updated IN PLACE (the JAX package donates
them); the step functions still return them, so call sites read the same.
The train step likewise updates params and AdamW state in place and
returns them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..distributed import communication as comm
from ..distributed.layout import Layout
from ..distributed.layout import local_shape as _local_shape
from ..distributed.layout import mesh_place as _mesh_place
from ..distributed.layout import shard as _shard
from ..distributed.layout import split_dims as _split_dims
from ..distributed.fleet import HybridCommunicateGroup
from ..ops.decode_attention import TILE_T, decode_attend_update_slab
from ..ops.flash_attention import (_prescale, flash_attention_bshd,
                                   flash_attention_op)
from ..ops.paged_attention import (LOG2E, kv_dequant_blocks,
                                   kv_quant_columns, merge_verify_partials,
                                   paged_attend_update,
                                   paged_attend_update_quant,
                                   paged_attention_verify,
                                   paged_attention_verify_quant,
                                   paged_verify_commit,
                                   paged_verify_commit_quant)
from ..ops.rms_norm import fused_rms_norm
from ..nn.functional.attention import _xla_sdpa
from ..observability.trace import comm_span
from ..ops.rope import apply_rope, build_rope_cache
from ..parallel import collective_matmul as cm
from ..parallel.moe import _top_k
from ..parallel.pipeline import microbatch, pipeline_apply


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama_7b():
    return LlamaConfig()


def llama_13b():
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40)


def llama_tiny(vocab=256, hidden=64, layers=4, heads=4, kv_heads=2, inter=128,
               seq=128):
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=inter, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=kv_heads,
                       max_position_embeddings=seq, dtype=torch.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_llama_params(config: LlamaConfig, seed: int = 0,
                      device=None) -> Dict[str, Any]:
    """Random params N(0, 0.02) in the model dtype, made directly on
    ``device`` (default: the card) from a seeded ``torch.Generator``, one
    layer slice at a time so no f32 copy of a stacked weight exists.
    Same stacked [L, ...] layout and names as the JAX package; the values
    differ from its ``jax.random`` stream."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, kv, hd, L = (c.num_attention_heads, c.num_key_value_heads,
                    c.head_dim, c.num_hidden_layers)

    def normal(shape):
        w = torch.empty(shape, dtype=c.dtype, device=dev)
        for part in (w if len(shape) == 3 else [w]):
            part.normal_(0.0, 0.02, generator=gen)
        return w

    def ones(shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    params = {
        "embed": normal((c.vocab_size, c.hidden_size)),
        "layers": {
            "input_norm": ones((L, c.hidden_size)),
            "q_proj": normal((L, c.hidden_size, h * hd)),
            "k_proj": normal((L, c.hidden_size, kv * hd)),
            "v_proj": normal((L, c.hidden_size, kv * hd)),
            "o_proj": normal((L, h * hd, c.hidden_size)),
            "post_norm": ones((L, c.hidden_size)),
            "gate_proj": normal((L, c.hidden_size, c.intermediate_size)),
            "up_proj": normal((L, c.hidden_size, c.intermediate_size)),
            "down_proj": normal((L, c.intermediate_size, c.hidden_size)),
        },
        "final_norm": ones((c.hidden_size,)),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = normal((c.hidden_size, c.vocab_size))
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)                  # a writable copy: JAX's are read-only
    if a.dtype.name == "bfloat16":   # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None):
    """The JAX package's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this package's tensors on
    ``device`` (default: the card). Any nested dict of arrays goes across
    the same way: the int8 trees of ``quantize_llama_int8`` (int8 codes,
    bf16 scales), the ``qkv_proj`` ``{'wT'}`` stacks of
    ``prepare_decode_params``, and the JAX AdamW state
    ``{"m": tree, "v": tree, "t": 0-d f32}``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree).to(dev)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _mat(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain weights, weight-only int8 (``{'w': int8 [..., in,
    out], 's': [..., out] scales}``) or the decode-transposed form (key
    ``'wT'``: [..., out, in], optional ``'s'``; see
    :func:`_decode_weights`). The int8 product is the JAX one in the same
    order: cast the codes to x's dtype, multiply, then scale."""
    if isinstance(w, dict):
        if "wT" in w:
            r = torch.matmul(x, w["wT"].to(x.dtype).transpose(-1, -2))
            return r * w["s"].to(x.dtype) if "s" in w else r
        return torch.matmul(x, w["w"].to(x.dtype)) * w["s"].to(x.dtype)
    return torch.matmul(x, w)


def _mat_out_dim(w) -> int:
    if isinstance(w, dict):
        if "wT" in w:
            return w["wT"].shape[-2]
        return w["w"].shape[-1]
    return w.shape[-1]


def _at(w, layer: int):
    """Layer ``layer`` of a stacked weight in any of ``_mat``'s forms."""
    if isinstance(w, dict):
        return {k: v[layer] for k, v in w.items()}
    return w[layer]


def llama_logits(params, h: torch.Tensor, config: LlamaConfig,
                 mp=None) -> torch.Tensor:
    """The final norm and the head. With an mp group of more than one
    rank the head is column-parallel: this rank's [..., V/mp] logits of
    its vocabulary slice (``lm_head`` [H, V/mp], or the tied [V/mp, H]
    table), the normed input entering through ``copy_to_mp``."""
    x = cm.copy_to_mp(fused_rms_norm(h, params["final_norm"],
                                     config.rms_norm_eps), mp)
    if config.tie_word_embeddings:
        return x @ params["embed"].T
    return _mat(x, params["lm_head"])


def _rank_kv_heads(config: LlamaConfig, mp: int) -> int:
    if config.num_key_value_heads % mp:
        raise ValueError(f"mp={mp} needs num_key_value_heads % mp == 0 "
                         f"(got {config.num_key_value_heads})")
    return config.num_key_value_heads // mp


def init_paged_kv_pool(config: LlamaConfig, num_blocks: int,
                       block_size: int, kv_dtype: str = "auto",
                       device=None, mp: int = 1):
    """Paged KV pools k and v [L, num_blocks, KV*HD, block_size], zeroed,
    on ``device`` (default: the card). Block 0 is the reserved null block.
    ``kv_dtype='auto'`` stores the model dtype, ``'int8'`` quantized bytes
    (pair them with :func:`init_paged_kv_scales`). With ``mp`` > 1 they
    are one rank's pools: KV/mp heads, the rank's contiguous share of the
    kv-head axis (JAX's pool sharded ``P(None, None, "mp", None)``)."""
    if kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype must be 'auto' or 'int8', "
                         f"got {kv_dtype!r}")
    c = config
    dev = resolve_device(device)
    dt = torch.int8 if kv_dtype == "int8" else c.dtype
    shape = (c.num_hidden_layers, num_blocks,
             _rank_kv_heads(c, mp) * c.head_dim, block_size)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def init_paged_kv_scales(config: LlamaConfig, num_blocks: int,
                         block_size: int, device=None, mp: int = 1):
    """f32 scale pools [L, num_blocks, NKV, block_size] for int8 paged KV
    pools: one scale per block, kv-head and column (``kv_quant_columns``).
    Zeroed, so a column never written dequantizes to exactly 0. With
    ``mp`` > 1, one rank's NKV/mp heads."""
    c = config
    dev = resolve_device(device)
    shape = (c.num_hidden_layers, num_blocks, _rank_kv_heads(c, mp),
             block_size)
    return (torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev))


def _quant_kv(k, v, n: int, nkv: int):
    """n k columns and n v columns quantized by one ``kv_quant_columns``
    call (a column's bytes and scales depend on its own values alone):
    (k codes, v codes [n, KVD] int8, k scales, v scales [n, NKV] f32)."""
    q, s = kv_quant_columns(torch.cat([k.reshape(n, -1), v.reshape(n, -1)]),
                            nkv)
    return q[:n], q[n:], s[:n], s[n:]


def _heads(layers, hd):
    nh = _mat_out_dim(layers["q_proj"]) // hd
    nkv = _mat_out_dim(layers["k_proj"]) // hd
    return nh, nkv


def _swiglu(x, gate, up, down):
    return _mat(F.silu(_mat(x, gate)) * _mat(x, up), down)


def _mlp(p, layer, x, tp=None):
    if not _tp_on(tp):
        return _swiglu(x, _at(p["gate_proj"], layer),
                       _at(p["up_proj"], layer), _at(p["down_proj"], layer))
    gated = F.silu(_mat(x, _at(p["gate_proj"], layer))) \
        * _mat(x, _at(p["up_proj"], layer))
    return _tp_down_proj(gated, _at(p["down_proj"], layer), tp)


# ---------------------------------------------------------------------------
# tensor-parallel serving: the paged steps over the ranks of an mp group
# ---------------------------------------------------------------------------
#
# The serving steps take ``tp``, the mp Group, and this rank's shards of
# the weights (:func:`shard_for_serving`) and of every pool (its kv
# heads). The column-parallel projections need no change: the head counts
# come from the weight shapes, so the paged kernels run at the rank's
# heads. Three collectives exist, as in JAX's shard_map island: the
# vocabulary-parallel embedding's all-reduce (exact: each row is non-zero
# on one rank), the o_proj and down_proj row-parallel reduce (the only
# sums re-associated against mp = 1) and the logits all-gather (an exact
# concat in rank order, so every rank's argmax, finite screen and verify
# accept logic read the same full-vocab logits).

def _tp_on(tp) -> bool:
    return tp is not None and tp.nranks > 1


def _tp_vocab_embed(embed, ids, tp):
    """JAX's ``_tp_vocab_embed``: ``embed`` is this rank's [V/n, H] slice;
    the ids outside it give zero rows and the rows are all-reduced."""
    rows = cm.masked_lookup(embed, ids, tp.rank * embed.shape[0])
    with comm_span("serve.tp_ring.embed",
                   nbytes=rows.numel() * rows.element_size(),
                   site="serve.tp_ring.embed"):
        return cm.reduce_from_mp(rows, tp)


def _embed(params, ids, config: LlamaConfig, tp=None):
    if not _tp_on(tp):
        return params["embed"][ids.long()].to(config.dtype)
    return _tp_vocab_embed(params["embed"], ids, tp).to(config.dtype)


def _tp_row_matmul(x, w, tp):
    """JAX's ``_tp_row_matmul``: x [..., k/n] this rank's part of the
    contraction, w [k/n, out] its rows; the partial products are summed
    over mp by the reduce ring (``PADDLE_TPU_TORCH_TP_OVERLAP`` on, the
    rows dividing the ring, plain weights), else by the blocking
    all-reduce. At mp 2 the ring is bitwise the blocking sum."""
    n = tp.nranks
    lead = x.shape[:-1]
    t = x.numel() // x.shape[-1]
    x2 = x.reshape(t, x.shape[-1])
    if cm.overlap_enabled() and t % n == 0 and not isinstance(w, dict):
        out = cm.ring_allreduce_matmul(x2, w, tp,
                                       cm.resolve_chunks(n, t // n))
    else:
        out = cm.reduce_from_mp(_mat(x2, w), tp)
    return out.reshape(*lead, out.shape[-1])


def _tp_proj(site, a, w, tp):
    t = a.numel() // a.shape[-1]
    with comm_span(site, nbytes=t * _mat_out_dim(w) * a.element_size(),
                   site=site):
        return _tp_row_matmul(a, w, tp)


def _tp_o_proj(a, w, tp):
    return _tp_proj("serve.tp_ring.o_proj", a, w, tp)


def _tp_down_proj(a, w, tp):
    return _tp_proj("serve.tp_ring.down_proj", a, w, tp)


def _o_proj(a, w, tp=None):
    return _tp_o_proj(a, w, tp) if _tp_on(tp) else _mat(a, w)


def _tp_gather_logits(logits, tp):
    """JAX's ``_tp_gather_logits``: this rank's vocabulary slice of the
    logits gathered to the full vocabulary in rank order, under the span
    JAX's verify step records."""
    with comm_span("serve.tp_ring.logits",
                   nbytes=logits.numel() * (tp.nranks - 1)
                   * logits.element_size(), site="serve.tp_ring.logits"):
        return comm.all_gather(logits, logits.ndim - 1, tp)


def _full_logits(logits, tp=None):
    """The decode and prefill steps' f32 logits on every rank: JAX's
    island concatenates them in its ``out_specs``, here an all-gather."""
    logits = logits.float()
    if _tp_on(tp):
        logits = comm.all_gather(logits, logits.ndim - 1, tp)
    return logits


def serving_pspecs(config: LlamaConfig, mp: int):
    """JAX's ``_tp_specs``: the param specs over mp alone (no ZeRO inside
    a serving group)."""
    return param_pspecs(config, ParallelConfig(mp=mp))


def shard_for_serving(params, config: LlamaConfig, tp):
    """This rank's shards of full Llama params for tensor-parallel
    serving over the mp group ``tp``: q/k/v/gate/up by column, o/down by
    row, embed and lm_head by vocabulary (:func:`param_pspecs`), each a
    contiguous copy of its slice; the norms are the caller's tensors.
    Rank r holds heads [r NH/n, (r+1) NH/n) and kv heads likewise."""
    n = tp.nranks
    degrees, coord = {"mp": n}, {"mp": tp.rank}
    return _map_specs(lambda x, s, name: _shard(x, name, s, degrees, coord),
                      params, serving_pspecs(config, n))


@torch.no_grad()
def llama_paged_decode_step(params, k_pool, v_pool, tables, positions, ids,
                            config: LlamaConfig, kv_scales=None, tp=None):
    """One decode step over a PAGED cache: ids [B] i32, tables [B, max_nb]
    i32, positions [B] i32 = the slot each row's new token occupies (its
    block must already be in the table). Padding rows point their tables
    at null block 0 with position 0. Returns (logits [B, vocab] f32,
    k_pool, v_pool); the pools are written in place.

    With ``kv_scales=(k_scale, v_scale)`` the pools are int8: each new
    column is quantized by ``kv_quant_columns`` (the bytes a prefill of
    the same token writes) and the int8 update kernel merges bytes and
    scales in place. Returns (logits, k_pool, v_pool, k_scale, v_scale)
    in that mode.

    ``tp`` (the mp Group): params and pools are this rank's shards
    (:func:`shard_for_serving`, pools at its kv heads) and the logits
    come back gathered to the full vocabulary on every rank."""
    c = config
    b = ids.shape[0]
    hd = c.head_dim
    p = params["layers"]
    nh, nkv = _heads(p, hd)
    kvd = nkv * hd
    h = _embed(params, ids, c, tp)                               # [B, H]
    cos, sin = build_rope_cache(b, hd, base=c.rope_theta,
                                position_ids=positions[:, None])  # [B,1,·]
    scale = LOG2E / (hd ** 0.5)
    for layer in range(k_pool.shape[0]):
        x = fused_rms_norm(h[:, None], p["input_norm"][layer], c.rms_norm_eps)
        q = _mat(x, _at(p["q_proj"], layer)).reshape(b, 1, nh, hd)
        k = _mat(x, _at(p["k_proj"], layer)).reshape(b, 1, nkv, hd)
        v = _mat(x, _at(p["v_proj"], layer)).reshape(b, 1, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # q pre-scaled into the log2 domain: f32 multiply, then back to
        # the model dtype, as the JAX step rounds it
        qs = (q[:, 0].float() * scale).to(q.dtype)
        if kv_scales is None:
            attn = paged_attend_update(
                qs, k.reshape(b, kvd).to(k_pool.dtype),
                v.reshape(b, kvd).to(v_pool.dtype), k_pool, v_pool, tables,
                positions, layer)
        else:
            attn = paged_attend_update_quant(
                qs, *_quant_kv(k, v, b, nkv), k_pool, v_pool, *kv_scales,
                tables, positions, layer)
        h = h + _o_proj(attn.to(c.dtype).reshape(b, nh * hd),
                        _at(p["o_proj"], layer), tp)
        x2 = fused_rms_norm(h[:, None], p["post_norm"][layer],
                            c.rms_norm_eps)[:, 0]
        h = h + _mlp(p, layer, x2, tp)
    logits = _full_logits(llama_logits(params, h[:, None], config)[:, 0], tp)
    if kv_scales is None:
        return logits, k_pool, v_pool
    return (logits, k_pool, v_pool) + tuple(kv_scales)


@torch.no_grad()
def llama_paged_prefill_chunk(params, k_pool, v_pool, table_row, start: int,
                              ids, n_live: int, config: LlamaConfig,
                              kv_scales=None, tp=None):
    """One chunked-prefill slice for ONE sequence: ids [C] i32 padded to
    the chunk bucket, ``n_live`` real tokens, ``start`` tokens already
    cached. Scatters the chunk's KV into the sequence's blocks (padding
    tokens land in null block 0), attends each chunk token over cached
    prefix + chunk causally through a gathered context in plain PyTorch,
    and returns (logits of the LAST REAL token [vocab] f32, k_pool,
    v_pool); the pools are written in place.

    With ``kv_scales=(k_scale, v_scale)`` the pools are int8: the chunk's
    columns are quantized by ``kv_quant_columns`` before the scatter, and
    the context is gathered dequantized in f32, then cast to the model
    dtype, as the JAX step does. Returns (logits, k_pool, v_pool, k_scale,
    v_scale) in that mode. ``tp``: as in :func:`llama_paged_decode_step`."""
    c = config
    C = ids.shape[0]
    hd = c.head_dim
    bs = k_pool.shape[-1]
    max_nb = table_row.shape[0]
    T = max_nb * bs
    dev = ids.device
    p = params["layers"]
    nh, nkv = _heads(p, hd)
    kvd, rep = nkv * hd, nh // nkv
    h = _embed(params, ids, c, tp)[None]                         # [1, C, H]
    pidx = start + torch.arange(C, dtype=torch.int32, device=dev)
    cos, sin = build_rope_cache(C, hd, base=c.rope_theta, position_ids=pidx)
    live = torch.arange(C, device=dev) < n_live
    bid = torch.where(live, table_row[(pidx // bs).clamp(0, max_nb - 1).long()],
                      0).long()
    col = (pidx % bs).long()
    rows = table_row.long()
    tpos = torch.arange(T, device=dev)
    causal = (tpos[None, :] <= pidx[:, None])[:, None, None, :]  # [C,1,1,T]
    # the live context: columns holding this sequence's tokens (cached
    # prefix and this chunk's live tokens), never a dead table slot's
    # null-block 0 or a stale column past start + n_live. A live token's
    # causal columns all lie inside it.
    ctx_live = ((tpos < start + n_live)
                & (rows.repeat_interleave(bs) != 0)).reshape(max_nb, bs)
    zero = torch.zeros((1, 1), device=dev)   # f32 with a shape: promotes
    for layer in range(k_pool.shape[0]):
        x = fused_rms_norm(h, p["input_norm"][layer], c.rms_norm_eps)
        q = _mat(x, _at(p["q_proj"], layer)).reshape(1, C, nh, hd)
        k = _mat(x, _at(p["k_proj"], layer)).reshape(1, C, nkv, hd)
        v = _mat(x, _at(p["v_proj"], layer)).reshape(1, C, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # advanced indices (bid, col) split by a slice put C first: the
        # target is [C, KVD], one column per chunk token
        if kv_scales is None:
            k_pool[layer, bid, :, col] = k.reshape(C, kvd).to(k_pool.dtype)
            v_pool[layer, bid, :, col] = v.reshape(C, kvd).to(v_pool.dtype)
            kctx, vctx = k_pool[layer][rows], v_pool[layer][rows]
        else:
            k_scale, v_scale = kv_scales
            kq, vq, ksq, vsq = _quant_kv(k, v, C, nkv)
            k_pool[layer, bid, :, col] = kq
            v_pool[layer, bid, :, col] = vq
            k_scale[layer, bid, :, col] = ksq
            v_scale[layer, bid, :, col] = vsq
            kctx = kv_dequant_blocks(k_pool[layer][rows],
                                     k_scale[layer][rows]).to(c.dtype)
            vctx = kv_dequant_blocks(v_pool[layer][rows],
                                     v_scale[layer][rows]).to(c.dtype)
        # the sequence's context (prefix + this chunk) as one slab
        kg = kctx.permute(1, 0, 2).reshape(nkv, hd, T)
        # V's slab in f32 with its dead columns SELECTED out, not weighted
        # by an exact 0 (0 * NaN is NaN, and freed blocks are reused
        # uncleared), in the one pass that lays it out. Padding tokens
        # take the same product: their results land in null block 0 only,
        # which no live read uses, so its bytes differ from JAX's
        vf = torch.empty((kvd, max_nb, bs), dtype=torch.float32, device=dev)
        torch.where(ctx_live, vctx.permute(1, 0, 2), zero, out=vf)
        qg = q[0].reshape(C, nkv, rep, hd)
        s = torch.einsum("cgrd,gdt->cgrt", qg.float(), kg.float()) \
            / (hd ** 0.5)
        s = torch.where(causal, s, torch.tensor(-1e30, device=dev))
        probs = torch.softmax(s, dim=-1).to(vctx.dtype).float()
        attn = torch.einsum("cgrt,gdt->cgrd", probs,
                            vf.view(nkv, hd, T)).to(c.dtype)
        h = h + _o_proj(attn.reshape(1, C, nh * hd), _at(p["o_proj"], layer),
                        tp)
        x2 = fused_rms_norm(h, p["post_norm"][layer], c.rms_norm_eps)
        h = h + _mlp(p, layer, x2, tp)
    h_last = h[0, n_live - 1:n_live][None]
    logits = _full_logits(llama_logits(params, h_last, config)[0, 0], tp)
    if kv_scales is None:
        return logits, k_pool, v_pool
    return (logits, k_pool, v_pool) + tuple(kv_scales)


# ---------------------------------------------------------------------------
# speculative decoding: draft model + batched paged verification
# ---------------------------------------------------------------------------

def make_draft_model(params, config: LlamaConfig, num_layers: int = 1):
    """Default draft model for speculative decoding: the base model's
    FIRST ``num_layers`` decoder layers as views ``v[:dl]`` of the stacked
    leaves (no copy), with the embedding, final norm and lm head shared by
    reference. Verification re-derives every emitted token from the base
    model, so the draft's quality moves latency only. Returns
    (draft_params, draft_config)."""
    dl = max(1, min(int(num_layers), config.num_hidden_layers))
    dcfg = dataclasses.replace(config, num_hidden_layers=dl)
    dparams = {
        "embed": params["embed"],
        "layers": {k: ({kk: vv[:dl] for kk, vv in v.items()}
                       if isinstance(v, dict) else v[:dl])
                   for k, v in params["layers"].items()},
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        dparams["lm_head"] = params["lm_head"]
    return dparams, dcfg


def _verify_logits(params, k_pool, v_pool, tables, qstart, fed,
                   config: LlamaConfig, kv_scales=None, tp=None):
    """The base model over T fed tokens per row, attending each over the
    row's cached prefix (the verify kernel's partials) merged exactly with
    the fed tokens' own causal block. Returns (logits [B, T, vocab] f32,
    k_cols, v_cols [L, B, T, KVD] in the pool dtype); the pools are only
    read. With ``kv_scales`` the pools are int8: the fed columns are
    quantized once, the fed block attends over their dequantized f32
    values, and the result also holds their scales (k_col_scales,
    v_col_scales [L, B, T, NKV] f32). With ``tp`` the logits are this
    rank's vocabulary slice."""
    c = config
    B, T = fed.shape
    hd = c.head_dim
    p = params["layers"]
    if "qkv_proj" in p:
        raise ValueError("llama_paged_verify_step: a fused 'qkv_proj' "
                         "(prepare_decode_params) is not ported for "
                         "verification; pass the unfused q/k/v weights")
    nh, nkv = _heads(p, hd)
    kvd, rep = nkv * hd, nh // nkv
    dev = fed.device
    h = _embed(params, fed, c, tp)                               # [B, T, H]
    pos2d = qstart[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
    cos, sin = build_rope_cache(T, hd, base=c.rope_theta,
                                position_ids=pos2d)          # [B, T, hd/2]
    scale = LOG2E / (hd ** 0.5)
    # padding rows (qstart 0): their cached-side partials are replaced by
    # exact zeros (anchor -1e30) with where, never by multiplying
    live = (qstart > 0)[:, None, None, None]
    neg = torch.tensor(-1e30, device=dev)
    zero = torch.tensor(0.0, device=dev)
    causal = (torch.arange(T, device=dev)[None, :]
              <= torch.arange(T, device=dev)[:, None])        # [t, u]
    cols = []
    for layer in range(k_pool.shape[0]):
        x = fused_rms_norm(h, p["input_norm"][layer], c.rms_norm_eps)
        q = _mat(x, _at(p["q_proj"], layer)).reshape(B, T, nh, hd)
        k = _mat(x, _at(p["k_proj"], layer)).reshape(B, T, nkv, hd)
        v = _mat(x, _at(p["v_proj"], layer)).reshape(B, T, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        qs = (q.float() * scale).to(q.dtype)
        if kv_scales is None:
            acc_c, m_c, l_c = paged_attention_verify(qs, k_pool, v_pool,
                                                     tables, qstart, layer)
            # fed columns as stored (pool dtype round trip): the values
            # sequential decode would read back from the cache
            k_st = k.reshape(B, T, kvd).to(k_pool.dtype)
            v_st = v.reshape(B, T, kvd).to(v_pool.dtype)
            kf = k_st.float().reshape(B, T, nkv, hd)
            vf = v_st.float().reshape(B, T, nkv, hd)
            cols.append((k_st, v_st))
        else:
            acc_c, m_c, l_c = paged_attention_verify_quant(
                qs, k_pool, v_pool, *kv_scales, tables, qstart, layer)
            # fed columns quantized once; the fed block reads them back
            # dequantized, as sequential int8 decode reads the cache
            kq, vq, ksq, vsq = _quant_kv(k, v, B * T, nkv)
            kf = kq.float().reshape(B, T, nkv, hd) \
                * ksq.reshape(B, T, nkv, 1)
            vf = vq.float().reshape(B, T, nkv, hd) \
                * vsq.reshape(B, T, nkv, 1)
            cols.append((kq.reshape(B, T, kvd), vq.reshape(B, T, kvd),
                         ksq.reshape(B, T, nkv), vsq.reshape(B, T, nkv)))
        # the fed tokens' causal block in f32, P not rounded
        qg = qs.float().reshape(B, T, nkv, rep, hd)
        s_f = torch.einsum("btgrd,bugd->btgru", qg, kf)
        s_f = torch.where(causal[None, :, None, None, :], s_f, neg)
        m_f = s_f.amax(dim=-1, keepdim=True)
        p_f = torch.exp2(s_f - m_f)
        l_f = p_f.sum(dim=-1, keepdim=True)
        # fed token u > t is selected out of t's V (not weighted by 0)
        vsel = torch.where(causal[None, :, :, None, None], vf[:, None],
                           zero)                           # [B, t, u, g, d]
        acc_f = torch.einsum("btgru,btugd->btgrd", p_f, vsel)
        m_f = m_f.reshape(B, T, nh, 1)
        l_f = l_f.reshape(B, T, nh, 1)
        acc_f = acc_f.reshape(B, T, nh, hd)
        attn = merge_verify_partials(
            torch.where(live, acc_c, zero),
            torch.where(live, m_c[..., None], neg),
            torch.where(live, l_c[..., None], zero),
            acc_f, m_f, l_f).to(c.dtype)
        h = h + _o_proj(attn.reshape(B, T, nh * hd), _at(p["o_proj"], layer),
                        tp)
        x2 = fused_rms_norm(h, p["post_norm"][layer], c.rms_norm_eps)
        h = h + _mlp(p, layer, x2, tp)
    logits = llama_logits(params, h, config).float()
    return (logits,) + tuple(torch.stack(c) for c in zip(*cols))


@torch.no_grad()
def llama_paged_verify_step(params, k_pool, v_pool, tables, qstart,
                            t_live, fed, config: LlamaConfig,
                            kv_scales=None, tp=None):
    """Score T fed tokens per sequence in ONE base-model pass over a
    paged cache, greedily accept/reject, and commit only accepted KV.

    fed [B, T] i32: fed[:, 0] is each row's last emitted token (its KV is
    not cached yet), fed[:, 1:] the draft's proposals; qstart [B] i32
    cached token counts (fed[:, j] sits at position qstart + j); t_live
    [B] i32 live fed counts (1 = plain decode through this path, 0 = a
    padding row: tables at null block 0, qstart 0). out[:, j] is the
    base's greedy token after position qstart + j; commit_len = accepted
    proposals + 1 counts the fed tokens whose KV is committed, after the
    logits, in one launch over all layers.

    Returns (out [B, T] i32, commit_len [B] i32, fin_ok [B] bool, k_pool,
    v_pool), all on the device; the pools are written in place. With
    ``kv_scales=(k_scale, v_scale)`` the pools are int8: the cached side
    goes through the int8 verify kernel, the fed columns are quantized
    once by ``kv_quant_columns`` (their dequantized values feed the fed
    block, their bytes and scales the int8 commit), and the result is
    (out, commit_len, fin_ok, k_pool, v_pool, k_scale, v_scale).

    ``tp`` (the mp Group): params and pools are this rank's shards; the
    logits are gathered to the full vocabulary before the screen and the
    accept logic, so every rank computes the same out, commit_len and
    fin_ok and commits into its own pool shard on the same schedule."""
    B, T = fed.shape
    logits, *cols = _verify_logits(params, k_pool, v_pool, tables, qstart,
                                   fed, config, kv_scales, tp)
    if _tp_on(tp):
        logits = _tp_gather_logits(logits, tp)
    # per-row finite screen: the engine sees tokens, not logits
    fin_ok = torch.isfinite(logits).all(dim=2).all(dim=1)
    out = logits.argmax(dim=-1).int()
    # longest prefix where the base argmax equals the proposal (inside the
    # live window), then the base's correction token
    if T > 1:
        steps = torch.arange(1, T, dtype=torch.int32, device=fed.device)
        match = (out[:, :-1] == fed[:, 1:]) & (steps[None, :]
                                               < t_live[:, None])
        accepted = torch.cumprod(match.int(), dim=1).sum(dim=1)
    else:
        accepted = torch.zeros((B,), dtype=torch.int64, device=fed.device)
    commit_len = torch.where(t_live > 0, accepted + 1,
                             torch.zeros_like(accepted)).int()
    if kv_scales is None:
        paged_verify_commit(*cols, k_pool, v_pool, tables, qstart,
                            commit_len)
        return out, commit_len, fin_ok, k_pool, v_pool
    paged_verify_commit_quant(*cols, k_pool, v_pool, *kv_scales, tables,
                              qstart, commit_len)
    return (out, commit_len, fin_ok, k_pool, v_pool) + tuple(kv_scales)


# ---------------------------------------------------------------------------
# decode weights: fused transposed q/k/v and weight-only int8
# ---------------------------------------------------------------------------

def _decode_weights(params, config: LlamaConfig):
    """The q/k/v projection stacks transposed to [L, out, in] and fused
    into one ``qkv_proj`` ``{'wT'[, 's']}`` stack, as the JAX
    ``_decode_weights`` builds them once per generate call. Params whose
    projection widths disagree with the config's head ratio (pruned heads)
    get three unfused ``{'wT'}`` stacks instead, since the fused split
    re-derives the head counts from the config. Prepared params come back
    unchanged; otherwise the result is a new dict and ``params`` is left
    as it was."""
    layers = dict(params["layers"])
    if "qkv_proj" in layers:
        return params
    q_out = _mat_out_dim(layers["q_proj"])
    k_out = _mat_out_dim(layers["k_proj"])
    ratio = config.num_attention_heads // config.num_key_value_heads
    if q_out != k_out * ratio or k_out != _mat_out_dim(layers["v_proj"]):
        for name in ("q_proj", "k_proj", "v_proj"):
            w = layers[name]
            if isinstance(w, dict):
                if "wT" in w:
                    continue
                layers[name] = {"wT": w["w"].transpose(-1, -2).contiguous(),
                                "s": w["s"]}
            else:
                layers[name] = {"wT": w.transpose(-1, -2).contiguous()}
        return dict(params, layers=layers)
    ws = [layers.pop(n) for n in ("q_proj", "k_proj", "v_proj")]
    if isinstance(ws[0], dict):
        layers["qkv_proj"] = {
            "wT": torch.cat([w["w"].transpose(-1, -2) for w in ws], dim=-2),
            "s": torch.cat([w["s"] for w in ws], dim=-1)}
    else:
        layers["qkv_proj"] = {
            "wT": torch.cat([w.transpose(-1, -2) for w in ws], dim=-2)}
    return dict(params, layers=layers)


def prepare_decode_params(params, config: LlamaConfig):
    """:func:`_decode_weights` once, outside any generate call. The JAX
    function donates the raw q/k/v stacks to the fused copy; here the
    returned dict simply no longer holds them, so once the caller drops
    the old ``params`` only the fused copy stays resident. Idempotent:
    prepared params (the fused ``qkv_proj`` form, or the unfused
    ``{'wT'}`` form that mismatched head ratios take) come back
    unchanged."""
    layers = params["layers"]
    if "qkv_proj" in layers or (isinstance(layers.get("q_proj"), dict)
                                and "wT" in layers["q_proj"]):
        return params
    return _decode_weights(params, config)


def _absmax_intq(w, axis, bound=127.0):
    """Symmetric per-channel quantization, the port's own copy of
    ``paddle_tpu/nn/quant.py`` ``absmax_intq``: (int8 codes, f32 scale
    with keepdims). f32 division by a tensor (no reciprocal shortcut) and
    round half to even, so codes and scales are bitwise JAX's."""
    f = w.float()
    b = torch.full((), bound, dtype=torch.float32, device=f.device)
    scale = torch.clamp(f.abs().amax(dim=axis, keepdim=True) / b, min=1e-8)
    q = torch.clamp(torch.round(f / scale), -bound, bound).to(torch.int8)
    return q, scale


def quantize_llama_int8(params):
    """Weight-only int8 for serving, as the JAX ``quantize_llama_int8``:
    every matrix weight of the layers and ``lm_head`` becomes
    ``{'w': int8, 's': per-output-channel scale in the weight's dtype}``
    (per (layer, out) channel for the stacked weights); the embedding and
    the norms keep their float dtype. Returns a new dict."""
    names = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
             "up_proj", "down_proj"}

    def quant(w):
        wi, sc = _absmax_intq(w, axis=-2)
        return {"w": wi, "s": sc.squeeze(-2).to(w.dtype)}

    out = dict(params)
    out["layers"] = {k: (quant(v) if k in names else v)
                     for k, v in params["layers"].items()}
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    return out


# ---------------------------------------------------------------------------
# stacked KV cache: prefill and decode step
# ---------------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  device=None):
    """Stacked per-layer cache, zeroed, in the model dtype, on ``device``
    (default: the card), in the JAX ``init_kv_cache``'s layouts so caches
    compare directly: k and v [L, B, KV*HD, max_len] (the slab, time
    minor) for head_dim < 128, else head-major [L, B, KV, max_len, HD].
    ``pos`` is a host int: the loop that steps the cache knows it, so
    reading it costs no sync."""
    c = config
    dev = resolve_device(device)
    if c.head_dim >= 128:
        shape = (c.num_hidden_layers, batch, c.num_key_value_heads,
                 max_len, c.head_dim)
    else:
        shape = (c.num_hidden_layers, batch,
                 c.num_key_value_heads * c.head_dim, max_len)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev), "pos": 0}


def _qkv(p, layer: int, x, config: LlamaConfig):
    """q, k, v [..., n, HD] of one layer from x [..., H]: one product
    through the fused ``qkv_proj`` when the params hold it (split as the
    JAX step splits it, head counts from the config's ratio), else
    three."""
    hd = config.head_dim
    lead = x.shape[:-1]
    if "qkv_proj" in p:
        ratio = config.num_attention_heads // config.num_key_value_heads
        nkv = _mat_out_dim(p["qkv_proj"]) // hd // (ratio + 2)
        nh = nkv * ratio
        q, k, v = torch.split(_mat(x, _at(p["qkv_proj"], layer)),
                              [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        nh = _mat_out_dim(p["q_proj"]) // hd
        nkv = _mat_out_dim(p["k_proj"]) // hd
        q = _mat(x, _at(p["q_proj"], layer))
        k = _mat(x, _at(p["k_proj"], layer))
        v = _mat(x, _at(p["v_proj"], layer))
    return (q.reshape(*lead, nh, hd), k.reshape(*lead, nkv, hd),
            v.reshape(*lead, nkv, hd))


@torch.no_grad()
def llama_prefill(params, cache, ids, config: LlamaConfig):
    """Batched prompt prefill: one pass over ids [B, S] writes the first S
    columns of the cache in place and returns (last-position logits
    [B, vocab] f32, cache with ``pos`` advanced by S). Attention is the
    flash kernel for S >= 1024, else the plain causal :func:`_xla_sdpa`,
    the branch the JAX prefill takes."""
    c = config
    b, s = ids.shape
    hd = c.head_dim
    kc, vc = cache["k"], cache["v"]
    h = params["embed"][ids.long()].to(c.dtype)                  # [B, S, H]
    cos, sin = build_rope_cache(s, hd, base=c.rope_theta, device=ids.device)
    p = params["layers"]
    for layer in range(kc.shape[0]):
        x = fused_rms_norm(h, p["input_norm"][layer], c.rms_norm_eps)
        q, k, v = _qkv(p, layer, x, c)
        nh, nkv = q.shape[2], k.shape[2]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if hd < 128:    # slab [B, KV*HD, T]
            kc[layer, :, :, :s] = k.reshape(b, s, nkv * hd).transpose(1, 2)
            vc[layer, :, :, :s] = v.reshape(b, s, nkv * hd).transpose(1, 2)
        else:           # head-major [B, KV, T, HD]
            kc[layer, :, :, :s] = k.transpose(1, 2)
            vc[layer, :, :, :s] = v.transpose(1, 2)
        if s >= 1024:
            attn = flash_attention_bshd(q, k, v, causal=True)
        else:
            attn = _xla_sdpa(q, k, v, is_causal=True)
        h = h + _mat(attn.reshape(b, s, nh * hd), _at(p["o_proj"], layer))
        x2 = fused_rms_norm(h, p["post_norm"][layer], c.rms_norm_eps)
        h = h + _mlp(p, layer, x2)
    logits = llama_logits(params, h[:, -1:].contiguous(), config)[:, 0]
    return logits.float(), {"k": kc, "v": vc, "pos": cache["pos"] + s}


def _cache_attention(qg, kl, vl, spec: str, pos: int):
    """The JAX step's einsum decode attention over one layer's cache:
    qg [B, G, R, HD], kl/vl one layer in ``spec`` ("bgdt": the slab as
    [B, G, HD, T]; "bgtd": head-major), f32 scores over columns 0..pos,
    softmax, P cast to the cache dtype. Returns [B, G, R, HD] f32."""
    hd = qg.shape[-1]
    T = kl.shape[-1] if spec == "bgdt" else kl.shape[-2]
    scores = torch.einsum(f"bgrd,{spec}->bgrt", qg.float(), kl.float()) \
        / (hd ** 0.5)
    valid = torch.arange(T, device=qg.device) <= pos
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(vl.dtype)
    return torch.einsum(f"bgrt,{spec}->bgrd", probs.float(), vl.float())


@torch.no_grad()
def llama_decode_step(params, cache, ids, config: LlamaConfig):
    """One incremental decode step: ids [B, 1] -> (logits [B, vocab] f32,
    cache with ``pos`` advanced by one); the new k/v column is written
    into the caches in place at ``pos``. The attention branch is JAX's,
    chosen from shapes before any launch: the slab with T a multiple of
    128 goes through the fused attend+update kernel
    (:func:`decode_attend_update_slab`, q pre-scaled in f32 and cast to
    the model dtype as the JAX step rounds it); a slab of ragged T and the
    head-major cache through plain grouped einsums."""
    c = config
    b = ids.shape[0]
    hd = c.head_dim
    kc, vc = cache["k"], cache["v"]
    max_len = kc.shape[3]
    pos = int(cache["pos"])
    if not 0 <= pos < max_len:
        raise ValueError(f"llama_decode_step: pos {pos} outside the cache "
                         f"extent {max_len}")
    dev = ids.device
    h = params["embed"][ids[:, 0].long()].to(c.dtype)            # [B, H]
    cos, sin = build_rope_cache(
        1, hd, base=c.rope_theta,
        position_ids=torch.full((1,), pos, dtype=torch.int32, device=dev))
    p = params["layers"]
    for layer in range(kc.shape[0]):
        x = fused_rms_norm(h[:, None], p["input_norm"][layer], c.rms_norm_eps)
        q, k, v = _qkv(p, layer, x, c)                           # [B, 1, ·]
        nh, nkv = q.shape[2], k.shape[2]
        kvd, rep = nkv * hd, nh // nkv
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if hd < 128 and max_len % TILE_T == 0:
            qs = (q[:, 0].float() * (LOG2E / hd ** 0.5)).to(q.dtype)
            attn = decode_attend_update_slab(
                qs, k.reshape(b, kvd).to(kc.dtype).contiguous(),
                v.reshape(b, kvd).to(vc.dtype).contiguous(), kc, vc, layer,
                pos)
        else:
            qg = q[:, 0].reshape(b, nkv, rep, hd)
            if hd < 128:
                kc[layer, :, :, pos] = k.reshape(b, kvd)
                vc[layer, :, :, pos] = v.reshape(b, kvd)
                attn = _cache_attention(
                    qg, kc[layer].reshape(b, nkv, hd, max_len),
                    vc[layer].reshape(b, nkv, hd, max_len), "bgdt", pos)
            else:
                kc[layer, :, :, pos] = k[:, 0]
                vc[layer, :, :, pos] = v[:, 0]
                attn = _cache_attention(qg, kc[layer], vc[layer], "bgtd",
                                        pos)
        h = h + _mat(attn.to(c.dtype).reshape(b, nh * hd),
                     _at(p["o_proj"], layer))
        x2 = fused_rms_norm(h[:, None], p["post_norm"][layer],
                            c.rms_norm_eps)[:, 0]
        h = h + _mlp(p, layer, x2)
    logits = llama_logits(params, h[:, None], config)[:, 0]
    return logits.float(), {"k": kc, "v": vc, "pos": pos + 1}


# ---------------------------------------------------------------------------
# generation: greedy, sampling, beam search
# ---------------------------------------------------------------------------

def _check_params_on(params, dev: torch.device, caller: str) -> None:
    """Params must already live on the device generation runs on; nothing
    is moved silently."""
    for t in _leaves(params):
        if t.device.type != dev.type:
            raise ValueError(f"{caller}: params live on {t.device}, "
                             f"generation runs on {dev}")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def generate_scan_bucket(max_new_tokens: int) -> int:
    """The JAX scan length for a continuation of ``max_new_tokens - 1``
    tokens, rounded up to a power of two (0 for none). The port's loop
    runs only the steps it needs; the bucket still sizes the cache, so
    the kernel sees the JAX T."""
    n_cont = max_new_tokens - 1
    return 1 << (n_cont - 1).bit_length() if n_cont > 0 else 0


def _prefill_for_generate(params, prompt_ids, config: LlamaConfig,
                          max_new_tokens, max_len, extra_len, caller,
                          device=None):
    """Shared generation preamble: validation, cache sizing (the JAX rule,
    T = round_up(max(max_len, prompt + extra_len), 128)), prefill. Returns
    (prompt, logits, cache), logits None for no new tokens."""
    prompt = np.asarray(prompt_ids)
    b, plen = prompt.shape
    if plen == 0:
        raise ValueError(f"{caller}: prompt must be non-empty")
    if max_new_tokens <= 0:
        return prompt, None, None
    max_len = max_len or (plen + max_new_tokens)
    if max_len < plen + max_new_tokens:
        raise ValueError(
            f"{caller}: max_len={max_len} < prompt {plen} + "
            f"max_new_tokens {max_new_tokens}; the cache would overflow")
    dev = resolve_device(device)
    _check_params_on(params, dev, caller)
    cache_len = -(-max(max_len, plen + extra_len) // TILE_T) * TILE_T
    cache = init_kv_cache(config, b, cache_len, device=dev)
    ids = torch.from_numpy(np.ascontiguousarray(prompt, np.int32)).to(dev)
    logits, cache = llama_prefill(params, cache, ids, config)
    return prompt, logits, cache


def generate_scan(params, cache, first_token, num_tokens,
                  config: LlamaConfig):
    """Generate ``num_tokens`` greedily after ``first_token`` [B, 1] int32
    (normally the argmax of the prefill logits): an eager loop of decode
    steps (``lax.scan`` in JAX) whose argmax stays on the device. Returns
    (tokens [B, num_tokens] int32 on the device, cache)."""
    params = _decode_weights(params, config)
    tok, toks = first_token, []
    for _ in range(num_tokens):
        logits, cache = llama_decode_step(params, cache, tok, config)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
    if not toks:
        return first_token.new_zeros((first_token.shape[0], 0)), cache
    return torch.cat(toks, dim=1), cache


def greedy_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens,
                    max_len=None, device=None):
    """Greedy decoding: one batched prefill fills the cache, then
    :func:`generate_scan` runs the continuation; prompt_ids [B, S] host
    ints -> numpy [B, max_new_tokens] int32, copied from the device once.
    ``device`` defaults to the card; params must already live there."""
    bucket = generate_scan_bucket(max_new_tokens)
    prompt, logits, cache = _prefill_for_generate(
        params, prompt_ids, config, max_new_tokens, max_len, bucket,
        "greedy_generate", device)
    if logits is None:
        return np.zeros((prompt.shape[0], 0), np.int32)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if max_new_tokens == 1:
        return first.cpu().numpy()
    toks, _ = generate_scan(params, cache, first, max_new_tokens - 1, config)
    return torch.cat([first, toks], dim=1).cpu().numpy()


def _sample_filter(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The logits ``sample_logits`` draws from: scaled by the temperature,
    then the top-k cut, then the nucleus cut over the surviving mass (the
    token that crosses ``top_p`` stays); cut tokens are -inf."""
    v = logits.shape[-1]
    # a device fill, not torch.tensor(): a blocking host copy would
    # synchronise every step
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32,
                   device=logits.device)
    z = logits / t
    if top_k and top_k < v:
        kth = torch.sort(z, dim=-1).values[:, -top_k][:, None]
        z = torch.where(z < kth, float("-inf"), z)
    sorted_z = torch.sort(z, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_z, dim=-1), dim=-1)
    cut = torch.clamp((cum < top_p).sum(dim=-1, keepdim=True), max=v - 1)
    thresh = torch.gather(sorted_z, -1, cut)
    return torch.where(z < thresh, float("-inf"), z)


def sample_logits(logits, key, temperature=1.0, top_k=0, top_p=1.0):
    """One sampling step on [B, vocab] f32 logits: top_k = 0 disables the
    k cut, top_p = 1.0 the nucleus cut; both compose, k first. ``key`` is
    a ``torch.Generator`` on the logits' device; the draw is Gumbel-max,
    as ``jax.random.categorical`` draws, but the bits differ from JAX's
    for the same seed. Returns [B] int32 on the device."""
    z = _sample_filter(logits, temperature, top_k, top_p)
    u = torch.rand(z.shape, generator=key, device=z.device)
    return torch.argmax(z - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def sample_scan(params, cache, first_logits, num_tokens, config, key,
                temperature=1.0, top_k=0, top_p=1.0):
    """Sampling counterpart of :func:`generate_scan`: the first token is
    drawn from the prefill logits, then ``num_tokens - 1`` decode steps
    draw the rest from the generator ``key``. Returns (tokens
    [B, num_tokens] int32 on the device, cache)."""
    params = _decode_weights(params, config)
    tok = sample_logits(first_logits, key, temperature, top_k, top_p)[:, None]
    toks = [tok]
    for _ in range(num_tokens - 1):
        logits, cache = llama_decode_step(params, cache, tok, config)
        tok = sample_logits(logits, key, temperature, top_k, top_p)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), cache


def sample_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens,
                    temperature=1.0, top_k=0, top_p=1.0, seed=0,
                    max_len=None, device=None):
    """Sampling generation: prefill, then :func:`sample_scan` with a
    ``torch.Generator`` seeded from ``seed``, so a fixed seed repeats
    (JAX draws other tokens from the same seed). Returns numpy
    [B, max_new_tokens] int32."""
    bucket = generate_scan_bucket(max_new_tokens + 1)
    prompt, logits, cache = _prefill_for_generate(
        params, prompt_ids, config, max_new_tokens, max_len, bucket,
        "sample_generate", device)
    if logits is None:
        return np.zeros((prompt.shape[0], 0), np.int32)
    key = torch.Generator(device=logits.device).manual_seed(seed)
    toks, _ = sample_scan(params, cache, logits, max_new_tokens, config, key,
                          temperature, int(top_k), top_p)
    return toks.cpu().numpy()


def _gather_tree(ids, parents):
    """Beam backtrack, the port's copy of ``paddle_tpu/nn/functional/
    common.py`` ``_gather_tree_impl``: ids and parents [T, B, K]; walking
    parent pointers back from the last step gives each surviving beam's
    sequence [T, B, K]."""
    t, b, k = ids.shape
    beam = torch.arange(k, device=ids.device).expand(b, k)
    out = [None] * t
    for i in range(t - 1, -1, -1):
        out[i] = torch.gather(ids[i], 1, beam)
        beam = torch.gather(parents[i], 1, beam).long()
    return torch.stack(out)


def beam_search_scan(params, cache, first_logits, num_tokens, config,
                     num_beams, length_penalty=0.0, eos_token_id=None):
    """Beam search as the JAX ``beam_search_scan``: beams ride the batch
    dim (B*K rows, beam-major within each batch row), each step gathers
    the cache to the surviving parents, and the token/parent history is
    backtracked at the end. Ties break toward the lower index, as
    ``lax.top_k`` breaks them. With ``eos_token_id`` a finished beam only
    extends with EOS at no cost and its length stops growing; scores are
    cum / len ** length_penalty. Returns (sequences [B, K, num_tokens],
    scores [B, K]) best-first, on the device."""
    b, v = first_logits.shape
    k = num_beams
    dev = first_logits.device
    cum, tok = _top_k(torch.log_softmax(first_logits.float(), dim=-1), k)
    tok = tok.to(torch.int32)
    cache = {"k": torch.repeat_interleave(cache["k"], k, dim=1),
             "v": torch.repeat_interleave(cache["v"], k, dim=1),
             "pos": cache["pos"]}
    alive_len = torch.ones((b, k), dtype=torch.int32, device=dev)
    if eos_token_id is not None:
        only_eos = torch.full((v,), -1e9, device=dev)
        only_eos[eos_token_id] = 0.0
    toks = [tok]
    parents = [torch.arange(k, dtype=torch.int32, device=dev).expand(b, k)]
    for _ in range(num_tokens - 1):
        logits, cache = llama_decode_step(params, cache,
                                          tok.reshape(b * k, 1), config)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        if eos_token_id is not None:
            finished = tok == eos_token_id                          # [B, K]
            logp = torch.where(finished[..., None], only_eos, logp)
            alive_len = alive_len + (~finished).to(torch.int32)
        else:
            alive_len = alive_len + 1
        cum, flat = _top_k((cum[..., None] + logp).reshape(b, k * v), k)
        parent = torch.div(flat, v, rounding_mode="floor")
        tok = (flat % v).to(torch.int32)
        rows = (torch.arange(b, device=dev)[:, None] * k + parent).reshape(-1)
        cache = {"k": cache["k"].index_select(1, rows),
                 "v": cache["v"].index_select(1, rows), "pos": cache["pos"]}
        alive_len = torch.gather(alive_len, 1, parent)
        toks.append(tok)
        parents.append(parent.to(torch.int32))
    seqs = _gather_tree(torch.stack(toks), torch.stack(parents))  # [T, B, K]
    scores = cum / torch.clamp(alive_len.float(), min=1.0) ** length_penalty
    order = torch.argsort(-scores, dim=-1, stable=True)
    scores = torch.gather(scores, 1, order)
    seqs = seqs.permute(1, 2, 0)                                 # [B, K, T]
    seqs = torch.gather(seqs, 1, order[..., None].expand(seqs.shape))
    return seqs, scores


def beam_search_generate(params, prompt_ids, config: LlamaConfig,
                         max_new_tokens, num_beams=4, length_penalty=0.0,
                         eos_token_id=None, max_len=None, device=None):
    """Beam-search generation: prefill once, then :func:`beam_search_scan`
    over exactly ``max_new_tokens`` (no bucketing: extra steps would
    change the scores). Returns numpy (sequences [B, num_beams,
    max_new_tokens] int32, scores [B, num_beams] f32) best-first."""
    prompt, logits, cache = _prefill_for_generate(
        params, prompt_ids, config, max_new_tokens, max_len, 0,
        "beam_search_generate", device)
    if logits is None:
        b = prompt.shape[0]
        return (np.zeros((b, num_beams, 0), np.int32),
                np.zeros((b, num_beams), np.float32))
    seqs, scores = beam_search_scan(params, cache, logits,
                                    int(max_new_tokens), config,
                                    int(num_beams), float(length_penalty),
                                    eos_token_id)
    return seqs.cpu().numpy(), scores.cpu().numpy()


def generate(params, prompt_ids, config: LlamaConfig, max_new_tokens=64,
             decode_strategy="greedy_search", temperature=1.0, top_k=0,
             top_p=1.0, num_beams=4, length_penalty=0.0, eos_token_id=None,
             seed=0, max_len=None, device=None):
    """Unified generation entry, the JAX ``generate``: 'greedy_search' |
    'sampling' | 'beam_search'. Greedy and sampling return [B,
    max_new_tokens] token ids; beam search the best beam per batch row.
    ``eos_token_id`` is taken by the beam path only (the greedy and
    sampling loops have a fixed trip count); elsewhere it raises.
    ``device`` defaults to the card; params must already live there."""
    if eos_token_id is not None and decode_strategy != "beam_search":
        raise ValueError(
            "eos_token_id is only supported with "
            "decode_strategy='beam_search'")
    if decode_strategy == "greedy_search":
        return greedy_generate(params, prompt_ids, config, max_new_tokens,
                               max_len=max_len, device=device)
    if decode_strategy == "sampling":
        return sample_generate(params, prompt_ids, config, max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, seed=seed, max_len=max_len,
                               device=device)
    if decode_strategy == "beam_search":
        seqs, _ = beam_search_generate(params, prompt_ids, config,
                                       max_new_tokens, num_beams=num_beams,
                                       length_penalty=length_penalty,
                                       eos_token_id=eos_token_id,
                                       max_len=max_len, device=device)
        return seqs[:, 0]
    raise ValueError(
        f"unknown decode_strategy {decode_strategy!r}; expected "
        "'greedy_search', 'sampling', or 'beam_search'")


# ---------------------------------------------------------------------------
# training (single GPU)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParallelConfig:
    """The JAX package's ``ParallelConfig`` fields. :func:`build_train_step`
    runs one device, or ``dp`` x ``pp`` x ``sharding`` x ``mp`` ranks:
    ZeRO stage ``zero_stage`` over sharding (1: optimizer state sharded,
    2: also gradients, 3: also parameters), Megatron tensor parallelism
    over mp and the pipeline over pp (``microbatches``,
    ``overlap_p2p``); it raises for the rest (see :func:`check_ported`)."""
    dp: int = 1
    mp: int = 1
    pp: int = 1
    sharding: int = 1
    sep: int = 1
    sep_strategy: Optional[str] = None
    microbatches: int = 1
    remat: bool = True
    remat_policy: str = "full"
    scan_unroll: int = 1
    zero_stage: int = 3
    # None = the flash kernels (JAX's None means plain attention off the
    # TPU); False = the plain attention, _xla_sdpa
    use_flash: Optional[bool] = None
    overlap_p2p: Optional[bool] = None

    @property
    def total(self):
        return self.dp * self.mp * self.pp * self.sharding * self.sep


_UNREAD_FIELDS = ("sep_strategy", "microbatches", "scan_unroll",
                  "overlap_p2p")
# the pipeline's fields: read when pp > 1
_PP_FIELDS = ("microbatches", "overlap_p2p")


def check_ported(parallel: ParallelConfig) -> None:
    """Raise ValueError naming what of ``parallel`` the port does not run
    yet: a sequence degree above 1 (alone or beside pp), and a value
    other than the default in a field the train step never reads
    (``_UNREAD_FIELDS``; ``microbatches`` and ``overlap_p2p``, the
    pipeline's, are read when pp > 1). ``dp``, ``sharding``, ``mp`` and
    ``pp`` run (one process a rank). An unknown remat policy raises too
    (with ``remat``), as JAX's ``_remat_policy`` does."""
    default = ParallelConfig()
    unread = {f: getattr(parallel, f) for f in _UNREAD_FIELDS
              if getattr(parallel, f) != getattr(default, f)
              and not (parallel.pp > 1 and f in _PP_FIELDS)}
    if unread:
        raise ValueError(f"{unread}: the train step does not read these "
                         f"fields; leave them at their defaults")
    if parallel.sep > 1:
        raise ValueError(f"sep={parallel.sep}: sequence parallel training "
                         f"is not ported (ROADMAP.md queue 1 item 9); use "
                         f"sep=1")
    if parallel.remat:
        _remat_policy(parallel)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

# policy -> (names kept, every 2-D matmul kept, kept tensors offloaded)
_REMAT_POLICIES = {
    "full": ((), False, False),
    "dots": ((), True, False),
    "save_attn": (("attn_out",), False, False),
    "save_mlp": (("attn_out", "mlp_gate", "mlp_up"), False, False),
    "offload_attn": (("attn_out",), False, True),
}


def _remat_policy(parallel: ParallelConfig):
    """JAX's ``_remat_policy``: the :class:`_Keep` factory of
    ``parallel.remat_policy``, or None for ``'full'`` (only the layer
    input crosses the boundary)."""
    name = parallel.remat_policy
    if name not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; expected 'full', 'dots', "
            "'save_attn', 'save_mlp', or 'offload_attn'")
    if name == "full":
        return None
    return lambda: _Keep(*_REMAT_POLICIES[name])


class _Parked:
    """A kept tensor waiting in host memory for the device it left."""

    def __init__(self, host: torch.Tensor, device: torch.device):
        self.host, self.device = host, device

    def back(self) -> torch.Tensor:
        return self.host.to(self.device, non_blocking=True)


def park_on_host(t: torch.Tensor):
    """A kept CUDA tensor's copy in pinned host memory, queued on the
    current stream (``offload_attn``); ``park_on_host.bytes`` counts the
    bytes sent to the host. A CPU tensor is already there and stays."""
    if not t.is_cuda:
        return t.detach()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    park_on_host.bytes += host.numel() * host.element_size()
    return _Parked(host, t.device)


park_on_host.bytes = 0

_RUN = object()     # a candidate op whose output is recomputed
_MM = torch.ops.aten.mm.default
_FLASH = torch.ops.paddle_tpu_torch.flash_attention.default
_IGNORED = (torch.ops.aten.detach.default,)


class _Keep:
    """What one layer call keeps across its checkpoint (JAX's remat
    policies), passed to ``torch.utils.checkpoint`` as ``context_fn``: the
    outputs of the ops it keeps are stored in the forward and handed back,
    not computed again, when the backward reruns the layer. It keeps

    - for ``attn_out``: the flash op's (o, lse), the attention output and
      the statistic its backward needs (JAX's flash residuals carry no
      name, so JAX may rerun its forward there), its third output, the
      pre-scaled q, made again from the recomputed q; on the plain path
      the copy that lays the attention output out as [B, S, NH*HD];
    - for any other listed name: each op run inside a :meth:`named`
      region that makes new storage (JAX's ``checkpoint_name``; a view of
      its input is recomputed, at no cost);
    - with ``dots``: every ``aten.mm`` output (the 2-D products, as
      ``dots_with_no_batch_dims_saveable``: a batched product is
      recomputed);
    - with ``offload``: the same, parked in pinned host memory
      (:func:`park_on_host`) until the backward needs them.

    The forward and the recompute run the same code, so a candidate op's
    n-th call in one is its n-th call in the other."""

    def __init__(self, names, dots, offload):
        self.names, self.dots, self.offload = frozenset(names), dots, offload
        self.naming = False
        self.store = collections.defaultdict(list)

    @contextlib.contextmanager
    def named(self, name):
        before, self.naming = self.naming, name in self.names
        try:
            yield
        finally:
            self.naming = before

    def candidate(self, func) -> bool:
        if func is _FLASH:
            return "attn_out" in self.names
        return (self.dots and func is _MM) or (self.naming
                                              and func not in _IGNORED)

    def park(self, t):
        if isinstance(t, torch.Tensor):
            return park_on_host(t) if self.offload else t.detach()
        return t

    @staticmethod
    def unpark(t):
        return t.back() if isinstance(t, _Parked) else t

    def __call__(self):
        return _KeepMode(self, recompute=False), _KeepMode(self, recompute=True)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


class _KeepMode(TorchDispatchMode):
    """The forward (store) and recompute (hand back) halves of a
    :class:`_Keep`."""

    def __init__(self, keep: _Keep, recompute: bool):
        super().__init__()
        self.keep, self.recompute = keep, recompute
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        keep = self.keep
        if not keep.candidate(func):
            return func(*args, **kwargs)
        queue = keep.store[func]
        if self.recompute:
            i = self.calls[func]
            self.calls[func] += 1
            entry, queue[i] = queue[i], None
            if entry is _RUN:
                return func(*args, **kwargs)
            kept = tree_map(keep.unpark, entry)
            if func is _FLASH:
                return (*kept, _prescale(args[0], args[4]))
            return kept
        out = func(*args, **kwargs)
        fresh = not _storages(out) & _storages((args, kwargs))
        kept = out[:2] if func is _FLASH else out
        queue.append(tree_map(keep.park, kept) if fresh else _RUN)
        return out


def _unnamed(_name):
    return contextlib.nullcontext()


def decoder_layer(p, h_in, cos, sin, config: LlamaConfig, use_flash=True,
                  keep: Optional[_Keep] = None, gather=None, mp=None,
                  fuse_ffn=False):
    """One decoder block for training (the JAX ``decoder_layer`` at
    sep = 1). ``p`` holds ONE layer's weights; h_in [B, S, H]. Attention
    is the flash kernels, or with ``use_flash=False`` the plain causal
    :func:`_xla_sdpa`. ``keep`` is the remat policy's (None: nothing is
    named). ``gather`` (ZeRO stage 3, :class:`_Stage3`) makes the layer's
    full weights from this rank's shards HERE, inside what
    ``torch.utils.checkpoint`` reruns: the full weights are never a
    saved input, and the recompute gathers them again.

    ``mp`` (a group of more than one rank) runs the Megatron pattern on
    this rank's column and row shards, what GSPMD derives from
    :func:`param_pspecs` in JAX: the normed input enters q/k/v and
    gate/up through ``copy_to_mp`` and the o_proj and down_proj partial
    sums leave through ``reduce_from_mp``. The head counts come from the
    weights (NH/mp and NKV/mp). ``fuse_ffn`` tries the fused gate/up ->
    down plan of the rings (:func:`_fused_ffn_overlap`)."""
    c = config
    if gather is not None:
        p = gather.layer(p)
    b, s, _ = h_in.shape
    hd = c.head_dim
    nh = p["q_proj"].shape[-1] // hd
    nkv = p["k_proj"].shape[-1] // hd
    named = keep.named if keep is not None else _unnamed
    x = cm.copy_to_mp(fused_rms_norm(h_in, p["input_norm"], c.rms_norm_eps),
                      mp)
    q = _mat(x, p["q_proj"]).reshape(b, s, nh, hd)
    k = _mat(x, p["k_proj"]).reshape(b, s, nkv, hd)
    v = _mat(x, p["v_proj"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if use_flash:
        attn = flash_attention_bshd(q, k, v, causal=True).reshape(
            b, s, nh * hd)
    else:
        attn = _xla_sdpa(q, k, v, is_causal=True)
        with named("attn_out"):
            attn = attn.reshape(b, s, nh * hd)
    h = h_in + cm.reduce_from_mp(_mat(attn, p["o_proj"]), mp)
    x = fused_rms_norm(h, p["post_norm"], c.rms_norm_eps)
    mlp_out = _fused_ffn_overlap(x, p, mp) if fuse_ffn else None
    if mlp_out is None:
        x = cm.copy_to_mp(x, mp)
        with named("mlp_gate"):
            g = _mat(x, p["gate_proj"])
        with named("mlp_up"):
            u = _mat(x, p["up_proj"])
        mlp_out = cm.reduce_from_mp(_mat(F.silu(g) * u, p["down_proj"]), mp)
    return h + mlp_out


def _fuse_ffn(parallel: ParallelConfig, mp) -> bool:
    """Whether the decoder tries JAX's fused FFN ring
    (``_fused_ffn_overlap``'s conditions that do not depend on shapes):
    ``PADDLE_TPU_TORCH_TP_OVERLAP`` on, mp above 1, sep 1 and a remat
    policy other than ``save_mlp`` (the plan hides the gate and up
    products the policy keeps)."""
    return (mp is not None and mp.nranks > 1 and parallel.sep == 1
            and parallel.remat_policy != "save_mlp" and cm.overlap_enabled())


def _fused_ffn_overlap(x, p, mp):
    """gate/up -> silu-mul -> down by ``cm.plan_fused_ffn`` (JAX's
    ``_fused_ffn_overlap``): the [B, S, I/mp] activation stays on the rank
    and the only collective is the down product's reduce ring. None (the
    blocking path) for int8 weights or where the plan does not apply. The
    plan gets this rank's rows as the token rows (JAX's global rows over
    the batch axes: the same local rows) and the weights' global
    shapes."""
    ws = [p[k] for k in ("gate_proj", "up_proj", "down_proj")]
    if any(isinstance(w, dict) for w in ws):
        return None
    gate, up, down = ws
    n = mp.nranks
    plan = cm.plan_fused_ffn(
        tuple(x.shape), (gate.shape[0], gate.shape[1] * n),
        (down.shape[0] * n, down.shape[1]), mp, n_cols=2,
        activation=cm.swiglu)
    if plan is None:
        return None
    return plan(x, (gate, up), down)


def vocab_parallel_embed(embed, ids, config: LlamaConfig, mp=None):
    """The token embedding. With an mp group of more than one rank
    ``embed`` is this rank's vocabulary slice [V/mp, H]: the ids in it
    are looked up, the rest give zeros, and the rows are all-reduced
    over mp (``reduce_from_mp``). Each row is non-zero on one rank, so
    the sum is exact, as JAX's one-hot product over the vocab-sharded
    table; the backward stays local."""
    if mp is None or mp.nranks == 1:
        return F.embedding(ids.long(), embed).to(config.dtype)
    part = cm.masked_lookup(embed, ids, mp.rank * embed.shape[0])
    return cm.reduce_from_mp(part, mp).to(config.dtype)


def llama_hidden(params, ids, config: LlamaConfig,
                 parallel: ParallelConfig = ParallelConfig(), gather=None,
                 mp=None):
    """Embed + the decoder stack; returns the final hidden (pre-norm).
    ``params["layers"]`` maps each name to a stacked [L, ...] tensor or to
    a list of its L layer slices (the train step's gradient leaves). With
    ``parallel.remat`` each layer is recomputed in the backward, keeping
    its input and what ``parallel.remat_policy`` names. ``gather`` (ZeRO
    stage 3) makes full weights from shards: the embedding here, each
    layer's inside :func:`decoder_layer`. ``mp`` (the mp group): the
    params are this rank's mp shards (:func:`vocab_parallel_embed`,
    :func:`decoder_layer`)."""
    c = config
    embed = params["embed"] if gather is None else \
        gather.leaf("embed", params["embed"])
    h = vocab_parallel_embed(embed, ids, c, mp)
    cos, sin = build_rope_cache(ids.shape[1], c.head_dim, base=c.rope_theta,
                                device=h.device)
    return decoder_stack(params["layers"], h, cos, sin, c, parallel, gather,
                         mp, _fuse_ffn(parallel, mp))


def decoder_stack(layers, h, cos, sin, config: LlamaConfig,
                  parallel: ParallelConfig, gather=None, mp=None,
                  fuse=False):
    """The decoder layers of ``layers`` (each name a stacked [n, ...]
    tensor or a list of its n layer slices) over h [B, S, H], in order:
    with ``parallel.remat`` each layer under ``torch.utils.checkpoint``
    with the policy's :class:`_Keep` (JAX's scan of ``decoder_layer``
    under ``jax.checkpoint``); ``gather``, ``mp`` and ``fuse`` go to
    :func:`decoder_layer`. A pipeline stage runs its layers through
    this."""
    c = config
    use_flash = parallel.use_flash is not False
    policy = _remat_policy(parallel) if parallel.remat else None
    for i in range(len(layers["q_proj"])):
        p = {name: w[i] for name, w in layers.items()}
        if not parallel.remat:
            h = decoder_layer(p, h, cos, sin, c, use_flash, None, gather, mp,
                              fuse)
        elif policy is None:
            h = checkpoint(decoder_layer, p, h, cos, sin, c, use_flash, None,
                           gather, mp, fuse, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            keep = policy()
            h = checkpoint(decoder_layer, p, h, cos, sin, c, use_flash, keep,
                           gather, mp, fuse, use_reentrant=False,
                           preserve_rng_state=False, context_fn=keep)
    return h


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross entropy lse - logit[label] of f32 logits split over
    mp by vocabulary, [..., V/mp] on each rank (rank r holds the labels
    [r V/mp, (r+1) V/mp)). Forward: the row max all-reduced with MAX
    (a constant of the backward), the sum of exp under it and the picked
    logit (non-zero on the owning rank) all-reduced with SUM, three
    [...] f32 reductions. Backward, local: g times (the softmax under the
    global lse, minus the one-hot on the owning rank)."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        vs = logits.shape[-1]
        m = comm.all_reduce(logits.amax(dim=-1), group, op="max")
        s = comm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                            group)
        lse = m + torch.log(s)
        loc = labels.long() - group.rank * vs
        ok = (loc >= 0) & (loc < vs)
        loc = torch.where(ok, loc, 0)
        picked = torch.where(ok, logits.gather(-1, loc[..., None])[..., 0],
                             logits.new_zeros(()))
        ctx.save_for_backward(logits, lse, loc, ok)
        return lse - comm.all_reduce(picked, group)

    @staticmethod
    def backward(ctx, g):
        logits, lse, loc, ok = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, loc[..., None], -ok[..., None].to(grad.dtype))
        return grad * g[..., None], None, None


def _ce_sum_count(logits, labels, mp=None):
    """(sum of the cross entropy over labels != -100, their count as f32)
    of f32 logits [..., V]; with an mp group of more than one rank, of
    this rank's vocabulary slice of them (:class:`_VocabParallelCE`,
    within f32 rounding of JAX's ``log_softmax`` over the sharded
    logits)."""
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    if mp is not None and mp.nranks > 1:
        loss = _VocabParallelCE.apply(logits, safe, mp)
        return torch.where(mask, loss, 0.0).sum(), mask.sum().float()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(mask, -picked, 0.0).sum(), mask.sum().float()


def masked_ce_loss(logits, labels):
    """Mean cross entropy over labels != -100 (f32 logits [..., V])."""
    loss_sum, count = _ce_sum_count(logits, labels)
    return loss_sum / torch.clamp(count, min=1)


def _ce_chunk(xc, head, lc):
    logits = (xc @ head).float()
    m = lc != -100
    safe = torch.where(m, lc, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(m, lse - picked, 0.0).sum(), m.sum().float()


def chunked_ce_loss(x, head, labels, n_chunks=8):
    """Head matmul + mean cross entropy over SEQUENCE chunks (JAX's
    ``chunked_ce_loss``): x [B, S, D], head [D, V], labels [B, S] (-100
    ignored). Each chunk's f32 logits live only while the chunk runs, and
    the chunk is recomputed in the backward, so the [B, S, V] logits never
    exist at once. S is padded to a multiple of ``n_chunks`` with ignored
    labels. Sums accumulate chunk by chunk, as JAX's scan does."""
    b, s, d = x.shape
    rem = (-s) % n_chunks
    if rem:
        x = F.pad(x, (0, 0, 0, rem))
        labels = F.pad(labels, (0, rem), value=-100)
        s += rem
    xt = x.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
    lt = labels.reshape(b, n_chunks, s // n_chunks).transpose(0, 1)
    ls = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc in zip(xt, lt):
        l_c, n_c = checkpoint(_ce_chunk, xc, head, lc, use_reentrant=False,
                              preserve_rng_state=False)
        ls, cnt = ls + l_c, cnt + n_c
    return ls / torch.clamp(cnt, min=1.0)


def llama_loss(params, ids, labels, config: LlamaConfig,
               parallel: ParallelConfig = ParallelConfig(), gather=None,
               count_reduce=None, mp=None):
    """Causal LM loss with dense f32 logits; labels [B, S], -100 ignored.
    The dense path, as JAX's ``llama_loss`` keeps it
    (:func:`chunked_ce_loss` is there for memory-bound callers).

    Over ranks (:class:`_DistTrainStep`): ``gather`` (ZeRO stage 3,
    :class:`_Stage3`) makes each sharded weight whole where it is used,
    ``count_reduce`` sums the count of labels != -100 over the ranks in
    place, so the loss is this rank's sum over the global count, and
    ``mp`` (the mp group) runs the model on this rank's mp shards, the
    cross entropy over its vocabulary slice of the logits."""
    h = llama_hidden(params, ids, config, parallel, gather, mp)
    if gather is not None:
        key = "embed" if config.tie_word_embeddings else "lm_head"
        params = {**params, key: gather.leaf(key, params[key])}
    loss_sum, count = _ce_sum_count(
        llama_logits(params, h, config, mp).float(), labels, mp)
    if count_reduce is not None:
        count_reduce(count)
    return loss_sum / torch.clamp(count, min=1)


def _grad_leaf(t):
    return t.detach().requires_grad_()


def _local_grads(leaves):
    """The gradients backward left on ``leaves`` (zeros where none)."""
    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)
    return {k: ({n: [grad(t) for t in ts] for n, ts in v.items()}
                if k == "layers" else grad(v))
            for k, v in leaves.items()}


def llama_loss_and_grads(params, ids, labels, config: LlamaConfig,
                         parallel: ParallelConfig = ParallelConfig(),
                         gather=None, count_reduce=None, grads_of=None,
                         mp=None):
    """(loss, grads) of :func:`llama_loss`, the counterpart of
    ``jax.value_and_grad``. ``grads`` mirrors ``params``, except that the
    gradient of a stacked layer leaf is a LIST of its L per-layer slices:
    each layer's weights enter autograd as views of the stacked tensor, so
    no [L, ...] gradient (and no per-layer scatter into one) is ever
    made. ``gather``, ``count_reduce`` and ``mp`` go to
    :func:`llama_loss`;
    ``grads_of(leaves)``, called before the forward, returns the function
    that gives the gradients after backward (the ranks' sums; default
    :func:`_local_grads`)."""
    leaves = {k: ({n: [_grad_leaf(w[i]) for i in range(w.shape[0])]
                   for n, w in v.items()} if k == "layers" else _grad_leaf(v))
              for k, v in params.items()}
    collect = grads_of(leaves) if grads_of is not None else \
        (lambda: _local_grads(leaves))
    loss = llama_loss(leaves, ids, labels, config, parallel, gather,
                      count_reduce, mp)
    loss.backward()
    return loss.detach(), collect()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _adamw_init(params, multi_precision=True):
    """Zero moments: f32 for every param (``multi_precision``, the default)
    or each param's own dtype; ``t`` a 0-d f32 step count."""
    def zeros(p):
        return torch.zeros(p.shape, device=p.device,
                           dtype=torch.float32 if multi_precision
                           else p.dtype)
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "t": torch.zeros((), dtype=torch.float32, device=leaf.device)}


def _slices(p, g, m, v, mask):
    """(p, g, m, v, mask) pieces along axis 0 to update one at a time: one
    per layer slice where ``g`` is a list of them, else row chunks of at
    most 2**24 elements, so a big leaf's f32 temporaries stay small."""
    def part(x, sl):
        return x if x is None or x.ndim == 0 or x.shape[0] != p.shape[0] \
            else x[sl]
    if isinstance(g, (list, tuple)):
        return [(p[i], g[i], m[i], v[i], part(mask, i))
                for i in range(len(g))]
    if p.ndim == 0:
        return [(p, g, m, v, mask)]
    rows = max(1, (1 << 24) // max(1, p[0].numel()))
    return [(p[r:r + rows], g[r:r + rows], m[r:r + rows], v[r:r + rows],
             part(mask, slice(r, r + rows)))
            for r in range(0, p.shape[0], rows)]


def _adamw_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
                  wd=0.1, masks=None):
    """AdamW, the JAX ``_adamw_update`` in f32 with its operations in the
    same order, applied IN PLACE: params, moments and the returned state
    are the objects passed in (moments stay in their stored dtype). A
    stacked leaf is updated one layer slice (or row chunk) at a time, so
    the f32 temporaries of a [L, 4096, 11008] leaf never exist at once.

    ``grads`` mirrors ``params``; a stacked leaf's gradient may be a list
    of its per-layer slices (:func:`llama_loss_and_grads`). ``masks``
    mirrors ``params`` with leaves None or a bool tensor over the leaf's
    leading dims: False rows keep param and moments bitwise unchanged,
    while ``t`` still advances globally."""
    t = state["t"] + 1
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, g, m, v, mask):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        p32 = p.float()
        p_new = p32 - lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * p32)
        if mask is not None:
            keep = mask.reshape(mask.shape + (1,) * (p.ndim - mask.ndim))
            p_new = torch.where(keep, p_new, p32)
            m_new = torch.where(keep, m_new, m.float())
            v_new = torch.where(keep, v_new, v.float())
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)

    def walk(p, g, m, v, mask):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], g[k], m[k], v[k],
                     None if mask is None else mask.get(k))
            return
        for piece in _slices(p, g, m, v, mask):
            upd(*piece)

    with torch.no_grad():
        walk(params, grads, state["m"], state["v"], masks)
    state["t"] = t
    return params, state


# ---------------------------------------------------------------------------
# dp x sharding (ZeRO stages 1, 2, 3) x mp (Megatron): one process a rank
# ---------------------------------------------------------------------------

def param_pspecs(config: LlamaConfig, parallel: ParallelConfig):
    """JAX's ``param_pspecs``: for each param leaf a tuple with one entry
    a dimension, an axis name or None (its ``PartitionSpec`` read as a
    tuple). mp splits the column-parallel outputs (dim 2 of
    q/k/v/gate/up_proj, dim 1 of lm_head), the row-parallel inputs (dim
    1 of o/down_proj) and embed's vocabulary (dim 0). ZeRO stage 3 shards
    a hidden dimension over ``sharding``: dim 1 of q/k/v/gate/up_proj,
    dim 2 of o/down_proj, dim 1 of embed, dim 0 of lm_head; the norms
    stay replicated."""
    fs = "sharding" if (parallel.sharding > 1 and parallel.zero_stage >= 3) \
        else None
    mp = "mp" if parallel.mp > 1 else None
    layers = {
        "input_norm": (None, None),
        "q_proj": (None, fs, mp),
        "k_proj": (None, fs, mp),
        "v_proj": (None, fs, mp),
        "o_proj": (None, mp, fs),
        "post_norm": (None, None),
        "gate_proj": (None, fs, mp),
        "up_proj": (None, fs, mp),
        "down_proj": (None, mp, fs),
    }
    specs = {"embed": (mp, fs), "layers": layers, "final_norm": (None,)}
    if not config.tie_word_embeddings:
        specs["lm_head"] = (fs, mp)
    return specs


def opt_state_pspecs(config: LlamaConfig, parallel: ParallelConfig,
                     pspec_tree):
    """JAX's ``opt_state_pspecs``: under ZeRO stages 1 and 2 each moment
    leaf shards its first unsharded dimension over ``sharding`` (the layer
    axis L of a stacked leaf, hidden for lm_head and final_norm, vocab
    for embed, or embed's hidden, dim 1, when mp splits its vocab);
    stage 3's follow the params."""
    if parallel.sharding > 1 and parallel.zero_stage < 3:
        def shard_state(spec):
            parts = list(spec)
            for i, p_ in enumerate(parts):
                if p_ is None:
                    parts[i] = "sharding"
                    return tuple(parts)
            return spec
        return _tree_map(shard_state, pspec_tree)
    return pspec_tree


def pipe_pspecs(pspec_tree):
    """JAX's specs under pp (``_build_pp_train_step``): each stacked layer
    leaf, restaged [S, L/S, ...], with "pp" before its spec; embed,
    final_norm and lm_head as they are."""
    return {**pspec_tree, "layers": {n: ("pp",) + sp for n, sp in
                                     pspec_tree["layers"].items()}}


def train_state_pspecs(config: LlamaConfig, parallel: ParallelConfig):
    """(param specs, AdamW moment specs) of the train step's state:
    :func:`param_pspecs` and :func:`opt_state_pspecs`; under pp both
    :func:`pipe_pspecs` of the param specs, as JAX places m and v there
    (ZeRO stages 1 and 2 shard no state under pp)."""
    pspecs = param_pspecs(config, parallel)
    if parallel.pp > 1:
        pspecs = pipe_pspecs(pspecs)
        return pspecs, pspecs
    return pspecs, opt_state_pspecs(config, parallel, pspecs)


def check_pp_layers(config: LlamaConfig, parallel: ParallelConfig) -> None:
    """Raise ValueError, naming the config, unless pp divides the layers
    (JAX asserts it)."""
    if parallel.pp > 1 and config.num_hidden_layers % parallel.pp:
        raise ValueError(
            f"pp={parallel.pp} needs num_hidden_layers "
            f"({config.num_hidden_layers}) to divide by it; config {config}")


def stage_layers(tree, config: LlamaConfig, parallel: ParallelConfig):
    """Under pp, a params-shaped tree with each stacked layer leaf [L, ...]
    as [S, L/S, ...] (a view), JAX's layout under pp; a leaf already
    staged, and any tree at pp 1, passes as it is."""
    S = parallel.pp
    if S == 1:
        return tree
    check_pp_layers(config, parallel)
    base = param_pspecs(config, parallel)["layers"]

    def stage(w, name):
        if w.ndim == len(base[name]) + 1:
            return w
        return w.reshape((S, w.shape[0] // S) + tuple(w.shape[1:]))
    return {**tree, "layers": {n: stage(w, n)
                               for n, w in tree["layers"].items()}}


def _act_spec(parallel: ParallelConfig):
    """JAX's ``_act_spec`` of activations [B, S, H]: the batch over dp (and
    sharding), the sequence over sep. A one-name entry is the name itself,
    as ``PartitionSpec`` collapses it."""
    batch_axes = "dp" if parallel.sharding == 1 else ("dp", "sharding")
    seq_axis = "sep" if parallel.sep > 1 else None
    return (batch_axes, seq_axis, None)


def make_mesh(parallel: ParallelConfig) -> np.ndarray:
    """The world's ranks shaped (dp, pp, sharding, sep, mp): rank r where
    JAX's ``make_mesh`` puts device r."""
    return np.arange(parallel.total).reshape(
        parallel.dp, parallel.pp, parallel.sharding, parallel.sep,
        parallel.mp)


def _map_specs(fn, tree, specs, path=""):
    """``fn(leaf, spec, path)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k], f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(tree, specs, path)


def shard_train_state(params, opt_state, config: LlamaConfig,
                      parallel: ParallelConfig):
    """This rank's shards of full trees: ``params`` and ``opt_state``'s m
    and v (:func:`_adamw_init`'s layout; None passes through) by
    :func:`train_state_pspecs`; under pp the layer leaves [L, ...] are
    first restaged [S, L/S, ...] (:func:`stage_layers`). A sharded leaf
    is a contiguous copy of its slice; a replicated leaf (and ``t``) is
    the caller's tensor. Returns (params, opt_state)."""
    degrees, coord = _mesh_place(parallel)
    pspecs, ospecs = train_state_pspecs(config, parallel)

    def shard(tree, specs):
        tree = stage_layers(tree, config, parallel)
        return _map_specs(lambda x, s, name: _shard(x, name, s, degrees,
                                                    coord), tree, specs)
    if opt_state is not None:
        opt_state = {"m": shard(opt_state["m"], ospecs),
                     "v": shard(opt_state["v"], ospecs), "t": opt_state["t"]}
    return shard(params, pspecs), opt_state


def _axis_groups(hcg):
    return {"dp": hcg.get_data_parallel_group(),
            "pp": hcg.get_pipe_parallel_group(),
            "sharding": hcg.get_sharding_parallel_group(),
            "mp": hcg.get_model_parallel_group()}


def _hcg(parallel: ParallelConfig):
    return HybridCommunicateGroup(dp_degree=parallel.dp,
                                  pp_degree=parallel.pp,
                                  sharding_degree=parallel.sharding,
                                  mp_degree=parallel.mp)


def gather_train_state(params, opt_state, config: LlamaConfig,
                       parallel: ParallelConfig, hcg=None):
    """The full trees from every rank's shards (a collective: every rank
    calls it), the inverse of :func:`shard_train_state`. ``hcg`` is the
    step's ``HybridCommunicateGroup`` (``step_fn.hcg``); None makes one.
    Returns (params, opt_state); a replicated leaf is the rank's own.
    Under pp the layer leaves come back [S, L/S, ...], JAX's layout."""
    if hcg is None:
        hcg = _hcg(parallel)
    groups = _axis_groups(hcg)
    pspecs, ospecs = train_state_pspecs(config, parallel)

    def gather(x, spec, _name):
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            for a in reversed((entry,) if isinstance(entry, str) else entry):
                x = comm.all_gather(x, d, groups[a])
        return x
    if opt_state is not None:
        opt_state = {"m": _map_specs(gather, opt_state["m"], ospecs),
                     "v": _map_specs(gather, opt_state["v"], ospecs),
                     "t": opt_state["t"]}
    return _map_specs(gather, params, pspecs), opt_state


class _GatherShard(torch.autograd.Function):
    """ZeRO stage 3: the full weight from this rank's shard, all-gathered
    along ``dim`` over the sharding group; the backward reduce-scatters
    (sums) the full weight's gradient back to the shard."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _Stage3:
    """The gather of ZeRO stage 3 by :func:`param_pspecs`: a leaf's
    ``sharding`` dimension made whole over the sharding group; an ``mp``
    split on another dimension stays."""

    def __init__(self, specs, group):
        self.specs, self.group = specs, group

    def _full(self, w, spec):
        dims = [d for d, e in enumerate(spec) if e == "sharding"]
        return _GatherShard.apply(w, dims[0], self.group) if dims else w

    def leaf(self, name, w):
        return self._full(w, self.specs[name])

    def layer(self, p):
        """One layer's full weights (a stacked spec without its L)."""
        return {n: self._full(w, self.specs["layers"][n][1:])
                for n, w in p.items()}


class _DistTrainStep:
    """``step_fn`` of :func:`build_train_step` over dp x sharding x mp
    ranks (see there); ``hcg`` is its ``HybridCommunicateGroup``."""

    def __init__(self, config, parallel, lr, hcg, dev):
        self.config, self.parallel, self.lr = config, parallel, lr
        self.hcg, self.dev = hcg, dev
        self.stage = 0 if parallel.sharding == 1 else \
            min(max(parallel.zero_stage, 1), 3)
        if parallel.pp > 1 and self.stage < 3:
            self.stage = 0      # under pp stages 1 and 2 shard no state
        self.degrees, self.coord = _mesh_place(parallel)
        self.pspecs, self.ospecs = train_state_pspecs(config, parallel)
        self.dp = hcg.get_data_parallel_group()
        self.sh = hcg.get_sharding_parallel_group()
        self.mp = hcg.get_model_parallel_group()
        # the ranks of this mp coordinate across dp x sharding: every mp
        # rank holds the same rows, so the count, the loss and the
        # gradients replicated over mp are summed here, never over mp
        self.data = hcg.get_data_sharding_group()
        ((_, self.n_blocks, self.block),) = _split_dims(
            _act_spec(parallel)[:1], self.degrees, self.coord) or \
            ((0, 1, 0),)
        self.gather = _Stage3(param_pspecs(config, parallel), self.sh) \
            if self.stage == 3 else None
        # the {"params", "opt", "step"} train state over the ranks, as
        # the checkpoint layer saves and restores it: ``t`` and ``step``
        # are whole on every rank, with no spec (JAX's build leaves its
        # ``t`` uncommitted)
        self.layout = Layout(self.degrees, self.coord,
                             {"params": self.pspecs,
                              "opt": {"m": self.ospecs, "v": self.ospecs}})

    def __call__(self, params, opt, ids, labels):
        loss, grads = self.loss_and_grads(params,
                                          *self.local_batch(ids, labels))
        self.update(params, grads, opt)
        return params, opt, loss

    def local_batch(self, ids, labels):
        """This rank's rows of the global [B, S] host batch, on the
        device."""
        ids, labels = np.asarray(ids), np.asarray(labels)
        b = ids.shape[0]
        if b % self.n_blocks:
            raise ValueError(
                f"a batch of {b} rows does not divide over the "
                f"{self.n_blocks} ranks of {_act_spec(self.parallel)[0]} "
                f"(dp x sharding)")
        n = b // self.n_blocks
        rows = slice(self.block * n, (self.block + 1) * n)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows], np.int32)
                                    ).to(self.dev)
        return to_dev(ids), to_dev(labels)

    def loss_and_grads(self, params, ids, labels):
        """(the global mean loss, this rank's summed gradients): its rows'
        loss sum over the ALL-REDUCED count of labels != -100, so the
        gradients summed over ranks are the global mean's."""
        local, grads = llama_loss_and_grads(
            params, ids, labels, self.config, self.parallel, self.gather,
            lambda count: comm.all_reduce(count, self.data), self._grads_of,
            self.mp)
        return comm.all_reduce(local.clone(), self.data), grads

    def _grads_of(self, leaves):
        if self.stage != 2:
            return lambda: self._sync(leaves)
        grads = self._hook_stage2(leaves)

        def done():
            grads["layers"] = {n: [ts[i] for i in sorted(ts)]
                               for n, ts in grads["layers"].items()}
            return grads
        return done

    def _sync(self, leaves):
        """Stages 0, 1 and 3: a gradient summed over the dp x sharding
        plane of this mp coordinate (an mp shard's and a leaf replicated
        over mp alike: after ``copy_to_mp``'s backward the norms'
        gradients are equal on every mp rank); a stage-3 shard's (summed
        over sharding by :class:`_GatherShard`) over dp only. In the
        gradient's dtype."""
        def one(t, spec):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            return comm.all_reduce(g, self.dp if "sharding" in spec
                                   else self.data)
        return {k: ({n: [one(t, self.pspecs["layers"][n]) for t in ts]
                     for n, ts in v.items()} if k == "layers"
                    else one(v, self.pspecs[k]))
                for k, v in leaves.items()}

    def _hook_stage2(self, leaves):
        """Stage 2: as backward accumulates each gradient leaf, sum it over
        sharding into the rank that owns its moment rows (a layer slice
        goes whole to one owner: ``reduce``; embed, lm_head, final_norm:
        ``reduce_scatter`` on their moments' sharding dimension), sum that over dp and drop the rest,
        so no full gradient tree exists. Fills and returns the tree."""
        grads = {"layers": {}}
        me = self.sh.rank

        def piece_hook(owner, slot, out):
            def hook(t):
                g = comm.reduce(t.grad, owner, self.sh)
                t.grad = None
                if owner == me:
                    out[slot] = comm.all_reduce(g, self.dp)
            return hook

        def leaf_hook(key):
            dim = self.ospecs[key].index("sharding")

            def hook(t):
                g = comm.reduce_scatter(t.grad, dim, self.sh)
                t.grad = None
                grads[key] = comm.all_reduce(g, self.dp)
            return hook

        for k, v in leaves.items():
            if k != "layers":
                v.register_post_accumulate_grad_hook(leaf_hook(k))
                continue
            for n, ts in v.items():
                per = len(ts) // self.sh.nranks
                out = grads["layers"][n] = {}
                for i, t in enumerate(ts):
                    t.register_post_accumulate_grad_hook(
                        piece_hook(i // per, i % per, out))
        return grads

    def _rows(self, x, spec):
        """This rank's part of the local ``x`` along the ``sharding``
        dimension of ``spec`` (an mp split elsewhere is already local)."""
        d = spec.index("sharding")
        n = x.shape[d] // self.sh.nranks
        return x.narrow(d, self.sh.rank * n, n)

    def update(self, params, grads, opt):
        """AdamW. Stages 0 and 3 update what the rank holds. Stages 1 and 2
        update only the rows its moments own (along the moments'
        ``sharding`` dimension), then all-gather each param's rows over
        sharding, so every replica keeps the same bits."""
        if self.stage in (0, 3):
            _adamw_update(params, grads, opt, self.lr)
            return
        own_p = _map_specs(lambda x, s, _n: self._rows(x, s), params,
                           self.ospecs)
        own_g = grads
        if self.stage == 1:
            per = {n: len(ts) // self.sh.nranks
                   for n, ts in grads["layers"].items()}
            i = self.sh.rank
            own_g = {k: ({n: ts[i * per[n]:(i + 1) * per[n]]
                          for n, ts in v.items()} if k == "layers"
                         else self._rows(v, self.ospecs[k]))
                     for k, v in grads.items()}
        _adamw_update(own_p, own_g, opt, self.lr)

        def gather(full, spec, _name):
            comm.all_gather(self._rows(full, spec).clone(),
                            spec.index("sharding"), self.sh, out=full)
        with torch.no_grad():
            _map_specs(gather, params, self.ospecs)


class _PipeTrainStep(_DistTrainStep):
    """``step_fn`` of :func:`build_train_step` with pp above 1 (JAX's
    ``_build_pp_train_step``), composed with dp, ZeRO sharding and mp.
    Each rank holds its stage's L/S layers ([1, L/S, ...] of every
    [S, L/S, ...] leaf) and runs the collective schedule of
    ``parallel.pipeline`` over its M = max(microbatches, pp) microbatches
    of its rows: stage 0 embeds, every stage runs its layers (each under
    the remat policy; mp the Megatron decoder) on its active ticks, and
    the last stage takes the plain cross entropy over the whole
    vocabulary. Embed, final_norm and lm_head enter whole on every rank
    (JAX's ``P()`` in its island: gathered from their mp and stage-3
    shards); their gradients, nonzero on one stage, are summed over pp,
    so every stage updates them to the same bits."""

    def __init__(self, config, parallel, lr, hcg, dev):
        super().__init__(config, parallel, lr, hcg, dev)
        self.pp = hcg.get_pipe_parallel_group()
        self.microbatches = max(parallel.microbatches, parallel.pp)

    def loss_and_grads(self, params, ids, labels):
        """(the global mean loss on every rank, this rank's summed
        gradients); a layer leaf's gradient is the list of its L/S layer
        slices."""
        leaves = {k: ({n: [_grad_leaf(t) for t in w[0]]
                       for n, w in v.items()} if k == "layers"
                      else _grad_leaf(v))
                  for k, v in params.items()}
        local, roots = self._pipeline(leaves, ids, labels)
        torch.autograd.backward(*roots)
        grads = self._sync(leaves)
        loss = comm.all_reduce(comm.all_reduce(local, self.data), self.pp)
        return loss, grads

    def _whole(self, name, w):
        """Leaf ``name`` made whole: its sharding dimension gathered
        (stage 3; the backward reduce-scatters), then its mp dimension
        (the backward keeps this rank's block: every mp rank computes the
        same whole gradient)."""
        if self.gather is not None:
            w = self.gather.leaf(name, w)
        spec = param_pspecs(self.config, self.parallel)[name]
        if "mp" in spec:
            w = cm.gather_from_mp(w, spec.index("mp"), self.mp)
        return w

    def _pipeline(self, leaves, ids, labels):
        """This stage's part of the loss: (the loss's share to sum over
        ranks, detached; the tensors and gradients backward starts
        from)."""
        c, par = self.config, self.parallel
        S, stage, M = self.pp.nranks, self.pp.rank, self.microbatches
        b, n = ids.shape
        if b % M:
            raise ValueError(
                f"a rank's batch of {b} rows does not divide into {M} "
                f"microbatches (max(microbatches={par.microbatches}, "
                f"pp={S}))")
        dev = ids.device
        cos, sin = build_rope_cache(n, c.head_dim, base=c.rope_theta,
                                    device=dev)
        shape = (M, b // M, n, c.hidden_size)
        if stage == 0:
            embed = self._whole("embed", leaves["embed"])
            x_mb = microbatch(F.embedding(ids.long(), embed).to(c.dtype), M)
        else:       # the schedule reads only its shape off stage 0
            x_mb = torch.zeros((), dtype=c.dtype, device=dev).expand(shape)
        layers = leaves["layers"]
        pipe = pipeline_apply(
            lambda _p, h: decoder_stack(layers, h, cos, sin, c, par,
                                        self.gather, self.mp),
            S, M, self.pp, remat=False, overlap_p2p=par.overlap_p2p)
        out_mb = pipe({}, x_mb)
        if stage != S - 1:  # no loss here: backward walks the hops
            zero = torch.zeros((), device=dev)
            return zero, ((out_mb,), (out_mb.new_zeros(()).expand(shape),))
        head = "embed" if c.tie_word_embeddings else "lm_head"
        params = {"final_norm": leaves["final_norm"],
                  head: self._whole(head, leaves[head])}
        logits = llama_logits(params, out_mb.reshape(b, n, -1), c).float()
        loss_sum, count = _ce_sum_count(logits, labels)
        comm.all_reduce(count, self.data)
        loss = loss_sum / torch.clamp(count, min=1)
        return loss.detach().clone(), ((loss,),)

    def _sync(self, leaves):
        """The dp x sharding sums of :meth:`_DistTrainStep._sync`, then
        embed's, final_norm's and lm_head's over pp."""
        grads = super()._sync(leaves)
        for k in grads:
            if k != "layers":
                comm.all_reduce(grads[k], self.pp)
        return grads

    def update(self, params, grads, opt):
        """AdamW on what the rank holds (its [1, L/S, ...] layer leaves
        updated through their [L/S, ...] views)."""
        def unstack(tree):
            return {k: ({n: w[0] for n, w in v.items()} if k == "layers"
                        else v) for k, v in tree.items()}
        state = {"m": unstack(opt["m"]), "v": unstack(opt["v"]),
                 "t": opt["t"]}
        _adamw_update(unstack(params), grads, state, self.lr)
        opt["t"] = state["t"]


def build_train_step(config: LlamaConfig,
                     parallel: ParallelConfig = ParallelConfig(),
                     lr: float = 3e-4, seed: int = 0, device=None):
    """Returns (step_fn, params, opt_state), as the JAX ``build_train_step``.
    ``step_fn(params, opt, ids, labels) -> (params, opt, loss)``: ids and
    labels are [B, S] int32 host arrays copied to the device; loss is a
    0-d f32 tensor on the device. Params and AdamW state (f32 moments) are
    updated in place. ``device=None`` means the card; what is not ported
    raises ValueError (:func:`check_ported`).

    With ``dp`` x ``pp`` x ``sharding`` x ``mp`` above 1, each of that many
    processes (one a rank, joined by
    ``paddle_tpu_torch.distributed.init_parallel_env``; without it, or with
    another world size, this raises ValueError) calls this with the same
    arguments, and ``step_fn`` with the same GLOBAL batch. The rank takes
    its rows by :func:`_act_spec` (over dp x sharding, rank block r of W
    the rows [r*B/W, (r+1)*B/W); B must divide; the mp ranks of a block
    hold the same rows), the loss is the global mean over labels != -100,
    the same float on every rank, and the gradients are summed over the
    dp x sharding ranks in their dtype. ``zero_stage`` (with sharding
    above 1) 1: AdamW moments sharded (:func:`opt_state_pspecs`), each
    rank updating its rows and all-gathering them; 2: also each gradient
    summed into its owner as backward makes it; 3: params sharded too
    (:func:`param_pspecs`), each layer's full weights gathered inside its
    checkpointed call (:class:`_GatherShard`). ``mp`` splits each layer
    Megatron's way (:func:`decoder_layer`: NH and NKV must divide by mp,
    else ValueError), embeds by vocabulary slices
    (:func:`vocab_parallel_embed`) and takes the cross entropy over the
    vocabulary-sharded logits (:class:`_VocabParallelCE`);
    ``PADDLE_TPU_TORCH_TP_OVERLAP`` runs the FFN as the fused ring
    (:func:`_fused_ffn_overlap`). ``pp`` (JAX's ``_build_pp_train_step``,
    :class:`_PipeTrainStep`) gives each stage rank L/S layers (L % pp must
    be 0, else ValueError naming the config) and runs the collective
    schedule of ``parallel.pipeline`` over M = max(microbatches, pp)
    microbatches of the rank's rows (which M must divide), overlapped
    with ``overlap_p2p`` (or ``PADDLE_TPU_TORCH_PP_OVERLAP``); under pp
    embed, final_norm and lm_head are whole inside the step, the loss is
    the plain cross entropy on the last stage, and ZeRO stages 1 and 2
    shard no state (:func:`train_state_pspecs`). The params and state
    passed and returned are the rank's local shards (:func:`shard_train_state`,
    :func:`gather_train_state` with ``step_fn.hcg``); ``step_fn.layout``
    is the layout of ``{"params", "opt", "step"}`` with which the
    checkpoint layer saves them over the ranks and restores them under
    another layout (:func:`restore_train_step`). The JAX package
    runs one program over a mesh of global arrays; each difference that
    follows is listed in ROADMAP.md's deviations.

    Under the default ``PADDLE_TPU_TORCH_FLASH_BWD`` (``auto``), the fused
    flash backward sums dQ by bulk reduce-adds in an order that varies
    between runs on the card, so two runs from the same state differ in
    the last bits and a resumed run is close to, not bitwise, the one it
    resumes; ``split`` sums in a fixed order and resumes bitwise. The dp
    replicas stay bitwise equal under either (their gradients are
    all-reduced)."""
    check_ported(parallel)
    check_mp_heads(config, parallel)
    dev = resolve_device(device)
    if parallel.total > 1:
        return _build_dist_train_step(config, parallel, lr, seed, dev)
    params = init_llama_params(config, seed, device=dev)
    opt_state = _adamw_init(params)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def step_fn(p, opt, ids, labels):
        loss, grads = llama_loss_and_grads(p, to_dev(ids), to_dev(labels),
                                           config, parallel)
        p, opt = _adamw_update(p, grads, opt, lr)
        return p, opt, loss

    return step_fn, params, opt_state


def check_mp_heads(config: LlamaConfig, parallel: ParallelConfig) -> None:
    """Raise ValueError, naming the config, unless the attention and KV
    heads divide over mp: a rank holds whole heads. JAX's GSPMD splits
    the k/v columns through a head instead (ROADMAP.md, deviations)."""
    c, mp = config, parallel.mp
    if mp > 1 and (c.num_attention_heads % mp or
                   c.num_key_value_heads % mp):
        raise ValueError(
            f"mp={mp} needs num_attention_heads "
            f"({c.num_attention_heads}) and num_key_value_heads "
            f"({c.num_key_value_heads}) to divide by it; config {c}")


def _build_dist_train_step(config, parallel, lr, seed, dev):
    """The branch of :func:`build_train_step` over ranks: every rank
    makes the full seeded params, keeps its shards and makes zero moments
    in its local shapes only."""
    check_pp_layers(config, parallel)
    hcg = _hcg(parallel)
    full = stage_layers(init_llama_params(config, seed, device=dev), config,
                        parallel)
    params, _ = shard_train_state(full, None, config, parallel)
    step = (_PipeTrainStep if parallel.pp > 1 else _DistTrainStep)(
        config, parallel, lr, hcg, dev)

    def zeros(x, spec, name):
        return torch.zeros(_local_shape(name, x.shape, spec, step.degrees,
                                        step.coord),
                           dtype=torch.float32, device=dev)
    opt_state = {"m": _map_specs(zeros, full, step.ospecs),
                 "v": _map_specs(zeros, full, step.ospecs),
                 "t": torch.zeros((), dtype=torch.float32, device=dev)}
    return step, params, opt_state


def restore_train_step(config: LlamaConfig, parallel: ParallelConfig,
                       manager, step: Optional[int] = None,
                       lr: float = 3e-4, seed: int = 0, device=None):
    """Elastic resume, the port's counterpart of the JAX package's
    preemption-resume flow: a fresh :func:`build_train_step` (every rank
    of ``parallel`` calls this, as it calls that) whose state
    ``{"params", "opt", "step"}`` is filled from checkpoint ``step`` of
    ``manager`` (a ``CheckpointManager``; None: its newest complete,
    checksum-valid step), whatever ``ParallelConfig`` and world size
    wrote it: each rank reads only its slice of each saved leaf under
    ``step_fn.layout`` (one process reads whole leaves). Returns
    (step_fn, state, the restored step); training goes on with
    ``step_fn(state["params"], state["opt"], ids, labels)``."""
    step_fn, params, opt = build_train_step(config, parallel, lr=lr,
                                            seed=seed, device=device)
    state = {"params": params, "opt": opt, "step": 0}
    got = manager.restore(state, step=step,
                          layout=getattr(step_fn, "layout", None))
    state["step"] = got
    return step_fn, state, got


def count_params(config: LlamaConfig) -> int:
    c = config
    per_layer = (c.hidden_size * (c.num_attention_heads +
                                  2 * c.num_key_value_heads) * c.head_dim
                 + c.num_attention_heads * c.head_dim * c.hidden_size
                 + 3 * c.hidden_size * c.intermediate_size
                 + 2 * c.hidden_size)
    total = c.num_hidden_layers * per_layer + c.vocab_size * c.hidden_size \
        + c.hidden_size
    if not c.tie_word_embeddings:
        total += c.hidden_size * c.vocab_size
    return total


def train_flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """~6N + attention flops per token (fwd+bwd), for MFU accounting."""
    n = count_params(config)
    attn = 12 * config.num_hidden_layers * config.hidden_size * seq_len
    return 6.0 * n + attn
