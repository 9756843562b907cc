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
/ ``llama_paged_prefill_chunk`` op for op. Generation (:func:`generate`:
greedy, sampling, beam search) mirrors the JAX entry points over the
stacked KV cache of :func:`init_kv_cache`: the slab ``[L, B, KV*HD, T]``
below head_dim 128, through the fused slab attend+update kernel, and the
head-major ``[L, B, KV, T, HD]`` with plain grouped einsums above. The
token loop runs eagerly (``lax.scan`` in JAX) and keeps every token on
the device until one copy at the end.

The train step (:func:`build_train_step`) mirrors the JAX one at
parallel = 1: ``llama_loss`` (flash attention, RMSNorm with its gradient,
dense f32 cross entropy) differentiated by autograd, then AdamW. The layer
loop replaces ``lax.scan``; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (``jax.checkpoint`` with no policy).

The KV pools and caches are updated IN PLACE (the JAX package donates
them); the step functions still return them, so call sites read the same.
The train step likewise updates params and AdamW state in place and
returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.decode_attention import TILE_T, decode_attend_update_slab
from ..ops.flash_attention import flash_attention_bshd
from ..ops.paged_attention import LOG2E, paged_attend_update
from ..ops.rms_norm import fused_rms_norm
from ..nn.functional.attention import _xla_sdpa
from ..ops.rope import apply_rope, build_rope_cache
from ..parallel.moe import _top_k


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


def llama_logits(params, h: torch.Tensor, config: LlamaConfig
                 ) -> torch.Tensor:
    x = fused_rms_norm(h, params["final_norm"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        return x @ params["embed"].T
    return _mat(x, params["lm_head"])


def init_paged_kv_pool(config: LlamaConfig, num_blocks: int,
                       block_size: int, kv_dtype: str = "auto",
                       device=None):
    """Paged KV pools k and v [L, num_blocks, KV*HD, block_size] in the
    model dtype, zeroed, on ``device`` (default: the card). Block 0 is the
    reserved null block. Only ``kv_dtype='auto'`` is ported."""
    if kv_dtype != "auto":
        raise ValueError(f"kv_dtype {kv_dtype!r} is not ported; only "
                         f"'auto' (the model dtype)")
    c = config
    dev = resolve_device(device)
    shape = (c.num_hidden_layers, num_blocks,
             c.num_key_value_heads * c.head_dim, block_size)
    return (torch.zeros(shape, dtype=c.dtype, device=dev),
            torch.zeros(shape, dtype=c.dtype, device=dev))


def _heads(layers, hd):
    nh = layers["q_proj"].shape[-1] // hd
    nkv = layers["k_proj"].shape[-1] // hd
    return nh, nkv


def _swiglu(x, gate, up, down):
    return _mat(F.silu(_mat(x, gate)) * _mat(x, up), down)


def _mlp(p, layer, x):
    return _swiglu(x, _at(p["gate_proj"], layer), _at(p["up_proj"], layer),
                   _at(p["down_proj"], layer))


@torch.no_grad()
def llama_paged_decode_step(params, k_pool, v_pool, tables, positions, ids,
                            config: LlamaConfig):
    """One decode step over a PAGED cache: ids [B] i32, tables [B, max_nb]
    i32, positions [B] i32 = the slot each row's new token occupies (its
    block must already be in the table). Padding rows point their tables
    at null block 0 with position 0. Returns (logits [B, vocab] f32,
    k_pool, v_pool); the pools are written in place."""
    c = config
    b = ids.shape[0]
    hd = c.head_dim
    p = params["layers"]
    nh, nkv = _heads(p, hd)
    kvd = nkv * hd
    h = params["embed"][ids.long()].to(c.dtype)                  # [B, H]
    cos, sin = build_rope_cache(b, hd, base=c.rope_theta,
                                position_ids=positions[:, None])  # [B,1,·]
    scale = LOG2E / (hd ** 0.5)
    for layer in range(k_pool.shape[0]):
        x = fused_rms_norm(h[:, None], p["input_norm"][layer], c.rms_norm_eps)
        q = _mat(x, p["q_proj"][layer]).reshape(b, 1, nh, hd)
        k = _mat(x, p["k_proj"][layer]).reshape(b, 1, nkv, hd)
        v = _mat(x, p["v_proj"][layer]).reshape(b, 1, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # q pre-scaled into the log2 domain: f32 multiply, then back to
        # the model dtype, as the JAX step rounds it
        qs = (q[:, 0].float() * scale).to(q.dtype)
        attn = paged_attend_update(
            qs, k.reshape(b, kvd).to(k_pool.dtype),
            v.reshape(b, kvd).to(v_pool.dtype), k_pool, v_pool, tables,
            positions, layer)
        h = h + _mat(attn.to(c.dtype).reshape(b, nh * hd),
                     p["o_proj"][layer])
        x2 = fused_rms_norm(h[:, None], p["post_norm"][layer],
                            c.rms_norm_eps)[:, 0]
        h = h + _mlp(p, layer, x2)
    logits = llama_logits(params, h[:, None], config)[:, 0]
    return logits.float(), k_pool, v_pool


@torch.no_grad()
def llama_paged_prefill_chunk(params, k_pool, v_pool, table_row, start: int,
                              ids, n_live: int, config: LlamaConfig):
    """One chunked-prefill slice for ONE sequence: ids [C] i32 padded to
    the chunk bucket, ``n_live`` real tokens, ``start`` tokens already
    cached. Scatters the chunk's KV into the sequence's blocks (padding
    tokens land in null block 0), attends each chunk token over cached
    prefix + chunk causally through a gathered context in plain PyTorch,
    and returns (logits of the LAST REAL token [vocab] f32, k_pool,
    v_pool); the pools are written in place."""
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
    h = params["embed"][ids.long()][None].to(c.dtype)            # [1, C, H]
    pidx = start + torch.arange(C, dtype=torch.int32, device=dev)
    cos, sin = build_rope_cache(C, hd, base=c.rope_theta, position_ids=pidx)
    live = torch.arange(C, device=dev) < n_live
    bid = torch.where(live, table_row[(pidx // bs).clamp(0, max_nb - 1).long()],
                      0).long()
    col = (pidx % bs).long()
    rows = table_row.long()
    causal = (torch.arange(T, device=dev)[None, :]
              <= pidx[:, None])[:, None, None, :]               # [C,1,1,T]
    for layer in range(k_pool.shape[0]):
        x = fused_rms_norm(h, p["input_norm"][layer], c.rms_norm_eps)
        q = _mat(x, p["q_proj"][layer]).reshape(1, C, nh, hd)
        k = _mat(x, p["k_proj"][layer]).reshape(1, C, nkv, hd)
        v = _mat(x, p["v_proj"][layer]).reshape(1, C, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # advanced indices (bid, col) split by a slice put C first: the
        # target is [C, KVD], one column per chunk token
        k_pool[layer, bid, :, col] = k.reshape(C, kvd).to(k_pool.dtype)
        v_pool[layer, bid, :, col] = v.reshape(C, kvd).to(v_pool.dtype)
        # the sequence's context (prefix + this chunk) as one slab; dead
        # table slots read null-block garbage that the causal mask kills
        kg = k_pool[layer][rows].permute(1, 0, 2).reshape(nkv, hd, T)
        vg = v_pool[layer][rows].permute(1, 0, 2).reshape(nkv, hd, T)
        qg = q[0].reshape(C, nkv, rep, hd)
        s = torch.einsum("cgrd,gdt->cgrt", qg.float(), kg.float()) \
            / (hd ** 0.5)
        s = torch.where(causal, s, torch.tensor(-1e30, device=dev))
        probs = torch.softmax(s, dim=-1).to(vg.dtype)
        attn = torch.einsum("cgrt,gdt->cgrd", probs.float(),
                            vg.float()).to(c.dtype)
        h = h + _mat(attn.reshape(1, C, nh * hd), p["o_proj"][layer])
        x2 = fused_rms_norm(h, p["post_norm"][layer], c.rms_norm_eps)
        h = h + _mlp(p, layer, x2)
    h_last = h[0, n_live - 1:n_live][None]
    logits = llama_logits(params, h_last, config)[0, 0]
    return logits.float(), k_pool, v_pool


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
    runs only the single-device path and raises for the rest (see
    :func:`check_ported`)."""
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
    use_flash: Optional[bool] = None   # None = auto: the flash kernels
    overlap_p2p: Optional[bool] = None

    @property
    def total(self):
        return self.dp * self.mp * self.pp * self.sharding * self.sep


_UNREAD_FIELDS = ("sep_strategy", "microbatches", "scan_unroll", "zero_stage",
                  "overlap_p2p")


def check_ported(parallel: ParallelConfig) -> None:
    """Raise ValueError naming what of ``parallel`` the port does not run
    yet: any degree above 1 (pp first), ``use_flash=False`` (the JAX
    ``_xla_sdpa`` path), remat policies other than ``'full'``, and a value
    other than the default in a field the single-device step never reads
    (``_UNREAD_FIELDS``)."""
    default = ParallelConfig()
    unread = {f: getattr(parallel, f) for f in _UNREAD_FIELDS
              if getattr(parallel, f) != getattr(default, f)}
    if unread:
        raise ValueError(f"{unread}: the single-device train step does not "
                         f"read these fields; leave them at their defaults")
    if parallel.pp > 1:
        raise ValueError(f"pp={parallel.pp}: the pipeline train step is not "
                         f"ported; use pp=1")
    if parallel.total > 1:
        degrees = {k: getattr(parallel, k)
                   for k in ("dp", "mp", "sharding", "sep")
                   if getattr(parallel, k) > 1}
        raise ValueError(f"{degrees}: multi-device training (total "
                         f"{parallel.total}) is not ported; only total=1")
    if parallel.use_flash is False:
        raise ValueError("use_flash=False (the plain-XLA attention path) is "
                         "not ported; the train step runs the flash kernels")
    if parallel.remat and parallel.remat_policy != "full":
        raise ValueError(f"remat_policy {parallel.remat_policy!r} is not "
                         f"ported; only 'full' (or remat=False)")


def decoder_layer(p, h_in, cos, sin, config: LlamaConfig):
    """One decoder block for training (the JAX ``decoder_layer`` at mp = 1,
    sep = 1). ``p`` holds ONE layer's weights; h_in [B, S, H]."""
    c = config
    b, s, _ = h_in.shape
    hd = c.head_dim
    nh = p["q_proj"].shape[-1] // hd
    nkv = p["k_proj"].shape[-1] // hd
    x = fused_rms_norm(h_in, p["input_norm"], c.rms_norm_eps)
    q = _mat(x, p["q_proj"]).reshape(b, s, nh, hd)
    k = _mat(x, p["k_proj"]).reshape(b, s, nkv, hd)
    v = _mat(x, p["v_proj"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = flash_attention_bshd(q, k, v, causal=True).reshape(b, s, nh * hd)
    h = h_in + _mat(attn, p["o_proj"])
    x = fused_rms_norm(h, p["post_norm"], c.rms_norm_eps)
    return h + _swiglu(x, p["gate_proj"], p["up_proj"], p["down_proj"])


def llama_hidden(params, ids, config: LlamaConfig,
                 parallel: ParallelConfig = ParallelConfig()):
    """Embed + the decoder stack; returns the final hidden (pre-norm).
    ``params["layers"]`` maps each name to a stacked [L, ...] tensor or to
    a list of its L layer slices (the train step's gradient leaves). With
    ``parallel.remat`` each layer is recomputed in the backward and only
    its input is kept."""
    c = config
    h = F.embedding(ids.long(), params["embed"]).to(c.dtype)
    cos, sin = build_rope_cache(ids.shape[1], c.head_dim, base=c.rope_theta,
                                device=h.device)
    layers = params["layers"]
    for i in range(len(layers["q_proj"])):
        p = {name: w[i] for name, w in layers.items()}
        if parallel.remat:
            h = checkpoint(decoder_layer, p, h, cos, sin, c,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = decoder_layer(p, h, cos, sin, c)
    return h


def masked_ce_loss(logits, labels):
    """Mean cross entropy over labels != -100 (f32 logits [..., V])."""
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    loss_sum = torch.where(mask, -picked, 0.0).sum()
    return loss_sum / torch.clamp(mask.sum(), min=1)


def llama_loss(params, ids, labels, config: LlamaConfig,
               parallel: ParallelConfig = ParallelConfig()):
    """Causal LM loss with dense f32 logits; labels [B, S], -100 ignored."""
    h = llama_hidden(params, ids, config, parallel)
    logits = llama_logits(params, h, config).float()
    return masked_ce_loss(logits, labels)


def _grad_leaf(t):
    return t.detach().requires_grad_()


def llama_loss_and_grads(params, ids, labels, config: LlamaConfig,
                         parallel: ParallelConfig = ParallelConfig()):
    """(loss, grads) of :func:`llama_loss`, the counterpart of
    ``jax.value_and_grad``. ``grads`` mirrors ``params``, except that the
    gradient of a stacked layer leaf is a LIST of its L per-layer slices:
    each layer's weights enter autograd as views of the stacked tensor, so
    no [L, ...] gradient (and no per-layer scatter into one) is ever
    made."""
    leaves = {k: ({n: [_grad_leaf(w[i]) for i in range(w.shape[0])]
                   for n, w in v.items()} if k == "layers" else _grad_leaf(v))
              for k, v in params.items()}
    loss = llama_loss(leaves, ids, labels, config, parallel)
    loss.backward()

    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)

    grads = {k: ({n: [grad(t) for t in ts] for n, ts in v.items()}
                 if k == "layers" else grad(v))
             for k, v in leaves.items()}
    return loss.detach(), grads


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


def build_train_step(config: LlamaConfig,
                     parallel: ParallelConfig = ParallelConfig(),
                     lr: float = 3e-4, seed: int = 0, device=None):
    """Returns (step_fn, params, opt_state), as the JAX ``build_train_step``
    at parallel = 1. ``step_fn(params, opt, ids, labels) -> (params, opt,
    loss)``: ids and labels are [B, S] int32 host arrays copied to the
    device; loss is a 0-d f32 tensor on the device. Params and AdamW state
    (f32 moments) are updated in place. ``device=None`` means the card;
    what is not ported raises ValueError (:func:`check_ported`)."""
    check_ported(parallel)
    dev = resolve_device(device)
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
