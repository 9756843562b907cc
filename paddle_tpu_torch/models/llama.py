"""Llama for the paged serving path and the single-GPU train step (port
of ``paddle_tpu/models/llama.py``).

Parameters are a plain dict with every decoder layer STACKED on a leading
axis, the JAX package's layout and names, so weights (and AdamW state)
move between the two through numpy (:func:`params_from_numpy`). The paged
decode step and prefill chunk mirror ``llama_paged_decode_step`` /
``llama_paged_prefill_chunk`` op for op with plain weights only: RMSNorm
and the fused paged-attention update are this package's CUDA kernels,
matrix products are ``torch.matmul`` (XLA's own in JAX), RoPE and the
prefill attention are plain PyTorch (plain XLA in JAX).

The train step (:func:`build_train_step`) mirrors the JAX one at
parallel = 1: ``llama_loss`` (flash attention, RMSNorm with its gradient,
dense f32 cross entropy) differentiated by autograd, then AdamW. The layer
loop replaces ``lax.scan``; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (``jax.checkpoint`` with no policy).

The KV pools are updated IN PLACE (the JAX package donates them); the
step functions still return them, so call sites read the same. The train
step likewise updates params and AdamW state in place and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.flash_attention import flash_attention_bshd
from ..ops.paged_attention import LOG2E, paged_attend_update
from ..ops.rms_norm import fused_rms_norm
from ..ops.rope import apply_rope, build_rope_cache


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
    ``device`` (default: the card). Plain weights only. Any nested dict of
    arrays goes across the same way, so the JAX AdamW state
    ``{"m": tree, "v": tree, "t": 0-d f32}`` does too."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree).to(dev)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _mat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for plain weights (the JAX ``_mat``'s int8 and transposed
    forms are not ported)."""
    return torch.matmul(x, w)


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
    return _swiglu(x, p["gate_proj"][layer], p["up_proj"][layer],
                   p["down_proj"][layer])


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
