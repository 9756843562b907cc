"""ERNIE-style MoE transformer and its single-GPU train step (port of
``paddle_tpu/models/ernie_moe.py``).

Parameters are a plain dict in the JAX package's layout and names. The
every-other-layer model (``moe_every`` 2, an even layer count) keeps
SPLIT stacks, ``layers["dense"]`` (attention plus a dense FFN) and
``layers["moe"]`` (attention plus router ``gate`` (f32), experts
``e_w1``/``e_w2`` and the optional shared expert ``s_w1``/``s_w2``), each
stacked [L/2, ...]; any other model one stack of every weight over all L
layers (a dense layer carries expert weights it never uses, as in JAX).
Weights and AdamW state move between the two packages through numpy with
:func:`..models.llama.params_from_numpy`.

The train step mirrors the JAX ``build_train_step``: each
layer RMSNorm (CUDA kernel) -> fused qkv -> flash attention (CUDA
kernels, D = head_dim, causal) -> o -> residual -> RMSNorm -> FFN, where
layer i is MoE when i % moe_every == moe_every - 1. The MoE FFN runs
:func:`..parallel.moe.moe_dispatch_combine`: the capacity slot schedule
(the JAX default), or the dropless "ragged" path ("ragged_a2a" becomes
"ragged" without a mesh), whose grouped matmuls are CUDA kernels.
``jax.nn.gelu`` is the tanh approximation, so every gelu here is too. On
the split stacks the JAX step recomputes each layer pair in its backward
keeping matmul outputs (which changes no value); the port keeps every
activation instead (a few GB at ``ernie_moe_fine``, B = 8, S = 512). The
non-split stack recomputes each layer in the backward, as JAX's
``jax.checkpoint`` there does.

Over ranks (``ep_degree`` x ``dp_degree`` processes, one a rank, joined by
``init_parallel_env``): JAX's mesh is ``devs.reshape(dp, ep)`` with axes
("dp", "ep"), so rank d * ep + e sits at (d, e); :class:`MoeMesh` makes
a dp group (a line over dp at each ep coordinate) and an ep group (a
line over ep at each dp coordinate). Each rank holds E/ep experts of
``e_w1``/``e_w2`` (dim 1 of [L, E, ...]) and every other weight whole
(:func:`param_pspecs`, :func:`shard_train_state`,
:func:`gather_train_state`), and takes its dp rows of the global batch.
At ep 1 the MoE layer routes the global token set as JAX's serial path
does (``parallel.moe.moe_dispatch_combine(dp=)``); above ep 1 it runs
JAX's island: :func:`..parallel.moe.moe_slot_dispatch_local`,
``moe_ragged_dispatch_local`` or ``moe_ragged_dispatch_a2a`` over the ep
group, capacity from the dp-local tokens, aux averaged over dp (over dp
and ep under ``ragged_a2a``, whose tokens are split over ep and gathered
back), stats counts summed and ratios averaged over dp. The loss is the
per-token LM loss over the global count of labels, and every gradient is
summed over dp (never over ep: an ep rank's gradient of a weight it
shares is already whole, see ``parallel.moe``).

Refused (ValueError): a ``mesh`` (the degrees define the layout), an
ep_degree that does not divide num_experts, a batch that dp does not
divide and, under ``ragged_a2a``, a token count that dp x ep does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..distributed import communication as comm
from ..distributed.fleet.topology import CommunicateTopology
from ..ops.flash_attention import flash_attention_bshd
from ..ops.rms_norm import fused_rms_norm
from ..parallel.collective_matmul import (copy_to_mp, gather_from_mp,
                                          reduce_from_mp)
from ..parallel.moe import (RATIO_STAT_KEYS, default_dispatch_mode, gelu,
                            mean_over, moe_dispatch_combine,
                            moe_ragged_dispatch_a2a,
                            moe_ragged_dispatch_local,
                            moe_slot_dispatch_local, split_rows,
                            zero_routing_stats)
from .llama import _adamw_init, _adamw_update, _ce_sum_count, masked_ce_loss


@dataclasses.dataclass
class ErnieMoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_experts: int = 8
    moe_topk: int = 2
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 2           # every k-th layer is MoE
    aux_loss_weight: float = 0.01
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # "capacity" (the slot schedule), "ragged" (dropless) or "ragged_a2a"
    # (at ep = 1 the ragged path). None: the step's argument, else
    # PADDLE_TPU_TORCH_MOE_DROPLESS (unset: "capacity"), as in JAX
    dispatch_mode: Optional[str] = None

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def ernie_moe_tiny():
    return ErnieMoEConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=4, num_attention_heads=4,
                          num_experts=4, max_position_embeddings=128,
                          dtype=torch.float32)


def ernie_moe_fine():
    """Fine-grained preset: E = 32 small experts (I = H/2), top-4, one
    shared expert, hidden 1024, 16 heads (head_dim 64), 8 layers."""
    return ErnieMoEConfig(vocab_size=8192, hidden_size=1024,
                          intermediate_size=512, num_hidden_layers=8,
                          num_attention_heads=16, num_experts=32,
                          moe_topk=4, num_shared_experts=1,
                          max_position_embeddings=1024,
                          dtype=torch.bfloat16, dispatch_mode="ragged_a2a")


def ernie_moe_fine_tiny():
    """CPU-sized ernie_moe_fine (same shape family)."""
    return ErnieMoEConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=32, num_hidden_layers=4,
                          num_attention_heads=4, num_experts=8, moe_topk=2,
                          num_shared_experts=1, max_position_embeddings=128,
                          dtype=torch.float32, dispatch_mode="ragged_a2a")


def _split_stacks(config):
    """The split dense/moe layer stacks of the every-other-layer layout."""
    return config.moe_every == 2 and config.num_hidden_layers % 2 == 0


DISPATCH_MODES = ("capacity", "ragged", "ragged_a2a")


def param_pspecs(config, ep_degree: int, dp_degree: int = 1):
    """JAX's ``param_pspecs``: each leaf's split as a tuple, one entry a
    dimension, "ep" where the leaf is split over ep (``e_w1`` and
    ``e_w2``'s expert dimension at ep above 1), else None. dp splits no
    weight."""
    ep = "ep" if ep_degree > 1 else None
    attn = {"ln1": (None, None), "qkv": (None, None, None),
            "o": (None, None, None), "ln2": (None, None)}
    dense = {"w1": (None, None, None), "w2": (None, None, None)}
    moe = {"gate": (None, None, None), "e_w1": (None, ep, None, None),
           "e_w2": (None, ep, None, None)}
    if config.num_shared_experts:
        moe["s_w1"] = (None, None, None)
        moe["s_w2"] = (None, None, None)
    if _split_stacks(config):
        layers = {"dense": {**attn, **dense}, "moe": {**attn, **moe}}
    else:
        layers = {**attn, **dense, **moe}
    return {"embed": (None, None), "pos": (None, None), "layers": layers,
            "final_ln": (None,)}


class MoeMesh:
    """The (dp, ep) rank mesh of ERNIE's step over ranks, JAX's
    ``devs.reshape(dp, ep)``: rank d * ep + e sits at ``coord`` (d, e).
    ``dp`` and ``ep`` are this rank's groups (a line of ranks along the
    axis; ``new_group`` is collective, so every rank makes every line's
    group, dp's lines first), ``world`` all dp x ep ranks. Needs the
    process group of ``init_parallel_env`` over exactly dp x ep ranks."""

    def __init__(self, ep_degree: int, dp_degree: int):
        total = ep_degree * dp_degree
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"ep_degree={ep_degree} x dp_degree={dp_degree} needs a "
                f"process group: call paddle_tpu_torch.distributed."
                f"init_parallel_env first, one process per rank")
        if dist.get_world_size() != total:
            raise ValueError(
                f"ep_degree={ep_degree} x dp_degree={dp_degree} needs a "
                f"world of {total} processes; init_parallel_env made "
                f"{dist.get_world_size()}")
        topo = CommunicateTopology(["dp", "ep"], [dp_degree, ep_degree])
        rank = self.rank = dist.get_rank()
        self.coord = topo.get_coord(rank)
        groups = {}
        for axis, degree in (("dp", dp_degree), ("ep", ep_degree)):
            mine = comm.Group(axis, 1, 0, [rank])
            if degree > 1:
                for ranks in topo.get_comm_list(axis):
                    pg = dist.new_group(ranks)
                    if rank in ranks:
                        mine = comm.Group(axis, degree, ranks.index(rank),
                                          ranks, pg)
            groups[axis] = mine
        self.dp, self.ep = groups["dp"], groups["ep"]
        self.world = comm.Group("dp,ep", total, rank, list(range(total)),
                                dist.group.WORLD)


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_train_state(params, opt_state, config: ErnieMoEConfig,
                      mesh: MoeMesh):
    """This rank's shards of full trees (``params`` and ``opt_state``'s m
    and v; None passes through): ``e_w1``/``e_w2`` sliced on their expert
    dimension by the rank's ep coordinate (contiguous copies), every other
    leaf and ``t`` the caller's tensor. Returns (params, opt_state)."""
    ep = mesh.ep
    specs = param_pspecs(config, ep.nranks, mesh.dp.nranks)

    def cut(x, spec):
        for d, axis in enumerate(spec):
            if axis == "ep":
                n = x.shape[d] // ep.nranks
                x = x.narrow(d, ep.rank * n, n).contiguous()
        return x
    if opt_state is not None:
        opt_state = {"m": _map_specs(cut, opt_state["m"], specs),
                     "v": _map_specs(cut, opt_state["v"], specs),
                     "t": opt_state["t"]}
    return _map_specs(cut, params, specs), opt_state


def gather_train_state(params, opt_state, config: ErnieMoEConfig,
                       mesh: MoeMesh):
    """The full trees from every rank's shards (a collective over ep: every
    rank calls it), the inverse of :func:`shard_train_state`."""
    specs = param_pspecs(config, mesh.ep.nranks, mesh.dp.nranks)

    def whole(x, spec):
        for d, axis in enumerate(spec):
            if axis == "ep":
                x = comm.all_gather(x, d, mesh.ep)
        return x
    if opt_state is not None:
        opt_state = {"m": _map_specs(whole, opt_state["m"], specs),
                     "v": _map_specs(whole, opt_state["v"], specs),
                     "t": opt_state["t"]}
    return _map_specs(whole, params, specs), opt_state


def resolve_dispatch_mode(config, dispatch_mode=None):
    """The dispatch mode a step runs, as the JAX ``build_train_step``
    picks it: the step's argument, else the config's, else
    :func:`..parallel.moe.default_dispatch_mode`."""
    if dispatch_mode is None:
        dispatch_mode = config.dispatch_mode
    if dispatch_mode is None:
        dispatch_mode = default_dispatch_mode()
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r} "
                         f"(expected one of {DISPATCH_MODES})")
    return dispatch_mode


def init_params(config: ErnieMoEConfig, seed: int = 0, device=None):
    """Random params N(0, 0.02) in the model dtype (the router ``gate`` in
    f32), made on ``device`` (default: the card) from a seeded
    ``torch.Generator``. Same layout (split or not) and names as the JAX
    package; the values differ from its ``jax.random`` stream."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    split = _split_stacks(c)
    n = c.num_hidden_layers // 2 if split else c.num_hidden_layers
    H, I, E = c.hidden_size, c.intermediate_size, c.num_experts

    def rnd(shape, dtype=c.dtype):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, 0.02, generator=gen)

    def ones(shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    def attn_block():
        return {"ln1": ones((n, H)), "qkv": rnd((n, H, 3 * H)),
                "o": rnd((n, H, H)), "ln2": ones((n, H))}

    def dense_ffn():
        return {"w1": rnd((n, H, I)), "w2": rnd((n, I, H))}

    def experts():
        w = {"gate": rnd((n, H, E), torch.float32),
             "e_w1": rnd((n, E, H, I)), "e_w2": rnd((n, E, I, H))}
        if c.num_shared_experts:
            si = c.num_shared_experts * I
            w.update(s_w1=rnd((n, H, si)), s_w2=rnd((n, si, H)))
        return w

    if split:
        layers = {"dense": {**attn_block(), **dense_ffn()},
                  "moe": {**attn_block(), **experts()}}
    else:
        layers = {**attn_block(), **dense_ffn(), **experts()}
    return {
        "embed": rnd((c.vocab_size, H)),
        "pos": rnd((c.max_position_embeddings, H)),
        "layers": layers,
        "final_ln": ones((H,)),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_and_norm(p, h, config: ErnieMoEConfig):
    """RMSNorm -> qkv -> causal flash attention -> o -> residual; returns
    (h, RMSNorm(h)). ``p`` holds ONE layer's weights."""
    c = config
    b, s, hid = h.shape
    nh, hd = c.num_attention_heads, c.head_dim
    x = fused_rms_norm(h, p["ln1"], c.layer_norm_eps)
    qkv = (x @ p["qkv"]).reshape(b, s, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = flash_attention_bshd(q, k, v, causal=True)
    h = h + attn.reshape(b, s, hid) @ p["o"]
    return h, fused_rms_norm(h, p["ln2"], c.layer_norm_eps)


def _ep_island(p, tokens, config: ErnieMoEConfig, with_stats, dispatch_mode,
               mesh: MoeMesh):
    """JAX's (dp, ep) island of ``_moe_ffn``: tokens [T, H] this dp
    shard's (the same on every ep rank). Under ``ragged_a2a`` rank e takes
    block e of them (:func:`..parallel.moe.split_rows`: block d*ep+e of
    the global tokens), routes it through a router whose gradient is
    summed over ep (``copy_to_mp``), and the outputs are gathered back
    over ep; aux is averaged over dp and ep. Otherwise every ep rank
    routes all T tokens and aux is averaged over dp. Returns (out, aux,
    stats or None); the stats are per dp shard."""
    c = config
    ep = mesh.ep
    kw = dict(k=c.moe_topk, return_stats=with_stats)
    if dispatch_mode == "ragged_a2a":
        tok = split_rows(tokens, ep)
        logits = tok.float() @ copy_to_mp(p["gate"], ep)
        res = moe_ragged_dispatch_a2a(tok, logits, p["e_w1"], p["e_w2"],
                                      c.num_experts, ep, **kw)
        out = gather_from_mp(res[0], 0, ep)
        aux = mean_over(res[1], mesh.world)
    else:
        logits = tokens.float() @ p["gate"]
        if dispatch_mode == "ragged":
            res = moe_ragged_dispatch_local(tokens, logits, p["e_w1"],
                                            p["e_w2"], c.num_experts, ep,
                                            **kw)
        else:
            res = moe_slot_dispatch_local(
                tokens, logits, p["e_w1"], p["e_w2"], c.num_experts, ep,
                capacity_factor=c.capacity_factor, **kw)
        out, aux = res[0], mean_over(res[1], mesh.dp)
    return out, aux, (res[2] if with_stats else None)


def _moe_ffn(p, x_, config: ErnieMoEConfig, with_stats=False,
             dispatch_mode="capacity", mesh=None):
    """JAX's ``_moe_ffn``: router in f32 and the serial dispatch
    (``"ragged_a2a"`` runs the ragged path and reports zero wire rows),
    over the global token set at dp above 1; above ep 1 the island
    (:func:`_ep_island`); then the shared expert."""
    c = config
    hid = x_.shape[-1]
    tokens = x_.reshape(-1, hid)
    if mesh is not None and mesh.ep.nranks > 1:
        out, aux, stats = _ep_island(p, tokens, c, with_stats,
                                     dispatch_mode, mesh)
    else:
        logits = tokens.float() @ p["gate"]
        serial_mode = ("ragged" if dispatch_mode == "ragged_a2a"
                       else dispatch_mode)
        res = moe_dispatch_combine(tokens, logits, p["e_w1"], p["e_w2"],
                                   c.num_experts, k=c.moe_topk,
                                   capacity_factor=c.capacity_factor,
                                   return_stats=with_stats,
                                   dispatch_mode=serial_mode,
                                   dp=None if mesh is None else mesh.dp)
        out, aux = res[0], res[1]
        stats = res[2] if with_stats else None
        if stats is not None and dispatch_mode == "ragged_a2a":
            z = torch.zeros((), device=x_.device)
            stats = {**stats, "moe_a2a_wire_rows": z,
                     "moe_a2a_buffer_rows": z}
    if c.num_shared_experts:
        shared = gelu(tokens @ p["s_w1"]) @ p["s_w2"]
        out = out + shared.to(out.dtype)
    out = out.reshape(x_.shape).to(x_.dtype)
    if with_stats:
        return out, aux.float(), stats
    return out, aux.float()


def _dense_ffn(p, x_, config: ErnieMoEConfig, with_stats=False,
               dispatch_mode="capacity"):
    """A dense layer's FFN; with ``with_stats`` the zero stats of the MoE
    layers' key set."""
    out = (gelu(x_ @ p["w1"]) @ p["w2"]).to(x_.dtype)
    z = torch.zeros((), device=x_.device)
    if with_stats:
        return out, z, zero_routing_stats(dispatch_mode, config.num_experts,
                                          x_.device)
    return out, z


def _layer_static(p, h, is_moe, config: ErnieMoEConfig, with_stats=False,
                  dispatch_mode="capacity", mesh=None):
    """One decoder layer with a static moe/dense choice: (h, aux) and,
    with ``with_stats``, its routing stats (zero for a dense layer)."""
    h, x = _attn_and_norm(p, h, config)
    res = (_moe_ffn(p, x, config, with_stats, dispatch_mode, mesh) if is_moe
           else _dense_ffn(p, x, config, with_stats, dispatch_mode))
    return (h + res[0],) + tuple(res[1:])


def _layer(p, h, layer_idx, config: ErnieMoEConfig, with_stats=False,
           dispatch_mode="capacity", mesh=None):
    """Layer ``layer_idx`` of the non-split stack: MoE when
    layer_idx % moe_every == moe_every - 1 (JAX's ``lax.cond`` on the
    scan counter; the index is static here)."""
    c = config
    is_moe = layer_idx % c.moe_every == c.moe_every - 1
    return _layer_static(p, h, is_moe, c, with_stats, dispatch_mode, mesh)


def _layer_params(stack, i):
    """Layer i's weights from a stack whose leaves are [n, ...] tensors or
    lists of per-layer slices (the train step's gradient leaves)."""
    return {name: w[i] for name, w in stack.items()}


def _stats_over_dp(st, dp):
    """Per-layer stats {key: [n, ...]} of each dp shard -> over the dp
    group: counts summed, ratio keys averaged (one all-reduce)."""
    keys = list(st)
    flat = comm.all_reduce(torch.cat([st[k].reshape(-1).float()
                                      for k in keys]), dp)
    out, i = {}, 0
    for k in keys:
        v = flat[i:i + st[k].numel()].reshape(st[k].shape)
        i += st[k].numel()
        out[k] = v / dp.nranks if k in RATIO_STAT_KEYS else v
    return out


def moe_loss(params, ids, labels, config: ErnieMoEConfig, with_stats=False,
             dispatch_mode="capacity", active_rows=False, mesh=None):
    """Total loss = LM cross entropy + aux_loss_weight x the summed gshard
    aux losses, as the JAX ``moe_loss`` at ep = 1; returns (total, aux)
    where aux is lm_loss, or (lm_loss, stats) with ``with_stats`` (counts
    summed over the layers, ratio keys averaged over those that routed),
    and with ``active_rows`` (total, (aux, rows [n, E])): the per-layer
    routed-row counts of a ragged mode (n MoE layers on split stacks, all
    L layers otherwise). The non-split stack recomputes each layer in the
    backward.

    ``mesh`` (a :class:`MoeMesh`): ids and labels are this rank's dp rows;
    the values returned are the global ones (the LM loss over the global
    count of labels, the stats of every dp shard) on every rank, and
    each rank's gradient is its own part, to be summed over dp."""
    c = config
    ws = with_stats or active_rows
    s = ids.shape[1]
    h = (params["embed"][ids.long()] + params["pos"][:s][None]).to(c.dtype)
    auxes, layer_stats = [], []
    if _split_stacks(c):
        dense, moe = params["layers"]["dense"], params["layers"]["moe"]
        for i in range(len(dense["qkv"])):
            h, aux0 = _layer_static(_layer_params(dense, i), h, False, c)
            res = _layer_static(_layer_params(moe, i), h, True, c, ws,
                                dispatch_mode, mesh)
            h, aux1 = res[0], res[1]
            auxes.append(aux0 + aux1)
            if ws:
                layer_stats.append(res[2])
    else:
        layers = params["layers"]
        for i in range(c.num_hidden_layers):
            res = checkpoint(_layer, _layer_params(layers, i), h, i, c, ws,
                             dispatch_mode, mesh, use_reentrant=False,
                             preserve_rng_state=False)
            h = res[0]
            auxes.append(res[1])
            if ws:
                layer_stats.append(res[2])
    stats = rows_pl = None
    if ws:
        if active_rows and "moe_expert_rows" not in layer_stats[0]:
            raise ValueError(
                "active_rows requires a dispatch mode whose stats carry "
                "moe_expert_rows (ragged / ragged_a2a), got "
                f"{dispatch_mode!r}")
        with torch.no_grad():
            st = {k: torch.stack([d[k] for d in layer_stats])
                  for k in layer_stats[0]}
            if mesh is not None and mesh.ep.nranks > 1 \
                    and mesh.dp.nranks > 1:
                st = _stats_over_dp(st, mesh.dp)
            rows_pl = st.get("moe_expert_rows")
            n_moe = torch.clamp(
                (st["moe_routed_tokens"] + st["moe_dropped_tokens"] > 0)
                .float().sum(), min=1.0)
            stats = {k: (v.sum(0) / n_moe if k in RATIO_STAT_KEYS
                         else v.sum(0)) for k, v in st.items()}
    x = fused_rms_norm(h, params["final_ln"], c.layer_norm_eps)
    logits = (x @ params["embed"].T).float()
    if mesh is None:
        lm_loss = masked_ce_loss(logits, labels)
    else:
        loss_sum, count = _ce_sum_count(logits, labels)
        count = comm.all_reduce(count, mesh.dp)
        lm_loss = reduce_from_mp(loss_sum / torch.clamp(count, min=1),
                                 mesh.dp)
    total = lm_loss + c.aux_loss_weight * torch.stack(auxes).sum()
    base = (lm_loss, stats) if with_stats else lm_loss
    if active_rows:
        return total, (base, rows_pl)
    return total, base


def _grad_leaf(t):
    return t.detach().requires_grad_()


def _leaves_of(tree):
    """The autograd leaves of a param tree: each stacked layer tensor as a
    list of per-layer views, so no [n, ...] gradient is ever built."""
    if isinstance(tree, dict):
        return {k: (_layer_leaves(v) if k == "layers" else _leaves_of(v))
                for k, v in tree.items()}
    return _grad_leaf(tree)


def _layer_leaves(tree):
    if isinstance(tree, dict):
        return {k: _layer_leaves(v) for k, v in tree.items()}
    return [_grad_leaf(w) for w in tree]


def _grads_of(leaves):
    if isinstance(leaves, dict):
        return {k: _grads_of(v) for k, v in leaves.items()}
    if isinstance(leaves, list):
        return [_grads_of(t) for t in leaves]
    return leaves.grad if leaves.grad is not None \
        else torch.zeros_like(leaves)


def moe_loss_and_grads(params, ids, labels, config: ErnieMoEConfig,
                       with_stats=False, dispatch_mode="ragged",
                       active_rows=False):
    """(total, aux, grads) of :func:`moe_loss`, the counterpart of
    ``jax.value_and_grad(has_aux=True)``; a stacked layer leaf's gradient
    is the list of its per-layer slices."""
    leaves = _leaves_of(params)
    total, aux = moe_loss(leaves, ids, labels, config, with_stats,
                          dispatch_mode, active_rows)
    total.backward()
    return total.detach(), _detach(aux), _grads_of(leaves)


def _detach(tree):
    if isinstance(tree, tuple):
        return tuple(_detach(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _none_like(tree):
    if isinstance(tree, dict):
        return {k: _none_like(v) for k, v in tree.items()}
    return None


def _expert_row_masks(params, rows_pl):
    """``_adamw_update(masks=)`` tree: experts that routed no row this step
    keep their params and moments bitwise (rows [n, E] > 0 over the
    leading dims of e_w1 / e_w2, split or not; a rank's E/ep columns of
    them over its shards); every other leaf is unmasked."""
    active = rows_pl > 0
    masks = _none_like(params)
    experts = masks["layers"].get("moe", masks["layers"])
    experts["e_w1"] = active
    experts["e_w2"] = active
    return masks


def build_train_step(config: ErnieMoEConfig, ep_degree: int = 1,
                     dp_degree: int = 1, mesh=None, lr: float = 3e-4,
                     seed: int = 0, with_stats: bool = False,
                     dispatch_mode: Optional[str] = None,
                     multi_precision: bool = True,
                     active_only_moments: bool = False, device=None):
    """Returns (step_fn, params, opt_state), as the JAX ``build_train_step``
    at ep = dp = 1. ``step_fn(params, opt, ids, labels) -> (params, opt,
    loss, aux)``: ids and labels are [B, S] int32 host arrays copied to
    the device; loss is the 0-d f32 total; aux is lm_loss, or with
    ``with_stats`` the dict ``{"lm_loss", **routing stats}``, all on the
    device. Params and AdamW state are updated in place.

    ``dispatch_mode`` None means ``config.dispatch_mode``, then
    ``PADDLE_TPU_TORCH_MOE_DROPLESS`` (unset: "capacity").
    ``multi_precision=False`` stores moments in each param's dtype;
    ``active_only_moments`` freezes the params and moments of experts
    that routed no token this step (a ragged mode). ``device=None`` means
    the card.

    ``ep_degree`` x ``dp_degree`` above 1: this process is one rank of a
    world of that many (``init_parallel_env``); params and opt_state are
    this rank's shards (:func:`shard_train_state` of the seeded full
    tree) and ``step_fn`` is a :class:`_MoeDistStep`, which takes the
    GLOBAL [B, S] batch on every rank and keeps its dp rows; ``loss`` and
    ``aux`` are the global values on every rank. ``mesh`` is refused
    (ValueError): the port has no JAX ``Mesh``, the degrees define the
    layout. So are degrees below 1 and an ep_degree that does not divide
    num_experts."""
    if mesh is not None:
        raise ValueError(f"mesh={mesh!r}: the port takes no JAX Mesh; "
                         f"ep_degree and dp_degree define the rank layout")
    if ep_degree < 1 or dp_degree < 1:
        raise ValueError(f"ep_degree={ep_degree}, dp_degree={dp_degree}: "
                         f"degrees must be at least 1")
    if config.num_experts % ep_degree:
        raise ValueError(f"ep_degree={ep_degree} does not divide "
                         f"num_experts={config.num_experts}")
    dispatch_mode = resolve_dispatch_mode(config, dispatch_mode)
    dev = resolve_device(device)
    params = init_params(config, seed, device=dev)
    if ep_degree * dp_degree > 1:
        mesh = MoeMesh(ep_degree, dp_degree)
        params, _ = shard_train_state(params, None, config, mesh)
        opt = _adamw_init(params, multi_precision=multi_precision)
        return _MoeDistStep(config, mesh, lr, with_stats, dispatch_mode,
                            active_only_moments, dev), params, opt
    opt = _adamw_init(params, multi_precision=multi_precision)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def step_fn(p, o, ids, labels):
        loss, aux, grads = moe_loss_and_grads(
            p, to_dev(ids), to_dev(labels), config, with_stats,
            dispatch_mode, active_only_moments)
        masks = None
        if active_only_moments:
            aux, rows_pl = aux
            masks = _expert_row_masks(p, rows_pl)
        p, o = _adamw_update(p, grads, o, lr, masks=masks)
        if with_stats:
            lm_loss, stats = aux
            return p, o, loss, {"lm_loss": lm_loss, **stats}
        return p, o, loss, aux

    return step_fn, params, opt


class _MoeDistStep:
    """``step_fn`` of :func:`build_train_step` over ep x dp ranks: takes
    the global batch, keeps this rank's dp rows (:meth:`local_batch`),
    sums every gradient over dp and gives the leaves ep does not split
    ep rank 0's (:meth:`loss_and_grads`), and updates its shards in
    place. ``mesh`` is its :class:`MoeMesh`."""

    def __init__(self, config, mesh, lr, with_stats, dispatch_mode,
                 active_only_moments, dev):
        self.config, self.mesh, self.lr = config, mesh, lr
        self.with_stats, self.dispatch_mode = with_stats, dispatch_mode
        self.active_only_moments, self.dev = active_only_moments, dev

    def local_batch(self, ids, labels):
        """This rank's dp rows of the global [B, S] host batch, on the
        device; raises ValueError for a batch the mesh cannot split."""
        ids, labels = np.asarray(ids), np.asarray(labels)
        b, s = ids.shape
        dp, ep = self.mesh.dp, self.mesh.ep
        if b % dp.nranks:
            raise ValueError(f"a batch of {b} rows does not divide over "
                             f"dp_degree={dp.nranks}")
        if self.dispatch_mode == "ragged_a2a" and \
                (b * s) % (dp.nranks * ep.nranks):
            raise ValueError(
                f"ragged_a2a splits the {b * s} tokens of a [{b}, {s}] "
                f"batch over dp_degree x ep_degree = "
                f"{dp.nranks * ep.nranks} ranks, which does not divide "
                f"them")
        n = b // dp.nranks
        rows = slice(dp.rank * n, (dp.rank + 1) * n)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows], np.int32)
                                    ).to(self.dev)
        return to_dev(ids), to_dev(labels)

    def loss_and_grads(self, params, ids, labels):
        """(total, aux, grads) of :func:`moe_loss` on this rank's rows: the
        global values, each gradient summed over dp (a stacked leaf's
        per-layer slices stacked for one collective and returned as a
        list), and each leaf ep does not split then taken from ep rank 0.
        Every ep rank computes that gradient whole, but a backward whose
        sums take no fixed order (row 16's dQ) rounds it apart on each:
        in JAX the leaf is one array, and the copies must stay equal, or
        a near-tie in top-k could route a token apart on two ep ranks."""
        leaves = _leaves_of(params)
        total, aux = moe_loss(leaves, ids, labels, self.config,
                              self.with_stats, self.dispatch_mode,
                              self.active_only_moments, self.mesh)
        total.backward()
        dp, ep = self.mesh.dp, self.mesh.ep
        specs = param_pspecs(self.config, ep.nranks, dp.nranks)

        def reduced(g, spec):
            if isinstance(g, dict):
                return {k: reduced(v, spec[k]) for k, v in g.items()}
            if dp.nranks == 1 and "ep" in spec:
                return g
            t = torch.stack(g) if isinstance(g, list) else g
            comm.all_reduce(t, dp)
            if "ep" not in spec:
                comm.broadcast(t, 0, ep)
            return list(t.unbind(0)) if isinstance(g, list) else t
        return total.detach(), _detach(aux), \
            reduced(_grads_of(leaves), specs)

    def __call__(self, params, opt, ids, labels):
        loss, aux, grads = self.loss_and_grads(
            params, *self.local_batch(ids, labels))
        masks = None
        if self.active_only_moments:
            aux, rows_pl = aux
            ep = self.mesh.ep
            n = rows_pl.shape[1] // ep.nranks
            masks = _expert_row_masks(params, rows_pl[:, ep.rank * n:
                                                      (ep.rank + 1) * n])
        _adamw_update(params, grads, opt, self.lr, masks=masks)
        if self.with_stats:
            lm_loss, stats = aux
            return params, opt, loss, {"lm_loss": lm_loss, **stats}
        return params, opt, loss, aux


def active_params(config: ErnieMoEConfig) -> int:
    """Parameters one token passes through: embedding (tied head), the
    attention of every layer, the dense FFNs, and per MoE layer its top-k
    experts, the shared expert and the router (``bench.py``'s count)."""
    c = config
    n_dense = sum(1 for i in range(c.num_hidden_layers)
                  if (i % c.moe_every) != (c.moe_every - 1))
    n_moe = c.num_hidden_layers - n_dense
    ffn = 2 * c.hidden_size * c.intermediate_size
    shared_ffn = 2 * c.hidden_size * (c.num_shared_experts
                                      * c.intermediate_size)
    return (c.vocab_size * c.hidden_size
            + c.num_hidden_layers * 4 * c.hidden_size ** 2
            + n_dense * ffn
            + n_moe * (c.moe_topk * ffn + shared_ffn
                       + c.hidden_size * c.num_experts))


def train_flops_per_token(config: ErnieMoEConfig, seq_len: int) -> float:
    """6 x active params + attention, per token (fwd+bwd), for the
    active-parameter MFU."""
    c = config
    return 6.0 * active_params(c) + 12 * c.num_hidden_layers \
        * c.hidden_size * seq_len
