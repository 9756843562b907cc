"""Dropless MoE routing, dispatch and combine on one device (port of the
ragged path of ``paddle_tpu/parallel/moe.py``).

``moe_ragged_dispatch_combine`` routes each token to its top-k experts,
lays every (token, choice) pair into a tile-aligned expert-sorted buffer
(no capacity, no drops), runs the expert FFN as two grouped matmuls
(:mod:`..ops.grouped_matmul`, the CUDA kernels on the card) and combines
the k expert outputs with the gate weights. Everything stays on the
device: counts are device tensors and the buffer's row count is static
(:func:`ragged_buffer_rows`), so a step never waits on the host.

Not ported: the capacity slot schedule and one-hot dispatch
(``moe_dispatch_combine``'s other branches), the ep > 1 shard_map paths
(``moe_ragged_dispatch_local``, ``moe_ragged_dispatch_a2a``), and
``zero_routing_stats``, whose only caller is the non-split ERNIE stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.grouped_matmul import (TILE_ROWS, _round_up, grouped_matmul,
                                  tile_schedule)

#: stats keys that are RATIOS: aggregate by averaging over MoE layers;
#: every other key is a count and sums.
RATIO_STAT_KEYS = ("moe_load_imbalance", "moe_capacity_util")


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gshard_aux_loss(probs, E):
    """gshard load-balancing loss: E * sum(mean_prob * fraction_top1)."""
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(top1, E).to(probs.dtype).mean(dim=0)
    return E * (me * ce).sum()


def _top_k(probs, k):
    """(values, indices) of the k largest per row, ties toward the lower
    index as ``lax.top_k`` breaks them (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def ragged_buffer_rows(T, k, E, tile_rows):
    """Static row count of the dropless buffer: round_up(T*k) + E*tile_rows
    covers any sum of tile-rounded group sizes."""
    return _round_up(T * k, tile_rows) + E * tile_rows


def ragged_route(logits, k: int, tile_rows: int):
    """DROPLESS routing into a tile-aligned expert-sorted buffer.

    logits [T, E] f32. Returns (slot [T*k] int32, weight [T, k] f32,
    aux_loss, counts [E] int32, n_rows int): slot = group_offset[expert]
    + the pair's token-major queue position, group offsets from the
    cumsum of tile-rounded counts. Counts come from ``scatter_add_``,
    never ``bincount`` (which sizes its output on the host)."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates, experts = _top_k(probs, k)               # [T, k] each
    aux_loss = _gshard_aux_loss(probs, E)

    e_flat = experts.reshape(-1)                    # [T*k] token-major
    dev = logits.device
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))
    # queue position = the pair's rank among its expert's pairs in token
    # order: the JAX exclusive cumsum over a [T*k, E] one-hot, computed by
    # a stable sort (an outer-dim scan of the one-hot took 2.8 ms a layer
    # at T*k = 16384 on an H100)
    order = torch.argsort(e_flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(e_flat.shape[0], device=dev)
    starts = torch.cumsum(counts, 0) - counts
    pos = rank - starts[e_flat]
    offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(_round_up(counts, tile_rows), 0).to(torch.int32)])
    slot = offsets[e_flat] + pos

    # the JAX formula (every pair valid), operation for operation
    denom = torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    weight = gates / denom * gates.sum(-1, keepdim=True)
    n_rows = ragged_buffer_rows(T, k, E, tile_rows)
    return slot.to(torch.int32), weight, aux_loss, counts, n_rows


def routing_stats_ragged(counts, k, tile_rows):
    """Per-step routing stats of the dropless path, f32 on the device:
    explicit zero drops, routed/live rows, the rows the tile alignment
    pads, max/mean load and the [E] group sizes."""
    counts_f = counts.float()
    E = counts.shape[0]
    live = counts_f.sum()
    padded = _round_up(counts, tile_rows).float().sum() - live
    mean = torch.clamp(live / E, min=1e-9)
    return {"moe_dropped_tokens": torch.zeros((), device=counts.device),
            "moe_routed_tokens": live,
            "moe_load_imbalance": counts_f.max() / mean,
            "moe_live_rows": live,
            "moe_padded_rows": padded,
            "moe_expert_rows": counts_f}


def moe_ragged_dispatch_combine(x, gate_logits, w1, w2, num_experts, k=2,
                                act=gelu, tile_rows=None,
                                return_stats=False):
    """DROPLESS MoE: route -> dispatch -> act(gmm(xd, w1)) -> gmm(h, w2)
    -> combine -> weighted sum over the k choices. x [T, D]; w1 [E, D,
    I], w2 [E, I, D]. Returns (out [T, D], aux) and, with
    ``return_stats``, the :func:`routing_stats_ragged` dict."""
    if tile_rows is None:
        tile_rows = TILE_ROWS
    T, D = x.shape
    slot, weight, aux, counts, n_rows = ragged_route(gate_logits, k,
                                                     tile_rows)
    sched = tile_schedule(counts, n_rows // tile_rows, tile_rows)[:2]

    dev = x.device
    # buffer row -> source token and source pair; unfilled rows (the
    # alignment pads, the static tail) and the sentinel point at T / T*k
    inv = torch.full((n_rows + 1,), T, dtype=torch.int64, device=dev)
    inv[slot.long()] = torch.arange(T, device=dev).repeat_interleave(k)
    pair_inv = torch.full((n_rows + 1,), T * k, dtype=torch.int64,
                          device=dev)
    pair_inv[slot.long()] = torch.arange(T * k, device=dev)

    xd = _DispatchRows.apply(x, inv, slot, k)       # [n_rows, D]
    h = act(grouped_matmul(xd, w1, sched, tile_rows))
    y = grouped_matmul(h, w2, sched, tile_rows)     # [n_rows, D']
    d_out = y.shape[-1]
    picked = _CombineRows.apply(y, slot, pair_inv).reshape(T, k, d_out)
    out = torch.einsum("tk,tkd->td", weight.to(picked.dtype), picked)
    if return_stats:
        with torch.no_grad():
            stats = routing_stats_ragged(counts, k, tile_rows)
        return out, aux, stats
    return out, aux


# Both routing gathers have GATHER-ONLY backwards, as the JAX custom vjps:
# slots are unique per pair, so each transpose is another row gather
# through the inverse index.

def _pad_row(t):
    return torch.cat([t, t.new_zeros((1, t.shape[1]))], 0)


class _DispatchRows(torch.autograd.Function):
    """[n_rows, D] buffer rows from token rows (sentinel -> zeros);
    backward sums each token's k rows."""

    @staticmethod
    def forward(ctx, x, inv, slot, k):
        ctx.save_for_backward(slot)
        ctx.T, ctx.k = x.shape[0], k
        return _pad_row(x)[inv[:-1]]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        d_x = _pad_row(g)[slot.long()].reshape(ctx.T, ctx.k, g.shape[1])
        return d_x.sum(dim=1), None, None, None


class _CombineRows(torch.autograd.Function):
    """[T*k, D] per-pair rows from buffer rows; backward gathers through
    ``pair_inv`` (unfilled rows read the sentinel zero row)."""

    @staticmethod
    def forward(ctx, flat, slot, pair_inv):
        ctx.save_for_backward(pair_inv)
        return _pad_row(flat)[slot.long()]

    @staticmethod
    def backward(ctx, g):
        (pair_inv,) = ctx.saved_tensors
        return _pad_row(g)[pair_inv[:-1]], None, None
