"""MoE routing, dispatch and combine on one device (port of
``paddle_tpu/parallel/moe.py`` at ep = 1).

Two dispatch modes, as in the JAX package (:func:`moe_dispatch_combine`):

- ``"capacity"`` (the JAX default, :func:`default_dispatch_mode`): the
  slot schedule. Each (token, choice) pair takes a slot in its expert's
  bucket of C rows (C rounded up to 128, :func:`moe_capacity`); pairs past
  the drop capacity go to the trash slot E*C and are dropped. The expert
  FFN is a plain batched product over [E, C, D], as JAX's ``jax.vmap`` of
  the expert function is plain XLA. ``use_onehot`` takes the
  [T, E, C] one-hot einsum form (:func:`top_k_gating`) instead.
- ``"ragged"``: :func:`moe_ragged_dispatch_combine` lays every pair into
  a tile-aligned expert-sorted buffer (no capacity, no drops) and runs the
  expert FFN as two grouped matmuls (:mod:`..ops.grouped_matmul`, the
  CUDA kernels on the card).

Both combine the k expert outputs with the gate weights and keep
everything on the device: counts are device tensors and every buffer's
row count is static, so a step never waits on the host.

Not ported: the ep > 1 shard_map paths (``moe_slot_dispatch_local``,
``moe_ragged_dispatch_local``, ``moe_ragged_dispatch_a2a``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import envs
from ..ops.grouped_matmul import (TILE_ROWS, _round_up, grouped_matmul,
                                  tile_schedule)

#: stats keys that are RATIOS: aggregate by averaging over MoE layers;
#: every other key is a count and sums.
RATIO_STAT_KEYS = ("moe_load_imbalance", "moe_capacity_util")


def zero_routing_stats(mode="capacity", num_experts=0, device=None):
    """The stats dict of ``mode`` ("capacity", "ragged" or "ragged_a2a")
    with every value zero: what a dense layer of the non-split stack
    reports, with the MoE layers' keys and shapes."""
    z = torch.zeros((), device=device)
    if mode in ("ragged", "ragged_a2a"):
        st = {"moe_dropped_tokens": z, "moe_routed_tokens": z,
              "moe_load_imbalance": z, "moe_live_rows": z,
              "moe_padded_rows": z}
        if mode == "ragged_a2a":
            st.update(moe_a2a_wire_rows=z, moe_a2a_buffer_rows=z)
        st["moe_expert_rows"] = torch.zeros((num_experts,), device=device)
        return st
    return {"moe_dropped_tokens": z, "moe_routed_tokens": z,
            "moe_load_imbalance": z, "moe_capacity_util": z}


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


def default_dispatch_mode():
    """The dispatch mode from ``PADDLE_TPU_TORCH_MOE_DROPLESS``: truthy
    selects ``"ragged"``, unset or falsy the ``"capacity"`` slot schedule
    (JAX's ``PADDLE_TPU_MOE_DROPLESS``)."""
    return envs.get("PADDLE_TPU_TORCH_MOE_DROPLESS")


def top_k_gating(logits, k: int, capacity: int, drop_capacity=None):
    """gshard/switch gating, JAX's one-hot form: logits [T, E] f32 ->
    (combine [T, E, C] f32, dispatch [T, E, C] f32 0/1, aux_loss). The
    top k by iterated argmax (first index on ties); a token's position in
    its expert's queue is the count of earlier tokens there; tokens at or
    past ``min(drop_capacity, capacity)`` drop. Surviving gates are
    renormalised to carry the selected mass."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates = torch.zeros_like(probs)
    remaining = probs
    for _ in range(k):
        onehot = F.one_hot(torch.argmax(remaining, dim=-1), E).to(
            probs.dtype)
        gates = gates + onehot * probs
        remaining = remaining * (1 - onehot)
    aux_loss = _gshard_aux_loss(probs, E)
    if drop_capacity is None:
        drop_capacity = capacity
    chosen = gates > 0
    position = (torch.cumsum(chosen.int(), dim=0) - 1) * chosen
    in_capacity = chosen & (position < min(drop_capacity, capacity))
    # jax.nn.one_hot of a position >= C is all zeros: clamp, then select
    pos_oh = F.one_hot(position.clamp(max=capacity - 1).long(),
                       capacity).to(probs.dtype)
    dispatch = pos_oh * in_capacity[..., None]
    combine = dispatch * gates[..., None]
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9) \
        * gates.sum(-1)[:, None, None]
    return combine, dispatch, aux_loss


def _ref_capacity(T, k, E, capacity_factor):
    """The reference's per-expert capacity, floor(factor * T * k / E),
    at least 1: UNROUNDED."""
    return max(int(capacity_factor * T * k / E), 1)


def _capacity(T, k, E, capacity_factor):
    """The per-expert bucket size of every capacity path: the reference
    capacity rounded up to 128 rows."""
    return _round_up(_ref_capacity(T, k, E, capacity_factor), 128)


def moe_capacity(T, k, E, capacity_factor):
    """(compute capacity, reference capacity): buckets are sized by the
    first; ``strict_capacity`` drops at the second."""
    return _capacity(T, k, E, capacity_factor), \
        _ref_capacity(T, k, E, capacity_factor)


def _queue_positions(e_flat, counts):
    """Each pair's rank among its expert's pairs in token order (the JAX
    exclusive cumsum over a [T*k, E] one-hot), by a stable sort."""
    order = torch.argsort(e_flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(e_flat.shape[0], device=e_flat.device)
    return rank - (torch.cumsum(counts, 0) - counts)[e_flat]


def _expert_counts(e_flat, E):
    """Pairs per expert by ``scatter_add_``, never ``bincount`` (which
    sizes its output on the host)."""
    return torch.zeros((E,), dtype=torch.int32,
                       device=e_flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))


def topk_route(logits, k: int, capacity: int, drop_capacity=None):
    """Slot-schedule routing: logits [T, E] f32 -> (slot [T*k] int32 in
    [0, E*C], E*C the trash slot of dropped pairs; weight [T, k] f32;
    aux_loss). Pairs are token-major, so queue positions are the gshard
    cumsum over tokens; a pair at or past ``min(drop_capacity, capacity)``
    drops, and each token's surviving gates are renormalised to carry its
    full selected mass."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates, experts = _top_k(probs, k)
    aux_loss = _gshard_aux_loss(probs, E)
    e_flat = experts.reshape(-1)
    pos = _queue_positions(e_flat, _expert_counts(e_flat, E))
    if drop_capacity is None:
        drop_capacity = capacity
    valid = pos < min(drop_capacity, capacity)
    slot = torch.where(valid, e_flat * capacity + pos, E * capacity)
    g = gates * valid.reshape(T, k)
    denom = torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    weight = g / denom * gates.sum(-1, keepdim=True)
    return slot.to(torch.int32), weight, aux_loss


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
    counts = _expert_counts(e_flat, E)
    # a stable sort, not the one-hot cumsum: an outer-dim scan of the
    # one-hot took 2.8 ms a layer at T*k = 16384 on an H100
    pos = _queue_positions(e_flat, counts)
    offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(_round_up(counts, tile_rows), 0).to(torch.int32)])
    slot = offsets[e_flat] + pos

    # the JAX formula (every pair valid), operation for operation
    denom = torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    weight = gates / denom * gates.sum(-1, keepdim=True)
    n_rows = ragged_buffer_rows(T, k, E, tile_rows)
    return slot.to(torch.int32), weight, aux_loss, counts, n_rows


def routing_stats(slot, num_experts, capacity, k, drop_capacity=None):
    """Per-step routing stats of the slot schedule, f32 on the device:
    dropped and routed pairs, max/mean expert load and the routed share
    of the drop-capacity rows. slot [T*k] from :func:`topk_route`."""
    E = num_experts
    if drop_capacity is None:
        drop_capacity = capacity
    valid = (slot < E * capacity).float()
    routed = valid.sum()
    dropped = float(slot.shape[0]) - routed
    expert_of = torch.clamp(torch.div(slot, capacity, rounding_mode="floor"),
                            0, E - 1).long()
    load = torch.zeros((E,), device=slot.device).index_add_(0, expert_of,
                                                             valid)
    mean = torch.clamp(routed / E, min=1e-9)
    return {"moe_dropped_tokens": dropped,
            "moe_routed_tokens": routed,
            "moe_load_imbalance": load.max() / mean,
            "moe_capacity_util": routed / float(E * min(drop_capacity,
                                                        capacity))}


def routing_stats_onehot(dispatch, k, drop_capacity=None):
    """:func:`routing_stats` from a one-hot [T, E, C] dispatch mask
    (:func:`top_k_gating`)."""
    T, E, C = dispatch.shape
    if drop_capacity is None:
        drop_capacity = C
    load = dispatch.float().sum(dim=(0, 2))
    routed = load.sum()
    dropped = float(T * k) - routed
    mean = torch.clamp(routed / E, min=1e-9)
    return {"moe_dropped_tokens": dropped,
            "moe_routed_tokens": routed,
            "moe_load_imbalance": load.max() / mean,
            "moe_capacity_util": routed / float(E * min(drop_capacity, C))}


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


def _expert_ffn(w1, w2, x, act=gelu):
    """The expert FFN over stacked buckets, JAX's ``jax.vmap`` of
    ``act(x @ w1) @ w2``: x [E, C, D], w1 [E, D, I], w2 [E, I, D']."""
    return torch.bmm(act(torch.bmm(x, w1)), w2)


def moe_dispatch_combine(x, gate_logits, w1, w2, num_experts, k=2,
                         capacity_factor=1.25, use_onehot=False,
                         strict_capacity=False, return_stats=False,
                         dispatch_mode=None, act=gelu):
    """MoE dispatch/combine at ep = 1 (JAX's ``moe_dispatch_combine``
    with the expert function ``act(x @ w1) @ w2``): x [T, D] tokens, w1
    [E, D, I], w2 [E, I, D'] stacked expert weights. Returns (out [T, D'],
    aux) and, with ``return_stats``, the routing stats dict.

    ``dispatch_mode`` None reads :func:`default_dispatch_mode`. ``"ragged"``
    is :func:`moe_ragged_dispatch_combine`. ``"capacity"`` is the slot
    schedule: one row gather of x into [E, C, D] buckets in slot order
    (dropped pairs and empty slots read a zero row), the expert FFN over
    the buckets, one row gather of the outputs back per pair, the gate
    weighted sum. ``use_onehot`` takes the [T, E, C] einsum form instead;
    ``strict_capacity`` drops at the unrounded reference capacity while
    the buckets keep the rounded size."""
    if dispatch_mode is None:
        dispatch_mode = default_dispatch_mode()
    if dispatch_mode == "ragged":
        return moe_ragged_dispatch_combine(x, gate_logits, w1, w2,
                                           num_experts, k=k, act=act,
                                           return_stats=return_stats)
    if dispatch_mode != "capacity":
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r} "
                         "(expected 'capacity' or 'ragged')")
    T, D = x.shape
    E = num_experts
    capacity, ref_cap = moe_capacity(T, k, E, capacity_factor)
    drop_cap = ref_cap if strict_capacity else capacity
    if use_onehot:
        combine, dispatch, aux = top_k_gating(gate_logits, k, capacity,
                                              drop_capacity=drop_cap)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        expert_out = _expert_ffn(w1, w2, expert_in, act)
        out = torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                           expert_out)
        if return_stats:
            return out, aux, routing_stats_onehot(dispatch, k, drop_cap)
        return out, aux
    slot, weight, aux = topk_route(gate_logits, k, capacity,
                                   drop_capacity=drop_cap)
    dev = x.device
    # slot -> source token and source pair; the trash slot E*C and the
    # empty slots point at the sentinel row T / T*k
    inv = torch.full((E * capacity + 1,), T, dtype=torch.int64, device=dev)
    inv[slot.long()] = torch.arange(T, device=dev).repeat_interleave(k)
    pair_inv = torch.full((E * capacity + 1,), T * k, dtype=torch.int64,
                          device=dev)
    pair_inv[slot.long()] = torch.arange(T * k, device=dev)
    expert_in = _DispatchRows.apply(x, inv, slot, k).reshape(E, capacity, D)
    expert_out = _expert_ffn(w1, w2, expert_in, act)
    d_out = expert_out.shape[-1]
    picked = _CombineRows.apply(expert_out.reshape(E * capacity, d_out),
                                slot, pair_inv).reshape(T, k, d_out)
    out = torch.einsum("tk,tkd->td", weight.to(picked.dtype), picked)
    if return_stats:
        with torch.no_grad():
            stats = routing_stats(slot, E, capacity, k, drop_cap)
        return out, aux, stats
    return out, aux


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
