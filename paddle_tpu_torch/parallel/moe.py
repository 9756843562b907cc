"""MoE routing, dispatch and combine (port of ``paddle_tpu/parallel/moe.py``).

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

Over ranks, where JAX runs a ``shard_map`` over the mesh axis "ep", the
port takes the ep :class:`~..distributed.communication.Group` (one
process a rank): :func:`moe_slot_dispatch_local`,
:func:`moe_ragged_dispatch_local` (tokens replicated over ep, each rank
its E/n experts, the [T, D] partials all-reduced),
:func:`moe_ragged_dispatch_a2a` (tokens sharded over ep, every routed row
sent to its expert's owner and back by the ragged all-to-all) and
:func:`moe_shard_map_dispatch` (the capacity one-hot all-to-all). The
routing, capacity formula, queue positions, slot layout and stats are
JAX's.

Gradients over ep differ in form from JAX's ``shard_map`` transpose, which
divides a replicated output's cotangent by the axis size and sums a
replicated input's over the axis: here every rank's cotangent is already
whole. So the local paths send the dispatched rows and the combine
weights through the Megatron pair of :mod:`.collective_matmul`:
``copy_to_mp`` (identity forward, all-reduce over ep backward) on the
way in, ``reduce_from_mp`` (all-reduce forward, identity backward) on
the partials: a token's and a router weight's gradient is whole on every
ep rank, and the router, computed the same on every ep rank, is not
counted n times.

At dp above 1 without ep, JAX routes the GLOBAL token set (its serial
path, partitioned by GSPMD); a port rank holds only its rows, so the
``dp`` argument of :func:`moe_dispatch_combine` makes the routing global:
capacity from the global T, queue positions after the lower dp ranks'
pairs, the aux loss from global means (:func:`_gshard_aux_loss`) and the
stats from global counts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import envs
from ..distributed import communication as comm
from ..distributed.communication.ragged import exchange_counts, ring_hop
from ..observability import trace as _obs
from ..ops.grouped_matmul import (TILE_ROWS, _round_up, chunk_schedule,
                                  grouped_matmul, tile_schedule)
from .collective_matmul import copy_to_mp, reduce_from_mp

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


def _multi(group):
    return group is not None and group.nranks > 1


def mean_over(x, group):
    """``x`` averaged over ``group`` (``lax.pmean``), each rank's gradient
    its own 1/n part (:func:`..collective_matmul.reduce_from_mp`)."""
    return reduce_from_mp(x / group.nranks, group) if _multi(group) else x


class _SplitRows(torch.autograd.Function):
    """This rank's block of rows (dim 0) forward; the backward all-gathers
    the blocks' gradients over ``group`` (each rank's block is its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // group.nranks
        return x.narrow(0, group.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), 0, ctx.group), None


def split_rows(x, group):
    """Block ``group.rank`` of ``group.nranks`` equal blocks of rows of
    ``x`` (the same on every rank of ``group``): the tokens of an ep rank
    under the ragged all-to-all, JAX's ``P(("dp", "ep"))``; the gradient
    of ``x`` is gathered whole on every rank."""
    if not _multi(group):
        return x
    if x.shape[0] % group.nranks:
        raise ValueError(f"split_rows: {x.shape[0]} rows do not divide over "
                         f"{group.nranks} ranks")
    return _SplitRows.apply(x, group)


def _gshard_aux_loss(probs, E, dp=None):
    """gshard load-balancing loss: E * sum(mean_prob * fraction_top1).
    With ``dp`` (more than one rank) the means are over the tokens of
    every dp rank (this rank's gradient is its own rows' part)."""
    top1 = torch.argmax(probs, dim=-1)
    if not _multi(dp):
        me = probs.mean(dim=0)
        ce = F.one_hot(top1, E).to(probs.dtype).mean(dim=0)
        return E * (me * ce).sum()
    T = probs.shape[0] * dp.nranks
    me = reduce_from_mp(probs.sum(dim=0), dp) / T
    top1_counts = comm.all_reduce(F.one_hot(top1, E).to(probs.dtype).sum(
        dim=0), dp)
    return E * (me * (top1_counts / T)).sum()


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


def _lower_rank_counts(counts, dp):
    """[E] pairs per expert of the dp ranks before this one (the
    exclusive scan of the ranks' counts, all-gathered)."""
    every = comm.all_gather(counts[None], 0, dp)        # [n, E]
    return every[:dp.rank].sum(dim=0)


def topk_route(logits, k: int, capacity: int, drop_capacity=None, dp=None):
    """Slot-schedule routing: logits [T, E] f32 -> (slot [T*k] int32 in
    [0, E*C], E*C the trash slot of dropped pairs; weight [T, k] f32;
    aux_loss). Pairs are token-major, so queue positions are the gshard
    cumsum over tokens; a pair at or past ``min(drop_capacity, capacity)``
    drops, and each token's surviving gates are renormalised to carry its
    full selected mass.

    ``dp`` (more than one rank): the tokens are this rank's rows of a
    global set whose earlier rows lie on the lower dp ranks. A pair's
    queue position, which decides its drop, counts the lower ranks' pairs
    of its expert too; its slot in this rank's buckets is its position
    among this rank's pairs (so no bucket overflows), and the aux loss is
    the global one."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates, experts = _top_k(probs, k)
    aux_loss = _gshard_aux_loss(probs, E, dp)
    e_flat = experts.reshape(-1)
    counts = _expert_counts(e_flat, E)
    pos = _queue_positions(e_flat, counts)
    queue = pos + _lower_rank_counts(counts, dp)[e_flat] if _multi(dp) \
        else pos
    if drop_capacity is None:
        drop_capacity = capacity
    valid = queue < min(drop_capacity, capacity)
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

    n_rows = ragged_buffer_rows(T, k, E, tile_rows)
    return slot.to(torch.int32), _ragged_weights(gates), aux_loss, counts, \
        n_rows


def _ragged_weights(gates):
    """The combine weights of every dropless path: JAX's formula with
    every pair valid, operation for operation."""
    denom = torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates / denom * gates.sum(-1, keepdim=True)


def _pair_inverse(slot, n_rows, T, k):
    """(inv, pair_inv) [n_rows + 1] int64: each buffer row's source token
    and source pair, T / T*k (the sentinel zero row) for an unfilled row.
    Slots equal to n_rows (a trash slot: a dropped pair, or one that stays
    out of this rank's buffer) land on the last entry, which no gather
    reads."""
    dev = slot.device
    inv = torch.full((n_rows + 1,), T, dtype=torch.int64, device=dev)
    inv[slot.long()] = torch.arange(T, device=dev).repeat_interleave(k)
    pair_inv = torch.full((n_rows + 1,), T * k, dtype=torch.int64,
                          device=dev)
    pair_inv[slot.long()] = torch.arange(T * k, device=dev)
    return inv, pair_inv


def routing_stats(slot, num_experts, capacity, k, drop_capacity=None,
                  dp=None):
    """Per-step routing stats of the slot schedule, f32 on the device:
    dropped and routed pairs, max/mean expert load and the routed share
    of the drop-capacity rows. slot [T*k] from :func:`topk_route`;
    ``dp``: of the pairs of every dp rank (the loads all-reduced)."""
    E = num_experts
    if drop_capacity is None:
        drop_capacity = capacity
    valid = (slot < E * capacity).float()
    expert_of = torch.clamp(torch.div(slot, capacity, rounding_mode="floor"),
                            0, E - 1).long()
    load = torch.zeros((E,), device=slot.device).index_add_(0, expert_of,
                                                             valid)
    pairs = float(slot.shape[0])
    if _multi(dp):
        load = comm.all_reduce(load, dp)
        pairs *= dp.nranks
        routed = load.sum()
    else:
        routed = valid.sum()
    dropped = pairs - routed
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
                         dispatch_mode=None, act=gelu, dp=None):
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
    the buckets keep the rounded size.

    ``dp``: a dp group of more than one rank whose ranks hold, in rank
    order, the rows of one global token set (JAX's serial path over the
    global batch): routing, capacity (from the global T), drops, aux and
    stats are the global set's, each rank computing its own rows (the
    slot form only)."""
    if dispatch_mode is None:
        dispatch_mode = default_dispatch_mode()
    if dispatch_mode == "ragged":
        return moe_ragged_dispatch_combine(x, gate_logits, w1, w2,
                                           num_experts, k=k, act=act,
                                           return_stats=return_stats, dp=dp)
    if dispatch_mode != "capacity":
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r} "
                         "(expected 'capacity' or 'ragged')")
    T, D = x.shape
    E = num_experts
    n_dp = dp.nranks if _multi(dp) else 1
    capacity, ref_cap = moe_capacity(T * n_dp, k, E, capacity_factor)
    drop_cap = ref_cap if strict_capacity else capacity
    if use_onehot:
        if n_dp > 1:
            raise ValueError("moe_dispatch_combine: use_onehot over a dp "
                             "group is not ported")
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
                                   drop_capacity=drop_cap, dp=dp)
    inv, pair_inv = _pair_inverse(slot, E * capacity, T, k)
    expert_in = _DispatchRows.apply(x, inv, slot, k).reshape(E, capacity, D)
    expert_out = _expert_ffn(w1, w2, expert_in, act)
    d_out = expert_out.shape[-1]
    picked = _CombineRows.apply(expert_out.reshape(E * capacity, d_out),
                                slot, pair_inv).reshape(T, k, d_out)
    out = torch.einsum("tk,tkd->td", weight.to(picked.dtype), picked)
    if return_stats:
        with torch.no_grad():
            stats = routing_stats(slot, E, capacity, k, drop_cap, dp=dp)
        return out, aux, stats
    return out, aux


def moe_ragged_dispatch_combine(x, gate_logits, w1, w2, num_experts, k=2,
                                act=gelu, tile_rows=None,
                                return_stats=False, dp=None):
    """DROPLESS MoE: route -> dispatch -> act(gmm(xd, w1)) -> gmm(h, w2)
    -> combine -> weighted sum over the k choices. x [T, D]; w1 [E, D,
    I], w2 [E, I, D]. Returns (out [T, D], aux) and, with
    ``return_stats``, the :func:`routing_stats_ragged` dict. ``dp``: the
    aux loss and stats of the global token set (the counts all-reduced);
    each token's output needs no exchange."""
    if tile_rows is None:
        tile_rows = TILE_ROWS
    T, D = x.shape
    slot, weight, aux, counts, n_rows = ragged_route(gate_logits, k,
                                                     tile_rows)
    if _multi(dp):      # no pair drops, so only the aux loss is global
        aux = _gshard_aux_loss(torch.softmax(gate_logits.float(), dim=-1),
                               num_experts, dp)
    sched = tile_schedule(counts, n_rows // tile_rows, tile_rows)[:2]

    inv, pair_inv = _pair_inverse(slot, n_rows, T, k)
    xd = _DispatchRows.apply(x, inv, slot, k)       # [n_rows, D]
    h = act(grouped_matmul(xd, w1, sched, tile_rows))
    y = grouped_matmul(h, w2, sched, tile_rows)     # [n_rows, D']
    d_out = y.shape[-1]
    picked = _CombineRows.apply(y, slot, pair_inv).reshape(T, k, d_out)
    out = torch.einsum("tk,tkd->td", weight.to(picked.dtype), picked)
    if return_stats:
        with torch.no_grad():
            if _multi(dp):
                counts = comm.all_reduce(counts.clone(), dp)
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


# ---------------------------------------------------------------------------
# expert parallelism: E/n experts a rank of the ep group
# ---------------------------------------------------------------------------

def local_slots(slot, rank, local_span):
    """(loc, mine): a capacity slot re-based to this ep rank's buckets
    (its E/n experts' ``local_span`` rows), ``local_span`` (the local
    trash slot) for a pair of another rank's expert or a dropped one."""
    loc = slot - rank * local_span
    mine = (loc >= 0) & (loc < local_span)
    return torch.where(mine, loc, local_span), mine


def moe_slot_dispatch_local(x, gate_logits, w1_local, w2_local, num_experts,
                            group, k=2, capacity_factor=1.25,
                            strict_capacity=False, return_stats=False,
                            act=gelu):
    """The slot schedule over an ep group: x [T, D] this dp shard's tokens
    (the same on every ep rank), w1_local [E/n, D, I], w2_local
    [E/n, I, D] this rank's experts. Every rank routes all T tokens
    (capacity from this T, the dp-local count, as in JAX), gathers the
    slots of its own experts, runs them (``torch.bmm``, JAX's ``vmap``)
    and the [T, D] partial outputs are all-reduced over ep in span
    ``moe.combine_psum``. Returns (out, aux) and the routing stats, the
    same on every ep rank."""
    n, rank = group.nranks, group.rank
    T, D = x.shape
    E = num_experts
    e_local = E // n
    capacity, ref_cap = moe_capacity(T, k, E, capacity_factor)
    drop_cap = ref_cap if strict_capacity else capacity
    slot, weight, aux = topk_route(gate_logits, k, capacity,
                                   drop_capacity=drop_cap)
    local_span = e_local * capacity
    loc, mine = local_slots(slot, rank, local_span)
    inv, pair_inv = _pair_inverse(loc, local_span, T, k)
    xd = _DispatchRows.apply(copy_to_mp(x, group), inv, loc, k)
    expert_out = _expert_ffn(w1_local, w2_local,
                             xd.reshape(e_local, capacity, D), act)
    d_out = expert_out.shape[-1]
    picked = _CombineRows.apply(expert_out.reshape(local_span, d_out), loc,
                                pair_inv).reshape(T, k, d_out)
    w = copy_to_mp(weight, group) * mine.reshape(T, k)
    partial = torch.einsum("tk,tkd->td", w.to(picked.dtype), picked)
    out = reduce_from_mp(partial, group, "moe.combine_psum",
                         "moe.combine_psum")
    if return_stats:
        with torch.no_grad():
            stats = routing_stats(slot, E, capacity, k, drop_cap)
        return out, aux, stats
    return out, aux


def local_ragged_layout(e_flat, rank, e_local, T, k, tile_rows):
    """This ep rank's dropless buffer: (slot [T*k] int32, n_rows for the
    pairs of other ranks' experts; counts [E/n] int32; n_rows). Pairs of
    its experts bucket by local expert, tile-aligned, in token-major queue
    order; the buffer holds ``ragged_buffer_rows(T, k, E/n)`` rows, the
    case of every pair local."""
    le = e_flat - rank * e_local
    mine = (le >= 0) & (le < e_local)
    le_t = torch.where(mine, le, e_local)       # e_local: the trash bucket
    counts_all = _expert_counts(le_t, e_local + 1)
    pos = _queue_positions(le_t, counts_all)
    counts = counts_all[:e_local]
    offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=e_flat.device),
        torch.cumsum(_round_up(counts, tile_rows), 0).to(torch.int32)])
    n_rows = ragged_buffer_rows(T, k, e_local, tile_rows)
    slot = torch.where(mine, offsets[le_t] + pos, n_rows).to(torch.int32)
    return slot, counts, n_rows


def moe_ragged_dispatch_local(x, gate_logits, w1_local, w2_local,
                              num_experts, group, k=2, act=gelu,
                              tile_rows=None, return_stats=False):
    """The dropless path over an ep group, tokens replicated over ep: each
    rank routes all T tokens, lays the pairs of its E/n experts into a
    local tile-aligned buffer (:func:`local_ragged_layout`), runs the two
    grouped matmuls (rows 24-26 on the card) and the [T, D] partials are
    all-reduced over ep (``moe.combine_psum``). Stats: the global
    per-expert counts (the same on every ep rank), ``moe_padded_rows``
    summed over ep."""
    if tile_rows is None:
        tile_rows = TILE_ROWS
    n, rank = group.nranks, group.rank
    T, D = x.shape
    E = num_experts
    e_local = E // n
    probs = torch.softmax(gate_logits.float(), dim=-1)
    gates, experts = _top_k(probs, k)
    aux = _gshard_aux_loss(probs, E)
    e_flat = experts.reshape(-1)
    slot, counts, n_rows = local_ragged_layout(e_flat, rank, e_local, T, k,
                                               tile_rows)
    sched = tile_schedule(counts, n_rows // tile_rows, tile_rows)[:2]
    inv, pair_inv = _pair_inverse(slot, n_rows, T, k)
    xd = _DispatchRows.apply(copy_to_mp(x, group), inv, slot, k)
    h = act(grouped_matmul(xd, w1_local, sched, tile_rows))
    y = grouped_matmul(h, w2_local, sched, tile_rows)
    d_out = y.shape[-1]
    picked = _CombineRows.apply(y, slot, pair_inv).reshape(T, k, d_out)
    mine = (slot < n_rows).reshape(T, k)
    w = copy_to_mp(_ragged_weights(gates), group) * mine
    partial = torch.einsum("tk,tkd->td", w.to(picked.dtype), picked)
    out = reduce_from_mp(partial, group, "moe.combine_psum",
                         "moe.combine_psum")
    if return_stats:
        with torch.no_grad():
            st = routing_stats_ragged(_expert_counts(e_flat, E), k,
                                      tile_rows)
            pad = (_round_up(counts, tile_rows).float().sum()
                   - counts.float().sum())
            st["moe_padded_rows"] = comm.all_reduce(pad, group)
        return out, aux, st
    return out, aux


def a2a_layout(e_flat, rank, n, e_local, T, k, tile_rows):
    """The hop-major send buffer of the ragged all-to-all: (slot [T*k]
    int32, counts [n, E/n] int32 rows per (destination, local expert),
    chunk_rows). Chunk h (rows h*chunk_rows...) goes to rank
    (rank + h) % n, its destination's local-expert groups tile-aligned
    in it (:func:`..ops.grouped_matmul.chunk_schedule` derives the same
    layout from the counts on the receiver); a chunk is
    ``ragged_buffer_rows(T, k, E/n)`` rows, every local pair to one rank,
    so no skew overflows it."""
    E = n * e_local
    counts = _expert_counts(e_flat, E)
    pos = _queue_positions(e_flat, counts)
    counts_mat = counts.reshape(n, e_local)
    aligned = _round_up(counts_mat, tile_rows)
    off_within = torch.cat([
        torch.zeros((n, 1), dtype=torch.int32, device=e_flat.device),
        torch.cumsum(aligned, 1).to(torch.int32)[:, :-1]], 1)
    chunk_rows = ragged_buffer_rows(T, k, e_local, tile_rows)
    dest = torch.div(e_flat, e_local, rounding_mode="floor")
    le = e_flat % e_local
    hop = (dest - rank) % n
    slot = (hop * chunk_rows + off_within[dest, le] + pos).to(torch.int32)
    return slot, counts_mat, chunk_rows


def moe_ragged_dispatch_a2a(x, gate_logits, w1_local, w2_local, num_experts,
                            group, k=2, act=gelu, tile_rows=None,
                            a2a_impl=None, overlap=None,
                            return_stats=False):
    """The dropless path with tokens SHARDED over the ep group: x
    [T_local, D] is this rank's slice, each rank owns E/n experts, and
    every routed (token, choice) row travels to its expert's owner and
    its output back, in hop-major chunks (:func:`a2a_layout`). The
    receiver runs each arrived chunk through the grouped matmuls under
    its own :func:`..ops.grouped_matmul.chunk_schedule` of the exchanged
    counts; the combine is a row gather of the returned chunks weighted
    by this rank's gates, with no all-reduce.

    Transport (``a2a_impl``, default ``PADDLE_TPU_TORCH_MOE_A2A``):
    "ring", n - 1 shifted hops out (``moe.ragged_a2a.hop``) and n - 1 back
    (``moe.ragged_a2a.ret_hop``); "dense", one equal-chunk all-to-all
    each way (``moe.ragged_a2a.dense``/``.dense_ret``). ``overlap``
    (default ``PADDLE_TPU_TORCH_MOE_A2A_OVERLAP``, ring only) posts hop
    h+1 before chunk h's products and each return hop as its chunk is
    done; otherwise every hop lands before the first chunk's product (JAX's
    blocking barrier). All four variants give the same bits, forward and
    backward. Counters ``moe.a2a.hops_total`` and
    ``moe.a2a.hops_overlapped``.

    Stats (with ``return_stats``): the ep group's per-expert counts, the
    receivers' padding, ``moe_a2a_wire_rows`` (real rows that crossed the
    wire) and ``moe_a2a_buffer_rows`` (chunk rows sent, padding
    included), summed over ep."""
    if tile_rows is None:
        tile_rows = TILE_ROWS
    if a2a_impl is None:
        a2a_impl = envs.get("PADDLE_TPU_TORCH_MOE_A2A")
    if a2a_impl not in ("ring", "dense"):
        raise ValueError(f"unknown a2a_impl {a2a_impl!r} "
                         "(expected 'ring' or 'dense')")
    if overlap is None:
        overlap = envs.get("PADDLE_TPU_TORCH_MOE_A2A_OVERLAP")
    n, me = group.nranks, group.rank
    T, D = x.shape
    E = num_experts
    e_local = E // n
    probs = torch.softmax(gate_logits.float(), dim=-1)
    gates, experts = _top_k(probs, k)
    aux = _gshard_aux_loss(probs, E)
    e_flat = experts.reshape(-1)
    slot, counts_mat, chunk_rows = a2a_layout(e_flat, me, n, e_local, T, k,
                                              tile_rows)
    n_rows = n * chunk_rows
    inv, pair_inv = _pair_inverse(slot, n_rows, T, k)
    send = _DispatchRows.apply(x, inv, slot, k).reshape(n, chunk_rows, D)
    # rows per my local expert that each SOURCE rank sends me
    recv_counts = exchange_counts(counts_mat, group,
                                  name="moe.ragged_a2a.counts")
    ring = a2a_impl == "ring" and n > 1
    overlapping = bool(overlap) and ring
    if n > 1:
        _obs.record_counter("moe.a2a.hops_total", n - 1)
        if overlapping:
            _obs.record_counter("moe.a2a.hops_overlapped", n - 1)

    def expert_chunk(chunk, h):
        cnts = recv_counts[(me - h) % n]             # [e_local]
        sched = chunk_schedule(cnts, chunk_rows, tile_rows)[:2]
        hid = act(grouped_matmul(chunk, w1_local, sched, tile_rows))
        return grouped_matmul(hid, w2_local, sched, tile_rows)

    if overlapping:
        # hop h+1 is posted before chunk h's products; each return hop as
        # soon as its chunk is done
        posted, back, ys = {}, {}, []
        for h in range(n):
            if h + 1 < n:
                posted[h + 1] = comm.start_shift(
                    send[h + 1], group, h + 1, "moe.ragged_a2a.hop",
                    "ragged_a2a.hop")
            chunk = send[0] if h == 0 else comm.shift_hop(
                send[h], group, h, "moe.ragged_a2a.hop", "ragged_a2a.hop",
                pending=posted.pop(h))
            ys.append(expert_chunk(chunk, h))
            if h:
                back[h] = comm.start_shift(ys[h], group, -h,
                                           "moe.ragged_a2a.ret_hop",
                                           "ragged_a2a.hop")
        ret = [ys[0]] + [comm.shift_hop(ys[h], group, -h,
                                        "moe.ragged_a2a.ret_hop",
                                        "ragged_a2a.hop", pending=back[h])
                         for h in range(1, n)]
    else:
        if ring:
            chunks = [send[0]] + [ring_hop(send[h], group, h,
                                           name="moe.ragged_a2a.hop")
                                  for h in range(1, n)]
        elif n > 1:
            # the same chunks through one all-to-all: hop-major ->
            # dest-major out, source-major -> hop-major in
            dest_major = send[[(j - me) % n for j in range(n)]]
            recv_src = comm.all_to_all_grad(dest_major, group,
                                            "moe.ragged_a2a.dense",
                                            "moe.ragged_a2a")
            chunks = list(recv_src[[(me - h) % n for h in range(n)]])
        else:
            chunks = [send[0]]
        ys = [expert_chunk(c, h) for h, c in enumerate(chunks)]
        if ring:
            ret = [ys[0]] + [ring_hop(ys[h], group, -h,
                                      name="moe.ragged_a2a.ret_hop")
                             for h in range(1, n)]
        elif n > 1:
            stack_y = torch.stack(ys)               # [hop, chunk_rows, D']
            to_src = stack_y[[(me - s) % n for s in range(n)]]
            ret_src = comm.all_to_all_grad(to_src, group,
                                           "moe.ragged_a2a.dense_ret",
                                           "moe.ragged_a2a")
            ret = list(ret_src[[(me + h) % n for h in range(n)]])
        else:
            ret = ys
    y_all = torch.cat(ret, 0)                       # [n_rows, D']
    d_out = y_all.shape[-1]
    picked = _CombineRows.apply(y_all, slot, pair_inv).reshape(T, k, d_out)
    out = torch.einsum("tk,tkd->td", _ragged_weights(gates).to(picked.dtype),
                       picked)
    if return_stats:
        with torch.no_grad():
            counts = counts_mat.reshape(-1)
            pad = (_round_up(recv_counts, tile_rows).float().sum()
                   - recv_counts.float().sum())
            wire = (counts.sum() - counts_mat[me].sum()).float()
            # one all-reduce: the E counts, the padding and the wire rows
            summed = comm.all_reduce(torch.cat([
                counts.float(), torch.stack([pad, wire])]), group)
            st = routing_stats_ragged(summed[:E].to(torch.int32), k,
                                      tile_rows)
            st["moe_padded_rows"] = summed[E]
            st["moe_a2a_wire_rows"] = summed[E + 1]
            st["moe_a2a_buffer_rows"] = torch.full(
                (), float(n * (n - 1) * chunk_rows), device=x.device)
        return out, aux, st
    return out, aux


def moe_shard_map_dispatch(x, gate_logits, w1_local, w2_local, num_experts,
                           group, k=2, capacity_factor=1.25,
                           strict_capacity=False, return_stats=False,
                           act=gelu):
    """The capacity one-hot path with an explicit all-to-all over the ep
    group (the reference's global_scatter/global_gather): x [T, D] this
    rank's tokens, E/n experts a rank. The [E, C, D] one-hot dispatch
    sends each owner its experts' buckets (``moe.all_to_all_dispatch``),
    the owner runs [E/n, n*C, D] and the outputs go back
    (``moe.all_to_all_combine``)."""
    n = group.nranks
    T, D = x.shape
    e_local = num_experts // n
    capacity, ref_cap = moe_capacity(T, k, num_experts, capacity_factor)
    drop_cap = ref_cap if strict_capacity else capacity
    combine, dispatch, aux = top_k_gating(gate_logits, k, capacity,
                                          drop_capacity=drop_cap)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    sent = comm.all_to_all_grad(
        expert_in.reshape(n, e_local, capacity, D), group,
        "moe.all_to_all_dispatch", "moe.a2a_dispatch")   # [src, e, C, D]
    recv = sent.permute(1, 0, 2, 3).reshape(e_local, n * capacity, D)
    out_local = _expert_ffn(w1_local, w2_local, recv, act)
    d_out = out_local.shape[-1]
    back = comm.all_to_all_grad(
        out_local.reshape(e_local, n, capacity, d_out).permute(1, 0, 2, 3)
        .contiguous(), group, "moe.all_to_all_combine", "moe.a2a_combine")
    expert_out = back.reshape(num_experts, capacity, d_out)
    out = torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                       expert_out)
    if return_stats:
        with torch.no_grad():
            stats = routing_stats_onehot(dispatch, k, drop_cap)
        return out, aux, stats
    return out, aux
