"""Pipeline parallelism over the pp ranks (port of
``paddle_tpu/parallel/pipeline.py``).

The JAX package runs the collective 1F1B schedule inside one SPMD
program: stage parameters stacked on a leading axis sharded over 'pp',
activations rotated between neighbour stages by ``lax.ppermute``, the
microbatch schedule a ``lax.scan`` over ticks with bubble masking, and
backward ``jax.grad`` through the scan (the reverse rotation is its
transpose). Here every stage is a process, one a rank, and the schedule
is a Python loop over the same ticks on each rank: at tick t stage s
runs its body on microbatch t - s (t - 2s when overlapped), and every
rank makes every tick's hop (``communication.permute_hop``: the open
chain s -> s+1, stage 0 receiving zeros and the last stage sending
nothing), so the ranks' point-to-point calls pair up. Autograd makes the
backward: each hop's transpose sends the gradient back, and one token
threaded through the hops makes every rank walk them in reverse tick
order.

Two departures from the JAX program, each exact: a rank runs its body
only on its active ticks (JAX computes every tick and masks the bubble's
outputs to zeros; those outputs are zeros here, and their gradients are
zero in both), and the counters ``pp.overlap``, ``pp.stages``,
``pp.microbatches`` and ``pp.ticks`` are set when a pipeline is built, as
JAX sets them when it traces one.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import envs
from ..distributed import communication as comm
from ..observability import trace as _obs

ENV_PP_OVERLAP = "PADDLE_TPU_TORCH_PP_OVERLAP"


def p2p_overlap_enabled(overlap: Optional[bool] = None) -> bool:
    """The overlapped schedule's switch: an explicit argument wins, else
    ``PADDLE_TPU_TORCH_PP_OVERLAP``."""
    if overlap is not None:
        return bool(overlap)
    return envs.get(ENV_PP_OVERLAP)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage param trees on a new leading 'pp' axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))


class _Join(torch.autograd.Function):
    """The schedule's outputs with its last token attached: the same
    values, and a backward that also hands the token its (zero) gradient,
    so that backward from the outputs walks every hop."""

    @staticmethod
    def forward(ctx, outputs, token):
        return outputs.view_as(outputs)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros((), dtype=torch.float32)


def _outputs(outs, last, token):
    """[M, ...]: the microbatches' outputs on the last stage, zeros (one
    broadcast zero) elsewhere, with the schedule's last token attached."""
    if last:
        outputs = torch.stack(outs)
    else:
        outputs = outs[0].new_zeros(()).expand((len(outs),) + outs[0].shape)
    return _Join.apply(outputs, token)


def _body(stage_fn, remat):
    if not remat:
        return stage_fn
    return lambda p, h: checkpoint(stage_fn, p, h, use_reentrant=False,
                                   preserve_rng_state=False)


def _check(group, num_stages):
    if group.nranks != num_stages:
        raise ValueError(f"a pipeline of {num_stages} stages needs a pp "
                         f"group of as many ranks; got {group}")


def pipeline_apply(stage_fn: Callable, num_stages: int,
                   num_microbatches: int, group, remat: bool = True,
                   overlap_p2p: Optional[bool] = None):
    """Build f(stage_params_local, x_microbatches) -> outputs, run by
    every rank of the pp ``group`` (a ``communication.Group`` of
    ``num_stages`` ranks, rank s stage s), where JAX's runs inside
    shard_map over ``axis_name``.

    stage_fn(stage_params, h) -> h: one pipeline stage, hidden -> hidden.
    stage_params_local: this stage's params with a leading axis of size 1
    (its slice of :func:`stack_stage_params`'s stack). x_microbatches:
    [M, ...] hidden inputs (read on stage 0; the other stages take only
    its shape, dtype and device). Returns [M, ...] outputs, valid on the
    LAST stage (zeros elsewhere); callers select them (see
    :func:`last_stage_value`).

    overlap_p2p (default: ``PADDLE_TPU_TORCH_PP_OVERLAP``): the blocking
    schedule ends each tick with its hop, T = M + S - 1 ticks; the
    overlapped one posts tick t-1's output's hop before tick t's body and
    waits for it after (``communication.start_permute``), producer to
    consumer two ticks apart, T = M + 2(S - 1). Per-microbatch ops are
    identical, so the outputs and gradients are bitwise the blocking
    schedule's."""
    S, M = num_stages, num_microbatches
    overlap = p2p_overlap_enabled(overlap_p2p) and S > 1
    skew = 2 if overlap else 1
    T = M + skew * (S - 1)
    body = _body(stage_fn, remat)
    _obs.set_counter("pp.overlap", int(overlap))
    _obs.set_counter("pp.stages", S)
    _obs.set_counter("pp.microbatches", M)
    _obs.set_counter("pp.ticks", T)

    def run(params_local, x_mb):
        _check(group, S)
        params_here = _map(lambda a: a[0], params_local)
        stage = group.rank
        zeros = torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype,
                            device=x_mb.device)
        token = torch.zeros((), device=x_mb.device, requires_grad=True)
        outs = [zeros] * M
        h = out_prev = zeros
        for t in range(T):
            pending = comm.start_permute(out_prev, group) if overlap \
                else None
            mb = t - skew * stage
            out = zeros
            if 0 <= mb < M:
                out = body(params_here, x_mb[mb] if stage == 0 else h)
                if stage == S - 1:
                    outs[mb] = out
            if S == 1:
                continue
            if overlap:
                h, token = comm.permute_hop(out_prev, group, token,
                                            pending=pending)
                out_prev = out
            else:
                h, token = comm.permute_hop(out, group, token)
        return _outputs(outs, stage == S - 1, token)

    return run


def pipeline_apply_interleave(stage_fn: Callable, num_stages: int,
                              num_virtual: int, num_microbatches: int,
                              group, remat: bool = True):
    """The interleaved (virtual-stage) pipeline, JAX's
    ``pipeline_apply_interleave`` over the pp ``group``: the layer list
    cut into V*S chunks, chunk c on stage c % S; each rank holds a [V, ...]
    stack of its chunks' params. Each rank runs exactly one chunk a tick
    in the grouped round-robin order (groups of S microbatches cycle
    through the V resident chunks), every producer-to-consumer edge one
    tick apart over the closed ring s -> s+1 mod S (the wrap from the last
    stage to stage 0 advances the virtual slot): T = V*M + S - 1 ticks.
    Needs M % S == 0.

    stage_fn(chunk_params, h) -> h. x_mb: [M, ...]; output [M, ...] valid
    on the last stage (slot V-1 exits there), zeros elsewhere."""
    S, V, M = num_stages, num_virtual, num_microbatches
    if M % S != 0:
        raise ValueError(
            f"interleaved pipeline needs num_microbatches ({M}) divisible "
            f"by num_stages ({S})")
    T = V * M + S - 1
    body = _body(stage_fn, remat)

    def run(params_chunks, x_mb):
        _check(group, S)
        stage = group.rank
        zeros = torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype,
                            device=x_mb.device)
        token = torch.zeros((), device=x_mb.device, requires_grad=True)
        outs = [zeros] * M
        h = zeros
        for t in range(T):
            # microstep j -> (chunk slot v, microbatch m): groups of S
            # microbatches cycle through the V chunks (the reference's
            # get_model_chunk_id order)
            j = t - stage
            out = zeros
            if 0 <= j < V * M:
                g, r = j // (V * S), j % (V * S)
                v, i = r // S, r % S
                m = g * S + i
                x_in = x_mb[m] if (stage == 0 and v == 0) else h
                out = body(_map(lambda a: a[v], params_chunks), x_in)
                if stage == S - 1 and v == V - 1:
                    outs[m] = out
            if S > 1:
                h, token = comm.permute_hop(out, group, token, ring=True)
            else:
                h = out
        return _outputs(outs, stage == S - 1, token)

    return run


class _LastStage(torch.autograd.Function):
    """The last stage's value on every stage: zeros elsewhere, summed
    over pp. Every rank holds the same sum and calls backward on it with
    the same cotangent, so the backward hands the cotangent to the last
    stage's value alone, zeros to the others'."""

    @staticmethod
    def forward(ctx, value, group):
        ctx.last = group.rank == group.nranks - 1
        v = value.clone() if ctx.last else torch.zeros_like(value)
        return comm.all_reduce(v, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def last_stage_value(value, num_stages: int, group):
    """Broadcast a value computed on the last stage to all stages (zero
    elsewhere, summed over ``group``, as JAX's psum)."""
    if num_stages == 1:
        return value
    return _LastStage.apply(value, group)


def build_pipeline_loss_fn(embed_fn, stage_fn, head_loss_fn, num_stages,
                           num_microbatches, group, remat=True,
                           overlap_p2p=None):
    """Compose a full pipelined loss to differentiate with autograd.

    embed_fn(embed_params, batch) -> [M, ...] microbatched hidden states
    stage_fn(stage_params, h) -> h
    head_loss_fn(head_params, h_microbatches, batch) -> scalar loss
    Called by every rank of ``group``; embed/head params live on the
    first/last stage logically but are computed on every rank, as JAX's
    replicated island computes them."""
    pipe = pipeline_apply(stage_fn, num_stages, num_microbatches, group,
                          remat, overlap_p2p=overlap_p2p)

    def loss_fn(params, batch):
        embed_params, stacked_stage_params, head_params = params
        h_mb = embed_fn(embed_params, batch)
        out_mb = pipe(stacked_stage_params, h_mb)
        loss = head_loss_fn(head_params, out_mb, batch)
        return last_stage_value(loss, num_stages, group)

    return loss_fn


def microbatch(x, num_microbatches: int):
    """[B, ...] -> [M, B/M, ...]; a B that M does not divide raises
    ValueError (JAX asserts)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"a batch of {b} rows does not divide into "
                         f"{num_microbatches} microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))
