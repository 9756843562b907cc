"""Tensor-parallel collectives and the decomposed collective matmuls
(port of ``paddle_tpu/parallel/collective_matmul.py``).

The JAX package runs these as fully manual shard_map islands over a mesh;
here each is a plain function on this rank's tensors plus the mp
:class:`~paddle_tpu_torch.distributed.communication.Group`, one process a
rank.

The blocking path is the Megatron pair of autograd functions,
:func:`copy_to_mp` (identity forward, all-reduce of the gradient) before
a column-parallel product and :func:`reduce_from_mp` (all-reduce forward,
identity backward) after a row-parallel one, plus :func:`gather_from_mp`
(all-gather forward, the rank's block of the gradient backward). They are
what GSPMD derives from the param specs in the JAX package.

The rings decompose a blocking collective into ``ppermute`` hops
(:func:`~paddle_tpu_torch.distributed.communication.ring_hop`, span
``comm.ppermute.mp``) between partial products:

- :func:`ring_allreduce_matmul`: a row-parallel product whose all-reduce
  is a reduce-scatter ring of row chunks, then a gather ring;
- :func:`ring_allgather_matmul`: a column-parallel product whose output
  all-gather rides the ring chunk by chunk;
- :func:`ring_allreduce`, :func:`ring_allgather`: the same rings without
  the product.

Each ring is a ``torch.autograd.Function`` whose backward is the blocking
path's backward, op for op, so a ring and its blocking counterpart give
the same gradient bits. JAX's backwards issue a ``psum`` of the cotangent
first: it undoes shard_map's 1/n scaling of a replicated output's
cotangent, an artifact of JAX. Each rank's cotangent of a replicated
output is already whole here, so no backward here communicates:
``ring_allreduce_matmul``'s is ``g @ w.T``, ``x.T @ g``;
``ring_allgather_matmul``'s takes the rank's column block of ``g``.

Numerics (PARITY.md, "TP-overlap numerics contract"): at mp 2 a ring's
forward sum is one addition, so every ring is bitwise its blocking
counterpart, forward and backward; the gather rings are bitwise at any
degree, chunked or not (no cross-rank sum); the reduce rings at mp > 2
re-associate the sum and match to f32 tolerance; a sum whose addends are
disjoint (the vocabulary-parallel embedding's masked rows, the cross
entropy's picked logit) is exact in any order.

The plans (:func:`plan_row_parallel`, :func:`plan_column_parallel`,
:func:`plan_fused_ffn`, :func:`plan_vocab_parallel_embedding`,
:func:`plan_parallel_cross_entropy`) take JAX's arguments: the GLOBAL
shapes of the operands, the mp group in place of the mesh and
``batch_degree``, the number of ranks the token rows are split over (the
mesh's batch axes). They return an ``apply`` closure over this rank's
tensors, or None, where JAX's return None: mp 1, shapes that do not
divide, or a chunk under ``min_chunk()`` of the LOCAL token rows. They
are memoised with the overlap knobs in the key, and count
``tp.<plan>.plans`` once a plan is built. Knobs:
``PADDLE_TPU_TORCH_TP_OVERLAP`` (the decoder's fused FFN; read by the
caller through :func:`overlap_enabled`),
``PADDLE_TPU_TORCH_TP_OVERLAP_MIN_CHUNK``,
``PADDLE_TPU_TORCH_TP_OVERLAP_CHUNKS``.
"""
from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from .. import envs
from ..distributed import communication as comm
from ..observability import trace as _obs

ENV_OVERLAP = "PADDLE_TPU_TORCH_TP_OVERLAP"
ENV_MIN_CHUNK = "PADDLE_TPU_TORCH_TP_OVERLAP_MIN_CHUNK"
ENV_CHUNKS = "PADDLE_TPU_TORCH_TP_OVERLAP_CHUNKS"


def overlap_enabled() -> bool:
    return envs.get(ENV_OVERLAP)


def min_chunk() -> int:
    return envs.get(ENV_MIN_CHUNK)


def overlap_chunks():
    """The sub-tile count a ring hop is split into
    (``PADDLE_TPU_TORCH_TP_OVERLAP_CHUNKS``), or None for auto (about
    ``min_chunk()`` rows a sub-tile)."""
    return envs.get(ENV_CHUNKS)


def resolve_chunks(n: int, rows: int) -> int:
    """Sub-tiles a ring hop of ``rows`` rows is split into, as JAX's:
    1 at mp <= 2 (one transfer hop a phase, and the bitwise contract);
    an explicit count that divides ``rows`` (else 1); auto about
    ``min_chunk()`` rows a sub-tile, snapped down to a divisor of
    ``rows``."""
    if n <= 2 or rows <= 1:
        return 1
    req = overlap_chunks()
    if req is not None:
        return req if (req <= rows and rows % req == 0) else 1
    k = max(1, min(rows, rows // max(1, min_chunk())))
    while rows % k:
        k -= 1
    return k


# ---------------------------------------------------------------------------
# the blocking Megatron pair
# ---------------------------------------------------------------------------

class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.clone(memory_format=torch.contiguous_format),
                               ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name, site):
        # a copy: ``x`` may be kept by autograd or by a remat policy (the
        # ``dots`` policy keeps every product), and a recompute handed the
        # kept tensor would reduce a sum again
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               group, name=name, site=site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.all_gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group.nranks
        return g.narrow(ctx.dim, ctx.group.rank * n, n).contiguous(), \
            None, None


def copy_to_mp(x, group):
    """``x`` replicated over mp entering a column-parallel product: the
    identity forward; the backward all-reduces the gradient over
    ``group`` (each rank's product gave a partial one)."""
    return x if group is None or group.nranks == 1 else \
        _CopyToMP.apply(x, group)


def reduce_from_mp(x, group, name=None, site=None):
    """A row-parallel product's partial sums: all-reduced over ``group``
    (into a copy); the backward passes the whole gradient through.
    ``name`` and ``site`` name the all-reduce's span (``comm.all_reduce``)."""
    return x if group is None or group.nranks == 1 else \
        _ReduceFromMP.apply(x, group, name, site)


def gather_from_mp(x, dim, group):
    """Every rank's ``x`` concatenated along ``dim`` in group order; the
    backward keeps this rank's block of the gradient."""
    return x if group is None or group.nranks == 1 else \
        _GatherFromMP.apply(x, dim, group)


def blocking_allreduce_matmul(x, w, group):
    """x [t, k/n] @ w [k/n, out], all-reduced: the rings' reference."""
    return reduce_from_mp(x @ w, group)


def blocking_allgather_matmul(x, w, group):
    """x [t, k] @ w [k, out/n], all-gathered along the columns."""
    return gather_from_mp(x @ w, 1, group)


# ---------------------------------------------------------------------------
# rings
# ---------------------------------------------------------------------------

def _ring_hop(buf, group, nchunks):
    """One ring hop, split into ``nchunks`` row sub-tiles sent one by one
    and joined again (bitwise the unsplit hop)."""
    if nchunks <= 1:
        return comm.ring_hop(buf, group)
    return torch.cat([comm.ring_hop(t, group)
                      for t in buf.chunk(nchunks, dim=0)], dim=0)


def _reduce_ring(x, group, nchunks, product=None):
    """The reduce-scatter ring over x's row chunks, then the gather ring:
    at step s rank r takes chunk c = (r - s - 1) mod n (``product`` of
    it, or the chunk itself) and adds it to the sum arriving from rank
    r - 1; after n steps rank r holds chunk r summed, and n - 1 hops
    spread it. Returns the full [t, ...] sum."""
    n, r = group.nranks, group.rank
    tc = x.shape[0] // n
    acc = None
    for s in range(n):
        if s > 0:
            acc = _ring_hop(acc, group, nchunks)
        c = (r - s - 1) % n
        rows = x[c * tc:(c + 1) * tc]
        part = product(rows) if product is not None else rows
        acc = part if acc is None else acc + part
    out = acc.new_empty((x.shape[0],) + tuple(acc.shape[1:]))
    out[r * tc:(r + 1) * tc] = acc
    buf = acc
    for h in range(1, n):
        buf = _ring_hop(buf, group, nchunks)
        c = (r - h) % n
        out[c * tc:(c + 1) * tc] = buf
    return out


class _RingAllreduceMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, nchunks):
        ctx.save_for_backward(x, w)
        return _reduce_ring(x, group, nchunks, lambda rows: rows.mm(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g.mm(w.t()) if ctx.needs_input_grad[0] else None
        dw = x.t().mm(g) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def ring_allreduce_matmul(x, w, group, nchunks=1):
    """Row-parallel product with its all-reduce as a ring: x [t, k/n]
    this rank's rows of the contraction, w [k/n, out] its shard ->
    [t, out], the same on every rank. t must divide by n (the plans
    check)."""
    return _RingAllreduceMatmul.apply(x, w, group, nchunks)


class _RingAllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, nchunks):
        ctx.save_for_backward(x, w)
        ctx.group = group
        n, r = group.nranks, group.rank
        tc, nc = x.shape[0] // n, w.shape[1]
        out = x.new_empty((x.shape[0], nc * n))
        for c in range(n):
            rows = slice(c * tc, (c + 1) * tc)
            buf = x[rows].mm(w)
            out[rows, r * nc:(r + 1) * nc] = buf
            for h in range(1, n):
                buf = _ring_hop(buf, group, nchunks)
                k = (r - h) % n
                out[rows, k * nc:(k + 1) * nc] = buf
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        nc = w.shape[1]
        g = g.narrow(1, ctx.group.rank * nc, nc).contiguous()
        dx = g.mm(w.t()) if ctx.needs_input_grad[0] else None
        dw = x.t().mm(g) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def ring_allgather_matmul(x, w, group, nchunks=1):
    """Column-parallel product with its output all-gather as a chunked
    ring: x [t, k] replicated, w [k, out/n] this rank's columns ->
    [t, out]. Every element is the product its owner computed, so the
    result is bitwise the blocking one at any degree. The gradient of x
    is this rank's partial (:func:`copy_to_mp` sums it, as after the
    blocking product)."""
    return _RingAllgatherMatmul.apply(x, w, group, nchunks)


class _RingAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, nchunks):
        return _reduce_ring(x, group, nchunks)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ring_allreduce(x, group, nchunks=1):
    """All-reduce of x [t, ...] as the reduce ring without a product.
    Exact in any order where each element has at most one non-zero
    addend."""
    return _RingAllreduce.apply(x, group, nchunks)


class _RingAllgather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, nchunks):
        ctx.group = group
        n, r = group.nranks, group.rank
        out = x.new_empty((n,) + tuple(x.shape))
        out[r] = x
        buf = x.contiguous()
        for h in range(1, n):
            buf = _ring_hop(buf, group, nchunks)
            out[(r - h) % n] = buf
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.group.rank], None, None


def ring_allgather(x, group, nchunks=1):
    """Every rank's x stacked on a new leading axis, [n, ...], by a ring:
    bitwise the blocking all-gather at any degree."""
    return _RingAllgather.apply(x, group, nchunks)


def swiglu(g, u):
    """Llama's MLP gate: silu(gate) * up."""
    return F.silu(g) * u


def gelu_tanh(h):
    """GPT-2's MLP activation, the tanh-approximate gelu."""
    return F.gelu(h, approximate="tanh")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

_PLAN_CACHE = collections.OrderedDict()
_PLAN_CACHE_MAX = 256


def clear_plan_cache():
    _PLAN_CACHE.clear()


def _memoized_plan(fn):
    """Memoise a plan on its arguments and the chunking knobs (a plan
    counts ``tp.<plan>.plans`` once, when it is built)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        key = (fn.__name__, args, tuple(sorted(kwargs.items())),
               envs.raw(ENV_MIN_CHUNK), envs.raw(ENV_CHUNKS))
        if key in _PLAN_CACHE:
            _PLAN_CACHE.move_to_end(key)
            return _PLAN_CACHE[key]
        plan = fn(*args, **kwargs)
        _PLAN_CACHE[key] = plan
        if len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
        return plan
    return wrapper


def _local_rows(t, batch_degree):
    """JAX's rows a rank holds: t split over the batch axes when they
    divide it, else t (replicated)."""
    return t // batch_degree if batch_degree > 1 and t % batch_degree == 0 \
        else t


def _rows_of(shape):
    t = 1
    for d in shape:
        t *= d
    return t


def _degree(group):
    return 1 if group is None else group.nranks


@_memoized_plan
def plan_row_parallel(x_shape, w_shape, group, batch_degree=1):
    """Row-parallel linear by :func:`ring_allreduce_matmul`: x [..., k]
    (k over mp), w [k, out] -> [..., out] on every rank. Returns
    apply(x, w) on this rank's x [..., k/n] and w [k/n, out], or None."""
    n = _degree(group)
    if n <= 1:
        return None
    k, out_f = w_shape
    if x_shape[-1] != k or k % n:
        return None
    t_loc = _local_rows(_rows_of(x_shape[:-1]), batch_degree)
    if t_loc % n or t_loc // n < min_chunk():
        return None
    nchunks = resolve_chunks(n, t_loc // n)
    _obs.record_counter("tp.row_parallel.plans")

    def apply(x, w):
        out = ring_allreduce_matmul(x.reshape(-1, x.shape[-1]), w, group,
                                    nchunks)
        return out.reshape(tuple(x.shape[:-1]) + (out_f,))

    return apply


@_memoized_plan
def plan_column_parallel(x_shape, w_shape, group, batch_degree=1):
    """Column-parallel linear with its output gathered, by
    :func:`ring_allgather_matmul`: x [..., k] replicated, w [k, out] (out
    over mp) -> [..., out]. Returns apply(x, w) on this rank's x and
    w [k, out/n] (x enters through :func:`copy_to_mp`), or None."""
    n = _degree(group)
    if n <= 1:
        return None
    k, out_f = w_shape
    if x_shape[-1] != k or out_f % n or out_f // n < min_chunk():
        return None
    t_loc = _local_rows(_rows_of(x_shape[:-1]), batch_degree)
    if t_loc % n or t_loc // n < min_chunk():
        return None
    nchunks = resolve_chunks(n, t_loc // n)
    _obs.record_counter("tp.column_parallel.plans")

    def apply(x, w):
        xm = copy_to_mp(x, group)
        out = ring_allgather_matmul(xm.reshape(-1, k), w, group, nchunks)
        return out.reshape(tuple(x.shape[:-1]) + (out_f,))

    return apply


@_memoized_plan
def plan_fused_ffn(x_shape, col_shape, row_shape, group, n_cols=1,
                   batch_degree=1, activation=gelu_tanh, col_bias=False):
    """Column -> activation -> row in one plan whose only collective is
    the row product's reduce ring: x [..., k] replicated, ``n_cols``
    column weights [k, i] and a row weight [i, out], i over mp ->
    [..., out] on every rank. The [t, i/n] activation never leaves the
    rank. Returns apply(x, w_cols, w_row, b_cols=()) on this rank's
    tensors (x enters through :func:`copy_to_mp`), or None."""
    n = _degree(group)
    if n <= 1:
        return None
    k, inter = col_shape
    inter2, out_f = row_shape
    if x_shape[-1] != k or inter2 != inter:
        return None
    if inter % n or inter // n < min_chunk():
        return None
    t_loc = _local_rows(_rows_of(x_shape[:-1]), batch_degree)
    if t_loc % n or t_loc // n < min_chunk():
        return None
    nchunks = resolve_chunks(n, t_loc // n)
    _obs.record_counter("tp.fused_ffn.plans")

    def apply(x, w_cols, w_row, b_cols=()):
        xm = copy_to_mp(x, group).reshape(-1, k)
        hs = [xm @ w for w in w_cols]
        if b_cols:
            hs = [h + b for h, b in zip(hs, b_cols)]
        out = ring_allreduce_matmul(activation(*hs), w_row, group, nchunks)
        return out.reshape(tuple(x.shape[:-1]) + (out_f,))

    return apply


def masked_lookup(table, ids, lo):
    """Rows of ``table`` (vocabulary rows [lo, lo + len)) for the ids in
    that slice, zeros for the rest."""
    loc = ids.long() - lo
    ok = (loc >= 0) & (loc < table.shape[0])
    rows = F.embedding(torch.where(ok, loc, 0), table)
    return torch.where(ok[..., None], rows, rows.new_zeros(()))


@_memoized_plan
def plan_vocab_parallel_embedding(ids_shape, table_shape, group,
                                  batch_degree=1):
    """Vocabulary-parallel embedding by :func:`ring_allreduce`: table
    [V, H] with V over mp, ids [...] -> [..., H] on every rank. Each
    rank looks up the ids of its slice, zeros the rest, and the rows ride
    the reduce ring: each row is non-zero on one rank, so the sum is
    exact. Returns apply(ids, table) on this rank's [V/n, H] table, or
    None."""
    n = _degree(group)
    if n <= 1:
        return None
    V, H = table_shape
    if V % n:
        return None
    t_loc = _local_rows(_rows_of(ids_shape), batch_degree)
    if t_loc % n or t_loc // n < min_chunk():
        return None
    nchunks = resolve_chunks(n, t_loc // n)
    vs = V // n
    _obs.record_counter("tp.vocab_embed.plans")

    def apply(ids, table):
        part = masked_lookup(table, ids.reshape(-1), group.rank * vs)
        out = ring_allreduce(part, group, nchunks)
        return out.reshape(tuple(ids.shape) + (H,))

    return apply


@_memoized_plan
def plan_parallel_cross_entropy(logits_shape, group, batch_degree=1):
    """Softmax cross entropy over mp-sharded logits: each rank's (max,
    sum of exp, picked logit) a row ride a ring all-gather, [n, t, 3] f32
    in place of the [t, V] logits, and every rank combines them in rank
    order. The picked logit is non-zero on one rank, so its sum is exact;
    the log-sum is re-associated (f32 tolerance against the blocking
    path). Returns apply(logits, labels) -> [...] per-token losses (no
    -100 mask: the caller masks) on this rank's [..., V/n] logits, or
    None."""
    n = _degree(group)
    if n <= 1:
        return None
    V = logits_shape[-1]
    if V % n or V // n < min_chunk():
        return None
    t_loc = _local_rows(_rows_of(logits_shape[:-1]), batch_degree)
    if t_loc < 1:
        return None
    nchunks = resolve_chunks(n, t_loc)
    vs = V // n
    _obs.record_counter("tp.parallel_ce.plans")

    def apply(logits, labels):
        l32 = logits.reshape(-1, vs).float()
        m = l32.amax(dim=-1)
        s = torch.exp(l32 - m[:, None]).sum(dim=-1)
        loc = labels.reshape(-1).long() - group.rank * vs
        ok = (loc >= 0) & (loc < vs)
        picked = torch.where(
            ok, l32.gather(-1, torch.where(ok, loc, 0)[:, None])[:, 0],
            l32.new_zeros(()))
        allst = ring_allgather(torch.stack([m, s, picked], dim=-1), group,
                               nchunks)
        ms, ss, ps = allst[..., 0], allst[..., 1], allst[..., 2]
        gm = ms.amax(dim=0)
        lse = gm + torch.log((ss * torch.exp(ms - gm)).sum(dim=0))
        return (lse - ps.sum(dim=0)).reshape(tuple(logits.shape[:-1]))

    return apply
