"""Collectives over one axis of the rank mesh (port of
``paddle_tpu/distributed/communication/``, the functional forms the train
step needs).

In the JAX package a group is a named mesh axis and a collective lowers
to an XLA op inside the compiled program. Here a :class:`Group` holds
the ``torch.distributed`` process group of one axis, and each call is an
eager collective on this rank's tensor, in the tensor's dtype and on its
device: no tensor is moved to the host by this module (gloo itself
stages CUDA tensors through the host). A group of one rank makes no call.

Every call runs inside :func:`~paddle_tpu_torch.observability.trace.comm_span`
``comm.<op>.<axis>``, which tallies ``.calls`` and ``.bytes`` (the full
tensor: the input of an all-reduce, reduce or reduce-scatter, the output
of an all-gather).

Gloo runs every collective used here on CUDA tensors in torch 2.11
(``tools/gloo_probe.py``), so none is expressed through another.

Point-to-point is the exception. Gloo's ``send``/``recv`` (and so
``isend``/``irecv`` and ``batch_isend_irecv``) hands a tensor's pointer
to its TCP transport as host memory: on CUDA tensors in torch 2.11 the
sender fails with "writev: Bad address" and its peer with "Connection
closed", or a rank aborts on an uncaught ``gloo::IoException``
(``tools/gloo_probe.py --p2p`` on an NVIDIA H100 80GB HBM3, 700.00 W;
CPU tensors pass in f32 and bf16). So :func:`ring_hop` stages a CUDA
tensor through a host copy on each side when the group's backend is
gloo, chosen by the backend's name; NCCL, a card a rank, takes device
tensors as they are. The pipeline's hops (:func:`permute_hop`: the open
chain of ``pipeline_apply``, the ring of ``pipeline_apply_interleave``)
go the same way, and :func:`start_hop` posts one without waiting, so the
overlapped schedule starts a hop before a stage's compute and waits for
it after. A staged 256 MB bf16 hop between two ranks on one
card moved 0.49 GB/s, a CPU one 0.76 GB/s (the same probe).

The expert-parallel transports of MoE (``parallel.moe``,
``communication.ragged``) are :func:`shift_hop` (a shift of the ring by
any h, differentiable, postable ahead with :func:`start_shift`) and
:func:`all_to_all` (equal chunks, ``all_to_all_single``). Whether gloo's
all-to-all takes CUDA tensors is not on record, so it stages them
through the host like the hops. These take the span name of their call
site in the JAX package (``moe.ragged_a2a.hop``, ...); their backward
calls count under ``<name>.grad``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ...observability.trace import comm_span


class Group:
    """A communication group: one axis of the rank mesh. ``rank`` is this
    process's index in ``ranks`` (global ranks, in axis order); ``pg`` is
    the axis's process group (None for one rank)."""

    def __init__(self, axis_name: str, nranks: int, rank: int = 0,
                 ranks: Optional[List[int]] = None, pg=None):
        self.axis_name = axis_name
        self.nranks = nranks
        self.rank = rank
        self.ranks = ranks if ranks is not None else list(range(nranks))
        self.pg = pg

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return (f"Group(axis={self.axis_name}, nranks={self.nranks}, "
                f"ranks={self.ranks})")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _span(op: str, group: Group, nbytes: int, name: Optional[str] = None,
          site: Optional[str] = None):
    """The span of a call: ``comm.<op>.<axis>``, or the caller's ``name``
    (and ``site``) where it names the call as the JAX package does."""
    if name is not None:
        return comm_span(name, nbytes=nbytes, site=site)
    return comm_span(f"comm.{op}.{group.axis_name}", nbytes=nbytes)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensor: torch.Tensor, group: Group, op: str = "sum",
               name: Optional[str] = None,
               site: Optional[str] = None) -> torch.Tensor:
    """Reduce ``tensor`` over ``group`` in place (``op`` "sum" or
    "max"); returns it. ``name`` and ``site`` replace the span's
    ``comm.all_reduce.<axis>``."""
    if group.nranks > 1:
        with _span("all_reduce", group, _nbytes(tensor), name, site):
            dist.all_reduce(tensor, op=_OPS[op], group=group.pg)
    return tensor


def ring_hop(tensor: torch.Tensor, group: Group) -> torch.Tensor:
    """One hop of a ring over ``group`` (``lax.ppermute`` with the
    permutation r -> r+1): send ``tensor`` to the next rank of the group,
    r+1 mod n, and return what the previous one, r-1, sent (a new tensor
    of the same shape, dtype and device). In span ``comm.ppermute.<axis>``
    with the tensor's bytes. Over gloo a CUDA tensor goes through host
    copies (see the module docstring)."""
    n = group.nranks
    if n == 1:
        return tensor
    r = group.rank
    with _span("ppermute", group, _nbytes(tensor)):
        return start_hop(tensor, group, (r + 1) % n, (r - 1) % n).wait()


class PendingHop:
    """This rank's part of a permutation, posted by :func:`start_hop`:
    :meth:`wait` returns what arrived, a tensor like the one sent (zeros
    where this rank receives nothing)."""

    def __init__(self, works, src, dst, like):
        self.works, self.src, self.dst, self.like = works, src, dst, like

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self.works, self.src = [], None
        if self.dst is None:
            return torch.zeros_like(self.like)
        return self.dst.to(self.like.device)


def start_hop(tensor: torch.Tensor, group: Group, send_to: Optional[int],
              recv_from: Optional[int]) -> PendingHop:
    """Post this rank's part of a permutation over ``group``: send
    ``tensor`` to the rank of index ``send_to`` in the group and receive
    a tensor like it from index ``recv_from`` (None: nothing), without
    waiting. Over gloo a CUDA tensor is copied to the host here and what
    arrives goes back to the device in :meth:`PendingHop.wait`."""
    staged = tensor.is_cuda and dist.get_backend(group.pg) == "gloo"
    src = dst = None
    ops = []
    if send_to is not None:
        src = tensor.cpu() if staged else tensor.contiguous()
        ops.append(dist.P2POp(dist.isend, src, group.ranks[send_to],
                              group.pg))
    if recv_from is not None:
        dst = torch.empty(tensor.shape, dtype=tensor.dtype,
                          device="cpu" if staged else tensor.device)
        ops.append(dist.P2POp(dist.irecv, dst, group.ranks[recv_from],
                              group.pg))
    works = dist.batch_isend_irecv(ops) if ops else []
    return PendingHop(works, src, dst, tensor)


def hop_peers(group: Group, ring: bool = False):
    """(send_to, recv_from) of this rank in one hop over ``group``: the
    open chain r -> r+1 of a pipeline (``[(i, i+1) for i in range(n-1)]``:
    the first rank receives nothing, the last sends nothing), or with
    ``ring`` the closed ring r -> r+1 mod n."""
    n, r = group.nranks, group.rank
    if ring:
        return (r + 1) % n, (r - 1) % n
    return (r + 1 if r < n - 1 else None), (r - 1 if r > 0 else None)


def start_permute(tensor: torch.Tensor, group: Group,
                  ring: bool = False) -> PendingHop:
    """:func:`start_hop` along :func:`hop_peers`, counted in span
    ``comm.ppermute.<axis>`` with the tensor's bytes; pass the result to
    :func:`permute_hop` as ``pending``."""
    with _span("ppermute", group, _nbytes(tensor)):
        return start_hop(tensor, group, *hop_peers(group, ring))


class _PermuteHop(torch.autograd.Function):
    """A hop along :func:`hop_peers`, differentiable: the backward sends
    the gradient of what arrived back to the rank it came from and
    returns the gradient that the rank ``x`` went to sends back (the
    transpose of ``lax.ppermute``). The 0-d ``token`` passes through
    unchanged, so the hops of one schedule form a chain that autograd
    walks in reverse order on every rank, and each rank's reverse hops
    pair with its neighbours' even where what a hop carried is unused
    (JAX's transpose of the scan makes the same reverse hops)."""

    @staticmethod
    def forward(ctx, x, token, group, ring, pending):
        ctx.group, ctx.peers = group, hop_peers(group, ring)
        if pending is None:
            pending = start_permute(x, group, ring)
        return pending.wait(), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        send_to, recv_from = ctx.peers
        with _span("ppermute", ctx.group, _nbytes(g)):
            got = start_hop(g.contiguous(), ctx.group, recv_from,
                            send_to).wait()
        return (got if send_to is not None else None), g_token, None, \
            None, None


def permute_hop(tensor: torch.Tensor, group: Group, token: torch.Tensor,
                ring: bool = False, pending: Optional[PendingHop] = None):
    """One hop of a pipeline's permutation over ``group`` (the open chain,
    or with ``ring`` the closed ring; see :func:`hop_peers`): returns
    (what the previous rank sent, zeros on the first rank of a chain; the
    token). ``pending``: the hop of ``tensor`` already posted by
    :func:`start_permute` (the overlapped schedule), waited for here.
    Differentiable in ``tensor`` (:class:`_PermuteHop`); thread one 0-d
    ``token`` that requires grad through every hop of a schedule so that
    the backward makes every reverse hop."""
    return _PermuteHop.apply(tensor, token, group, ring, pending)


def shift_peers(group: Group, hop: int):
    """(send_to, recv_from) of this rank in a shift of the group's ring by
    ``hop`` (``lax.ppermute`` with r -> r+hop mod n): r+hop and r-hop mod
    n, or (None, None) where the shift is the identity."""
    n, r = group.nranks, group.rank
    if hop % n == 0:
        return None, None
    return (r + hop) % n, (r - hop) % n


def start_shift(tensor: torch.Tensor, group: Group, hop: int, name: str,
                site: Optional[str] = None) -> Optional[PendingHop]:
    """Post a shift of ``tensor`` by ``hop`` over ``group`` in span
    ``name`` (with the tensor's bytes) without waiting; None where the
    shift is the identity. Pass the result to :func:`shift_hop`."""
    send_to, recv_from = shift_peers(group, hop)
    if send_to is None:
        return None
    with comm_span(name, nbytes=_nbytes(tensor), site=site):
        with torch.no_grad():
            return start_hop(tensor.contiguous(), group, send_to, recv_from)


class _ShiftHop(torch.autograd.Function):
    """A shift by ``hop``, differentiable: the backward shifts the
    gradient by -hop (the transpose of ``lax.ppermute``), in span
    ``<name>.grad``."""

    @staticmethod
    def forward(ctx, x, group, hop, name, site, pending):
        ctx.group, ctx.hop, ctx.name, ctx.site = group, hop, name, site
        if pending is None:
            pending = start_shift(x, group, hop, name, site)
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        site = None if ctx.site is None else ctx.site + ".grad"
        back = start_shift(g.contiguous(), ctx.group, -ctx.hop,
                           ctx.name + ".grad", site)
        return back.wait(), None, None, None, None, None


def shift_hop(tensor: torch.Tensor, group: Group, hop: int, name: str,
              site: Optional[str] = None,
              pending: Optional[PendingHop] = None) -> torch.Tensor:
    """One shift of the group's ring by ``hop`` (any integer; negative
    walks the ring back): send ``tensor`` to rank r+hop mod n and return
    what rank r-hop sent, in span ``name``. ``pending``: the same shift
    already posted by :func:`start_shift` (the overlapped schedule),
    waited for here. Differentiable (:class:`_ShiftHop`). The identity
    shift (hop a multiple of n) returns ``tensor`` and makes no call."""
    if shift_peers(group, hop)[0] is None:
        return tensor
    return _ShiftHop.apply(tensor, group, hop, name, site, pending)


def all_to_all(tensor: torch.Tensor, group: Group, name: str,
               site: Optional[str] = None) -> torch.Tensor:
    """The equal-chunk all-to-all (``lax.all_to_all`` with split and
    concat axis 0, tiled): ``tensor`` [n, ...] sends its block j to rank
    j; the result's block j is what rank j sent. Not differentiable (see
    :func:`all_to_all_grad`). In span ``name`` with the tensor's bytes.
    Over gloo a CUDA tensor goes through a host copy each way."""
    n = group.nranks
    if tensor.shape[0] != n:
        raise ValueError(f"all_to_all: dimension 0 of {tuple(tensor.shape)} "
                         f"is not the group's {n} ranks")
    if n == 1:
        return tensor
    staged = tensor.is_cuda and dist.get_backend(group.pg) == "gloo"
    src = tensor.cpu() if staged else tensor.contiguous()
    out = torch.empty_like(src)
    with comm_span(name, nbytes=_nbytes(tensor), site=site):
        dist.all_to_all_single(out, src, group=group.pg)
    return out.to(tensor.device) if staged else out


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, differentiable: its transpose is itself, in
    span ``<name>.grad``."""

    @staticmethod
    def forward(ctx, x, group, name, site):
        ctx.group, ctx.name, ctx.site = group, name, site
        return all_to_all(x, group, name, site)

    @staticmethod
    def backward(ctx, g):
        site = None if ctx.site is None else ctx.site + ".grad"
        return all_to_all(g.contiguous(), ctx.group, ctx.name + ".grad",
                          site), None, None, None


def all_to_all_grad(tensor: torch.Tensor, group: Group, name: str,
                    site: Optional[str] = None) -> torch.Tensor:
    """:func:`all_to_all`, differentiable in ``tensor``."""
    if group.nranks == 1:
        return tensor
    return _AllToAll.apply(tensor, group, name, site)


def broadcast(tensor: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """The tensor of the rank of index ``src`` in ``group`` on every rank,
    written in place into ``tensor`` (the same shape and dtype on every
    rank). Returns it."""
    if group.nranks > 1:
        with _span("broadcast", group, _nbytes(tensor)):
            dist.broadcast(tensor, src=group.ranks[src], group=group.pg)
    return tensor


def reduce(tensor: torch.Tensor, dst: int, group: Group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` into the rank of index ``dst`` in
    the group, in place there; other ranks' tensors are left undefined.
    Returns it."""
    if group.nranks > 1:
        with _span("reduce", group, _nbytes(tensor)):
            dist.reduce(tensor, dst=group.ranks[dst], group=group.pg)
    return tensor


def all_gather(tensor: torch.Tensor, dim: int, group: Group,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate every rank's ``tensor`` along ``dim`` in group order:
    the full tensor, written into ``out`` when given."""
    n = group.nranks
    if n == 1:
        return tensor if out is None else out.copy_(tensor)
    full = list(tensor.shape)
    full[dim] *= n
    with _span("all_gather", group, _nbytes(tensor) * n):
        if dim == 0 and (out is None or out.is_contiguous()):
            out = tensor.new_empty(full) if out is None else out
            dist.all_gather_into_tensor(out, tensor.contiguous(),
                                        group=group.pg)
            return out
        # gloo wants the output's dim 0 to be the input's times n
        shape = list(tensor.shape)
        buf = tensor.new_empty([n * shape[0]] + shape[1:])
        dist.all_gather_into_tensor(buf, tensor.contiguous(), group=group.pg)
    # [n, s0, .., sd, ..] -> [s0, .., n, sd, ..] -> merge n into dim
    res = buf.view([n] + shape).movedim(0, dim).reshape(full)
    return res if out is None else out.copy_(res)


def reduce_scatter(tensor: torch.Tensor, dim: int,
                   group: Group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` and return this rank's part of the
    sum: the ``group.rank``-th of ``group.nranks`` equal slices along
    ``dim``."""
    n = group.nranks
    if n == 1:
        return tensor
    shape = list(tensor.shape)
    if shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of {shape} does "
                         f"not divide over {n} ranks")
    part = shape[:dim] + [shape[dim] // n] + shape[dim + 1:]
    x = tensor.reshape(shape[:dim] + [n, shape[dim] // n] + shape[dim + 1:])
    # [n, ..] with rank k's slice at k, its dim 0 merged into n's: gloo
    # wants the input's dim 0 to be the output's times n
    x = x.movedim(dim, 0).contiguous().view([n * part[0]] + part[1:])
    out = tensor.new_empty(part)
    with _span("reduce_scatter", group, _nbytes(tensor)):
        dist.reduce_scatter_tensor(out, x, group=group.pg)
    return out
