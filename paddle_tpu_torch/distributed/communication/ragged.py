"""Ragged (uneven-splits) all-to-all over a group (port of
``paddle_tpu/distributed/communication/ragged.py``).

- :func:`exchange_counts`: the per-destination count rows, all-to-all,
  so every rank learns how many real rows each peer is about to send it.
- :func:`ring_hop`: one shift of the group's ring (hop ``h`` sends to
  rank (i + h) % n); n - 1 hops make the whole personalized exchange,
  each carrying one destination's chunk, zero-padded to a static size.
- :func:`ragged_all_to_all`: the dest-major exchange built from the two,
  or (``impl="dense"``) the identical chunk layout through one equal-chunk
  all-to-all. Both land the same bits.

A group is a :class:`~paddle_tpu_torch.distributed.communication.Group`
where the JAX package names a mesh axis; the calls are eager collectives
(:mod:`..communication`), each in a span of the JAX package's name.
"""
from __future__ import annotations

import torch

from ...observability.trace import comm_span
from . import Group, all_to_all, all_to_all_grad, shift_hop


def exchange_counts(counts: torch.Tensor, group: Group, *,
                    name: str = "ragged_a2a.counts") -> torch.Tensor:
    """All-to-all the per-destination count rows: ``counts[j]`` is what
    this rank is about to send rank ``j``; row ``j`` of the result is what
    rank ``j`` is about to send this rank. [n, ...] -> [n, ...]; in span
    ``name`` (site ``ragged_a2a.counts``) with the counts' bytes, as in
    the JAX package even for one rank."""
    if group.nranks == 1:
        with comm_span(name, nbytes=counts.numel() * counts.element_size(),
                       site="ragged_a2a.counts"):
            return counts
    return all_to_all(counts, group, name, site="ragged_a2a.counts")


def ring_hop(x: torch.Tensor, group: Group, hop: int, *,
             name: str = "ragged_a2a.hop") -> torch.Tensor:
    """One hop of the ragged ring: every rank ``i`` sends ``x`` to rank
    ``(i + hop) % n`` (a negative ``hop`` walks the return ring);
    differentiable, the backward walks -hop. In span ``name`` (site
    ``ragged_a2a.hop``)."""
    return shift_hop(x, group, hop, name, site="ragged_a2a.hop")


def _pack_dest_major(rows, send_counts, n, peer_rows):
    """[R, ...] dest-sorted rows -> [n, peer_rows, ...] zero-padded
    chunks."""
    R = rows.shape[0]
    padded = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])], 0)
    counts = send_counts.long()
    off = torch.cumsum(counts, 0) - counts
    r = torch.arange(peer_rows, device=rows.device)
    idx = torch.where(r[None, :] < counts[:, None], off[:, None] + r[None, :],
                      R)
    return padded[idx]


def ragged_all_to_all(rows: torch.Tensor, send_counts: torch.Tensor,
                      group: Group, peer_rows: int, *, impl: str = "ring",
                      name: str = "ragged_a2a"):
    """Personalized exchange with uneven per-peer splits over ``group``.

    ``rows`` [R, ...] is sorted by destination rank: the first
    ``send_counts[0]`` rows go to rank 0, the next ``send_counts[1]`` to
    rank 1, and so on (rows past ``send_counts.sum()`` are ignored).
    ``peer_rows`` is the static chunk a peer may be sent at most; each
    chunk is zero-padded to it.

    Returns ``(out, recv_counts)``: ``out`` [n * peer_rows, ...], where
    ``out[j * peer_rows : j * peer_rows + recv_counts[j]]`` are the rows
    rank ``j`` addressed to this rank (zeros past each count), and
    ``recv_counts`` [n]. ``impl="ring"`` walks n - 1 shifted hops,
    ``impl="dense"`` ships the identical chunks through one all-to-all:
    both land the same bits. Differentiable in ``rows``."""
    if impl not in ("ring", "dense"):
        raise ValueError(f"ragged_all_to_all: unknown impl {impl!r}")
    n, me = group.nranks, group.rank
    send = _pack_dest_major(rows, send_counts, n, peer_rows)
    recv_counts = exchange_counts(send_counts, group, name=f"{name}.counts")
    if n == 1:
        return send.reshape((peer_rows,) + rows.shape[1:]), recv_counts
    if impl == "dense":
        out = all_to_all_grad(send, group, f"{name}.dense",
                              site="ragged_a2a.dense")
    else:
        parts = [None] * n
        parts[me] = send[me]
        for h in range(1, n):
            parts[(me - h) % n] = ring_hop(send[(me + h) % n], group, h,
                                           name=f"{name}.hop")
        out = torch.stack(parts)
    return out.reshape((n * peer_rows,) + rows.shape[1:]), recv_counts
