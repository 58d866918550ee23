"""Collectives over a ``torch.distributed`` group: the ring hop and the sum.

The counterparts of the JAX package's ``parallel/collectives.py``
``ring_permute`` (``ppermute`` to the next device on the ring) and
``psum``. JAX names a mesh axis; the port passes the process group (NCCL
between CUDA ranks, gloo between CPU ranks). ``group=None`` means no group:
one rank, where every collective is the identity, as over a mesh axis of
size 1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ['RingExchange', 'all_reduce_sum', 'rank', 'ring_permute',
           'ring_permute_async', 'world_size']


def rank(group) -> int:
  return 0 if group is None else dist.get_rank(group)


def world_size(group) -> int:
  return 1 if group is None else dist.get_world_size(group)


class RingExchange:
  """The receive buffers of a posted ring exchange; ``wait()`` makes the
  current stream wait for them and returns them."""

  def __init__(self, received: List[torch.Tensor], works: Sequence):
    self._received, self._works = received, works

  def wait(self) -> List[torch.Tensor]:
    for work in self._works:
      work.wait()
    return self._received


def ring_permute_async(tensors: Sequence[torch.Tensor],
                       group) -> RingExchange:
  """Posts one ``batch_isend_irecv``: every tensor goes to rank + 1 and a
  new buffer of its shape comes from rank - 1. With one rank the tensors
  themselves come back. The senders must not change the tensors until the
  exchange is waited for."""
  n = world_size(group)
  if n == 1:
    return RingExchange(list(tensors), ())
  me = rank(group)
  to = dist.get_global_rank(group, (me + 1) % n)
  frm = dist.get_global_rank(group, (me - 1) % n)
  received = [torch.empty_like(t) for t in tensors]
  ops = []
  for sent, buffer in zip(tensors, received):
    ops.append(dist.P2POp(dist.isend, sent, to, group))
    ops.append(dist.P2POp(dist.irecv, buffer, frm, group))
  return RingExchange(received, dist.batch_isend_irecv(ops))


def ring_permute(tensors: Sequence[torch.Tensor],
                 group) -> List[torch.Tensor]:
  """Sends each tensor to rank + 1 and returns those received from rank - 1
  (the tensors themselves with one rank)."""
  return ring_permute_async(tensors, group).wait()


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
  """The sum over the group, in place; returns ``tensor``."""
  if world_size(group) > 1:
    dist.all_reduce(tensor, dist.ReduceOp.SUM, group)
  return tensor
