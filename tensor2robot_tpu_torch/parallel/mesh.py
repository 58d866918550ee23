"""The sequence group: one process per card, in place of a device mesh.

The counterpart of the JAX package's ``parallel/mesh.py`` ``create_mesh``
for the one axis the port uses: ring attention shards every episode's
sequence over the ranks of a ``torch.distributed`` group (the JAX package's
``'data'`` axis under ``attention_mode='ring'``). A CUDA rank runs on
``cuda:LOCAL_RANK`` over NCCL, a CPU rank over gloo. Nothing falls back: a
group that cannot be built raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ['SequenceGroup', 'init_sequence_group']

# How long a collective waits for the other ranks before it fails.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class SequenceGroup:
  """The process group, this process's rank in it, its size and the
  device the rank computes on."""

  group: object
  rank: int
  world_size: int
  device: torch.device


def _env_int(name: str) -> int:
  value = os.environ.get(name)
  if value is None:
    raise ValueError(
        'init_sequence_group needs {} (torchrun sets it) or an explicit '
        'init_method, rank and world_size.'.format(name))
  return int(value)


def init_sequence_group(device='cuda', init_method: Optional[str] = None,
                        rank: Optional[int] = None,
                        world_size: Optional[int] = None,
                        local_rank: Optional[int] = None) -> SequenceGroup:
  """Initializes the default process group and returns it as a
  ``SequenceGroup``.

  Without arguments it reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``; ``init_method`` (a
  ``file://`` path or ``tcp://host:port``) with ``rank`` and ``world_size``
  takes their place. ``device`` 'cuda' uses NCCL on ``cuda:LOCAL_RANK``
  (made the current device), 'cpu' uses gloo.
  """
  kind = torch.device(device).type
  if kind not in ('cuda', 'cpu'):
    raise ValueError('A sequence group runs on CUDA or CPU ranks, not '
                     '{}.'.format(device))
  if init_method is None:
    init_method = 'env://'
    _env_int('MASTER_PORT')
  rank = _env_int('RANK') if rank is None else rank
  world_size = _env_int('WORLD_SIZE') if world_size is None else world_size
  if local_rank is None:
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
  if kind == 'cuda':
    if not dist.is_nccl_available():
      raise RuntimeError('A CUDA sequence group needs NCCL, which this '
                         'PyTorch does not have.')
    if local_rank >= torch.cuda.device_count():
      raise RuntimeError('Rank {} needs cuda:{}; {} CUDA devices are '
                         'visible.'.format(rank, local_rank,
                                           torch.cuda.device_count()))
    rank_device = torch.device('cuda', local_rank)
    torch.cuda.set_device(rank_device)
    backend = 'nccl'
  else:
    rank_device = torch.device('cpu')
    backend = 'gloo'
  dist.init_process_group(
      backend, init_method=init_method, rank=rank, world_size=world_size,
      timeout=GROUP_TIMEOUT,
      device_id=rank_device if kind == 'cuda' else None)
  return SequenceGroup(group=dist.group.WORLD, rank=dist.get_rank(),
                       world_size=dist.get_world_size(), device=rank_device)
