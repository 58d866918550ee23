"""The dql_grasping helpers that merge candidate actions with one state
embedding (the JAX package's ``research/dql_grasping.py``): the feature map
stays at batch B while the context carries B * num_samples rows, so the
conv tower does not run again for each action."""

from __future__ import annotations

import torch

__all__ = ['add_context', 'tile_to_match_context']


def tile_to_match_context(net: torch.Tensor,
                          context: torch.Tensor) -> torch.Tensor:
  """``net`` [B, ...] repeated along a new axis 1 to ``context``'s
  [B, num_samples, C] samples."""
  num_samples = context.shape[1]
  expanded = net.unsqueeze(1)
  return expanded.repeat((1, num_samples) + (1,) * (expanded.dim() - 2))


def add_context(net: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
  """[B, H, W, C] features plus [B * num_samples, C] action embeddings
  (each state's samples contiguous) -> [B * num_samples, H, W, C]."""
  batch = net.shape[0]
  h, w, d1 = net.shape[1:]
  d2 = context.shape[-1]
  if d1 != d2:
    raise ValueError('Context depth {} != net depth {}.'.format(d2, d1))
  context = context.reshape(batch, -1, d2)
  num_samples = context.shape[1]
  out = tile_to_match_context(net, context) + context[:, :, None, None, :]
  return out.reshape(batch * num_samples, h, w, d1)
