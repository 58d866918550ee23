"""``multi_batch_apply``: a function of one batch dim over several.

The counterpart of the JAX package's ``meta_learning/meta_data.py``
``multi_batch_apply``, over tensors in (nested dicts, lists and tuples of)
the arguments instead of a JAX pytree.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ['multi_batch_apply']


def _map(fn, tree):
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return type(tree)((key, _map(fn, value)) for key, value in tree.items())
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, value) for value in tree)
  return tree


def _tensors(tree):
  found = []
  _map(found.append, tree)
  return found


def multi_batch_apply(fn: Callable, num_batch_dims: int, *args, **kwargs):
  """Applies ``fn`` (which expects one batch dim) over ``num_batch_dims``.

  The leading ``num_batch_dims`` dims of every tensor in ``args`` and
  ``kwargs`` are merged into one, ``fn`` runs, and the leading dim of every
  tensor it returns is split back into the first tensor's batch dims.
  """
  leaves = _tensors((args, kwargs))
  if not leaves:
    raise ValueError('multi_batch_apply needs at least one tensor argument.')
  batch_dims = tuple(leaves[0].shape[:num_batch_dims])

  def merge(x):
    if x.dim() >= num_batch_dims:
      return x.reshape((-1,) + tuple(x.shape[num_batch_dims:]))
    return x

  def split(x):
    return x.reshape(batch_dims + tuple(x.shape[1:]))

  outputs = fn(*_map(merge, args), **_map(merge, kwargs))
  return _map(split, outputs)
