"""Converts the JAX package's flax variables into the port's variables.

``from_flax`` takes ``{'params', 'batch_stats', 'avg_params'}`` as nested
dicts of numpy arrays, as ``jax.tree_util.tree_map(np.asarray, variables)``
gives them, and returns ``{'params': state_dict, 'avg_params':
state_dict}`` (``avg_params`` only where the input has it). Module paths
keep their flax names joined by dots (``grasping44.conv2``); the leaves map
as:

  * conv ``kernel`` HWIO -> ``weight`` OIHW (``transpose(3, 2, 0, 1)``);
  * dense ``kernel`` [in, out] -> ``weight`` [out, in];
  * ``bias`` and batch norm ``scale`` keep their names;
  * ``batch_stats`` ``mean`` / ``var`` join the state dict of both
    ``params`` and ``avg_params`` (the EMA averages weights only).

fc0 needs no row permutation: the port flattens final_conv in the same
H, W, C order as the JAX network.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = ['from_flax']


def _leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix, key, np.asarray(value)


def _state_dict(params, batch_stats) -> Dict[str, torch.Tensor]:
  state = {}
  for path, leaf, value in _leaves(params):
    if leaf == 'kernel':
      if value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
      elif value.ndim == 2:
        value = value.T
      else:
        raise ValueError('Unexpected kernel rank {} at {}.'.format(
            value.ndim, '/'.join(path)))
      leaf = 'weight'
    state['.'.join(path + (leaf,))] = value
  for path, leaf, value in _leaves(batch_stats or {}):
    state['.'.join(path + (leaf,))] = value
  return {name: torch.from_numpy(np.ascontiguousarray(value, np.float32))
          for name, value in state.items()}


def from_flax(variables) -> Dict[str, Dict[str, torch.Tensor]]:
  """The port's ``variables`` from flax ``variables`` (see module doc)."""
  batch_stats = variables.get('batch_stats')
  out = {'params': _state_dict(variables['params'], batch_stats)}
  if variables.get('avg_params') is not None:
    out['avg_params'] = _state_dict(variables['avg_params'], batch_stats)
  return out
