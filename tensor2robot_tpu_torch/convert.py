"""Converts the JAX package's flax variables into the port's variables.

``from_flax`` takes ``{'params', 'batch_stats', 'avg_params'}`` as nested
dicts of numpy arrays, as ``jax.tree_util.tree_map(np.asarray, variables)``
gives them, and returns ``{'params': state_dict, 'avg_params':
state_dict}`` (``avg_params`` only where the input has it). Module paths
keep their flax names joined by dots (``grasping44.conv2``); the leaves map
as:

  * conv ``kernel`` HWIO -> ``weight`` OIHW (``transpose(3, 2, 0, 1)``);
  * dense ``kernel`` [in, out] -> ``weight`` [out, in];
  * ``bias``, batch and layer norm ``scale``, the transformer's
    ``pos_embedding`` and an ``nn.Embed``'s ``embedding`` keep their names;
  * ``batch_stats`` ``mean`` / ``var`` join the state dict of both
    ``params`` and ``avg_params`` (the EMA averages weights only).

The port's modules carry the flax names, so both networks map leaf for
leaf: the Grasping44 critic (fc0 needs no row permutation: the port
flattens final_conv in the same H, W, C order as the JAX network) and
``RT1StyleNet`` (``tokenizer.conv{i}``, ``ln{i}``, ``embed``,
``token_learner.{ln,map_in,map_out}``; ``transformer.pos_embedding``,
``block{i}.{ln_attn,attn.qkv,attn.out,ln_mlp,mlp_in,mlp_out}``,
``ln_final``; ``action_head`` and, where configured, ``task_embedding``
and ``state_token``).

``train_state_from_flax`` builds the port's ``TrainState`` from a JAX
``TrainState`` whose leaves are numpy arrays: params and batch stats as
above (apart, as ``params`` and ``model_state``), the optax momentum
``trace`` or adam's ``mu`` and ``nu`` with each kernel transposed like its
weight, the optimizer's update count, and the EMA's ``count`` and
``ema``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from tensor2robot_tpu_torch.models.abstract_model import TrainState

__all__ = ['from_flax', 'train_state_from_flax']


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
  return {name: torch.from_numpy(np.array(value, np.float32, order='C'))
          for name, value in state.items()}


def from_flax(variables) -> Dict[str, Dict[str, torch.Tensor]]:
  """The port's ``variables`` from flax ``variables`` (see module doc)."""
  batch_stats = variables.get('batch_stats')
  out = {'params': _state_dict(variables['params'], batch_stats)}
  if variables.get('avg_params') is not None:
    out['avg_params'] = _state_dict(variables['avg_params'], batch_stats)
  return out


def _field(tree, name: str):
  """The first ``name`` field of an optax state (nested tuples of named
  tuples), or None."""
  if name in getattr(tree, '_fields', ()):
    return getattr(tree, name)
  if isinstance(tree, (tuple, list)):
    for item in tree:
      found = _field(item, name)
      if found is not None:
        return found
  return None


def _count(value) -> torch.Tensor:
  return torch.tensor(int(np.asarray(value)), dtype=torch.int32)


def train_state_from_flax(state: Any):
  """The port's ``TrainState`` (CPU tensors) from a JAX ``TrainState``
  given as numpy trees (``jax.tree_util.tree_map(np.asarray, state)``)."""
  batch_stats = (state.model_state or {}).get('batch_stats')
  count = _field(state.opt_state, 'count')
  moments = {name: _field(state.opt_state, name)
             for name in ('trace', 'mu', 'nu')}
  if count is not None and moments['trace'] is not None:
    opt_state = {'count': _count(count),
                 'trace': _state_dict(moments['trace'], None)}
  elif count is not None and None not in (moments['mu'], moments['nu']):
    opt_state = {'count': _count(count),
                 'mu': _state_dict(moments['mu'], None),
                 'nu': _state_dict(moments['nu'], None)}
  else:
    raise ValueError('The optimizer state holds neither a momentum trace '
                     'nor adam moments with an update count; only the '
                     'momentum and adam optimizers convert.')
  avg_params = ema_state = None
  if state.avg_params is not None:
    avg_params = _state_dict(state.avg_params, None)
    ema_state = {'count': _count(state.ema_state.count),
                 'ema': _state_dict(state.ema_state.ema, None)}
  return TrainState(
      step=int(np.asarray(state.step)),
      params=_state_dict(state.params, None),
      model_state=_state_dict({}, batch_stats),
      opt_state=opt_state,
      avg_params=avg_params, ema_state=ema_state)
