"""Converts the JAX package's flax variables into the port's variables.

``from_flax`` takes ``{'params', 'batch_stats', 'avg_params'}`` as nested
dicts of numpy arrays, as ``jax.tree_util.tree_map(np.asarray, variables)``
gives them, and returns ``{'params': state_dict, 'avg_params':
state_dict}`` (``avg_params`` only where the input has it). Module paths
keep their flax names joined by dots (``grasping44.conv2``); the leaves map
as:

  * conv ``kernel`` HWIO -> ``weight`` OIHW (``transpose(3, 2, 0, 1)``),
    a 1-D conv's [k, in, out] -> [out, in, k] (``transpose(2, 1, 0)``);
  * dense ``kernel`` [in, out] -> ``weight`` [out, in];
  * ``bias``, batch and layer norm ``scale``, the transformer's
    ``pos_embedding`` and an ``nn.Embed``'s ``embedding`` keep their names;
  * ``batch_stats`` ``mean`` / ``var`` join the state dict of both
    ``params`` and ``avg_params`` (the EMA averages weights only).

The port's modules carry the flax names, so the networks map leaf for
leaf: the Grasping44 critic (fc0 needs no row permutation: the port
flattens final_conv in the same H, W, C order as the JAX network),
``RT1StyleNet`` (``tokenizer.conv{i}``, ``ln{i}``, ``embed``,
``token_learner.{ln,map_in,map_out}``; ``transformer.pos_embedding``,
``block{i}.{ln_attn,attn.qkv,attn.out,ln_mlp,mlp_in,mlp_out}``,
``ln_final``; ``action_head`` and, where configured, ``task_embedding``
and ``state_token``), and the off-policy tests' sim critic
(``research/qtopt/grasping_sim.SimQNet``: ``Conv_0``, ``Conv_1`` and
``Dense_0`` to ``Dense_3``, its flatten in the same H, W, C order). The
attention mode does not change the weights: a model trained with ring
attention (JAX's ``mesh=``, the port's ``process_group=``) has the flash
model's state dict, and each rank holds all of it.

The same rules carry Grasp2Vec's two towers (``scene.resnet.*`` and
``goal.resnet.*``: ``layers/resnet.py`` keeps flax's names, the conv
kernels HWIO -> OIHW, the batch norms' statistics beside them) and the
MAML models' parameters: the base network's leaves under their names, and
where the inner rates are learned (JAX's ``{'base', 'maml_inner_lrs'}``)
the base tree at the root and each rate, a scalar, under
``maml_inner_lrs.<name>`` (a ``kernel``'s rate as ``weight``, untouched).
The vrgripper and Watch-Try-Learn networks map the same way: their 1-D
convs (TEC's temporal reduction, SNAIL's causal convs, the learned loss)
as above, and the leaves that flax names by a parameter call keep their
names and layout (MAF's ``masked_dense_{i}_kernel`` [in, out], the MDN's
``mdn_stddev_inputs``, the pose nets' ``bias_transform``).

``train_state_from_flax`` builds the port's ``TrainState`` from a JAX
``TrainState`` whose leaves are numpy arrays: params and batch stats as
above (apart, as ``params`` and ``model_state``), the optimizer's update
count and moments (momentum's ``trace``, rmsprop's ``trace`` and ``nu``,
adam's ``mu`` and ``nu``; sgd has none) with each kernel transposed like
its weight, and the EMA's ``count`` and ``ema``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from tensor2robot_tpu_torch.meta_learning.maml_model import INNER_LRS_KEY
from tensor2robot_tpu_torch.models.abstract_model import TrainState

__all__ = ['from_flax', 'train_state_from_flax']


def _leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix, key, np.asarray(value)


def _maml_tree(tree):
  """A MAML model's tree with learned inner rates, ``{'base': ...,
  'maml_inner_lrs': ...}``, as the port names it: the base network's
  leaves at the root, the rates under ``maml_inner_lrs``."""
  if isinstance(tree, Mapping) and set(tree) == {'base', INNER_LRS_KEY}:
    return {**tree['base'], INNER_LRS_KEY: tree[INNER_LRS_KEY]}
  return tree


def _state_dict(params, batch_stats) -> Dict[str, torch.Tensor]:
  state = {}
  for path, leaf, value in _leaves(_maml_tree(params or {})):
    if leaf == 'kernel' and path[:1] == (INNER_LRS_KEY,):
      if value.ndim:
        raise ValueError('A learned inner rate is a scalar; {} is {}.'
                         .format('/'.join(path + (leaf,)), value.shape))
      leaf = 'weight'
    elif leaf == 'kernel':
      if value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
      elif value.ndim == 3:
        value = value.transpose(2, 1, 0)
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
  if count is None:
    raise ValueError('The optimizer state holds no update count; only the '
                     'sgd, momentum, rmsprop and adam optimizers convert.')
  # sgd keeps only the count; momentum adds a trace, rmsprop a trace and
  # nu, adam mu and nu.
  opt_state = {'count': _count(count)}
  for name in ('trace', 'mu', 'nu'):
    if moments[name] is not None:
      opt_state[name] = _state_dict(moments[name], None)
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
