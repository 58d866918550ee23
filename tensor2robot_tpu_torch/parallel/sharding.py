"""Model-parallel parameter rules: the JAX package's ``parallel/sharding.py``
as far as one card goes.

A rule is ``(pattern, axes)``: a regular expression over a parameter's
path (flax's, ``params/transformer/block0/moe/w_in``) and the axis each of
its dims is sharded over (None: not sharded). As in JAX's
``tp_param_spec``, a rule declines where an axis it names has no group of
more than one rank in the run, or does not divide the dim; a parameter
that no rule takes stays whole. The port has no expert, model or pipe
group yet (the next slice brings them), so ``EP_RULES_MOE`` declines on
every run, as JAX's declines on a mesh without an expert axis; a rule
that would shard raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ['EP_RULES_MOE', 'EXPERT_AXIS', 'check_rules_decline',
           'param_path', 'param_rule']

EXPERT_AXIS = 'expert'

Rule = Tuple[str, Tuple[Optional[str], ...]]

# The stacked per-expert MLP kernels shard their leading expert dim; the
# router stays whole.
EP_RULES_MOE: Tuple[Rule, ...] = (
    (r'.*/moe/w_in$', (EXPERT_AXIS, None, None)),
    (r'.*/moe/w_out$', (EXPERT_AXIS, None, None)),
)


def param_path(name: str) -> str:
  """The flax path of a state-dict name: ``params/`` and ``/`` for ``.``,
  the kernels under flax's leaf name."""
  *path, leaf = name.split('.')
  return '/'.join(['params'] + path + ['kernel' if leaf == 'weight'
                                       else leaf])


def param_rule(path: str, shape: Sequence[int], rules: Sequence[Rule],
               axis_sizes: Mapping[str, int]) -> Optional[Rule]:
  """The first rule that matches ``path`` and shards it (JAX's
  ``tp_param_spec``), or None."""
  for pattern, axes in rules:
    if not re.match(pattern, path) or len(axes) > len(shape):
      continue
    sharded = [(dim, axis) for dim, axis in enumerate(axes)
               if axis is not None]
    if sharded and all(axis_sizes.get(axis, 1) > 1 and
                       shape[dim] % axis_sizes[axis] == 0
                       for dim, axis in sharded):
      return pattern, tuple(axes)
  return None


def check_rules_decline(params: Dict[str, torch.Tensor],
                        rules: Sequence[Rule],
                        axis_sizes: Mapping[str, int]) -> None:
  """Raises NotImplementedError, naming the parameter and the rule, where
  a rule would shard one of ``params`` over the run's groups
  (``axis_sizes``: axis -> ranks)."""
  for name, value in params.items():
    rule = param_rule(param_path(name), tuple(value.shape), rules,
                      axis_sizes)
    if rule is not None:
      raise NotImplementedError(
          'Rule {} would shard {} over {}: sharded parameters are not '
          'ported yet (the next slice: expert, tensor and pipeline '
          'parallelism).'.format(rule, name, dict(axis_sizes)))
