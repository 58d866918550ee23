"""Sampling policies: which resident examples a replay draw returns (a copy
of the JAX package's ``replay/sampling.py``; numpy ``RandomState`` draws, so
that the same seed draws the same slots).

A policy draws slot indices against one shard's ``(ids, priorities)``
snapshot; the service fetches by the stable ids, so a ring slide between the
snapshot and the fetch skips a dead id instead of resolving a slot to its
neighbour. Draws are with replacement.

  * ``uniform``: every resident example equally likely.
  * ``prioritized``: P(i) proportional to priority_i ** alpha (Schaul et
    al., arXiv 1511.05952); alpha 0 is uniform. All-zero priorities fall
    back to uniform.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ['SamplePolicy', 'UniformPolicy', 'PrioritizedPolicy',
           'make_policy', 'POLICIES']

POLICIES = ('uniform', 'prioritized')


class SamplePolicy:
  """Draws ``count`` slot indices against one priority snapshot."""

  name = 'abstract'

  def draw(self, priorities: np.ndarray, count: int,
           rng: np.random.RandomState) -> List[int]:
    raise NotImplementedError


class UniformPolicy(SamplePolicy):

  name = 'uniform'

  def draw(self, priorities: np.ndarray, count: int,
           rng: np.random.RandomState) -> List[int]:
    if priorities.size == 0:
      return []
    return rng.randint(0, priorities.size, size=count).tolist()


class PrioritizedPolicy(SamplePolicy):
  """P(i) ∝ priority_i ** alpha over the snapshot handed in per draw."""

  name = 'prioritized'

  def __init__(self, alpha: float = 0.6):
    if alpha < 0.0:
      raise ValueError('alpha must be >= 0; got {}.'.format(alpha))
    self.alpha = float(alpha)

  def draw(self, priorities: np.ndarray, count: int,
           rng: np.random.RandomState) -> List[int]:
    if priorities.size == 0:
      return []
    weights = np.power(np.maximum(priorities, 0.0), self.alpha)
    total = float(weights.sum())
    if total <= 0.0:  # all-zero priorities: degrade to uniform, not a crash
      return rng.randint(0, priorities.size, size=count).tolist()
    return rng.choice(priorities.size, size=count, replace=True,
                      p=weights / total).tolist()


def make_policy(name: str, alpha: float = 0.6) -> SamplePolicy:
  if name == 'uniform':
    return UniformPolicy()
  if name == 'prioritized':
    return PrioritizedPolicy(alpha=alpha)
  raise ValueError('unknown sampling policy {!r}; have {}.'.format(
      name, POLICIES))
