"""The vectorized environment contract (the JAX package's ``envs/vec_env.py``).

A ``VecEnv`` advances B env slots at once, on its device, with explicit
state:

  * ``reset(seed=None) -> (state, obs)``: ``state`` holds tensors with a
    leading ``num_envs`` dim; ``obs`` is a flat ``{name: tensor}`` dict,
    batch-leading too.
  * ``step(state, action) -> VecStep(state, obs, reward, done, info)``
    advances every slot one step and **auto-resets** finished slots:
    ``obs`` is what the policy acts on next (the fresh episode's first
    observation wherever ``done``), while ``info['next_obs']`` is the
    pre-reset successor, the one a replay transition records (a timeout
    bootstraps through the time limit, ``done=0`` on the wire, and so
    consumes its true successor).

``done`` marks "this episode ended" (terminal or timeout);
``info['terminal']`` marks "the environment itself terminated" (a grasp was
attempted). Only ``terminal`` is written to replay as ``done``.

The JAX contract carries per-slot PRNG keys in the state; the port's env
draws from a ``torch.Generator`` of its own on its device instead.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, NamedTuple, Tuple

__all__ = ['VecEnv', 'VecStep']


class VecStep(NamedTuple):
  """One vectorized transition; every field is batch-leading.

  Attributes:
    state: the env state AFTER auto-reset.
    obs: the observation to act on next (after auto-reset).
    reward: [B] float32 immediate rewards.
    done: [B] bool, the episode ended this step (terminal or timeout).
    info: extras; the contract requires ``terminal`` ([B] bool, written to
      replay as ``done``) and ``next_obs`` (the pre-reset successor
      observation dict).
  """

  state: Any
  obs: Dict[str, Any]
  reward: Any
  done: Any
  info: Dict[str, Any]


class VecEnv(abc.ABC):
  """Abstract vectorized environment (module docstring)."""

  @property
  @abc.abstractmethod
  def num_envs(self) -> int:
    """B, the number of env slots advanced per step call."""

  @abc.abstractmethod
  def reset(self, seed=None) -> Tuple[Any, Dict[str, Any]]:
    """Fresh episodes in every slot; returns ``(state, obs)``."""

  @abc.abstractmethod
  def step(self, state, action) -> VecStep:
    """Advances every slot one step, auto-resetting finished ones."""
