"""The 2D pusher: an environment with dynamics for the RL loop (the JAX
package's ``research/pusher_env.py``).

A point object with momentum is pushed around a walled arena by force
actions, with process noise and inelastic wall contact. Per step:

    v' = damping * v + dt * force_scale * clip(a, -1, 1) + noise
    p' = clip(p + dt * v', arena);  v' := 0 on the clipped axes (contact)
    reward = 1 - ||p' - goal|| / diameter          # in [0, 1]

The observation is the low-dim state (position, velocity, goal). The env
and its policies draw from numpy ``RandomState``s of their own, in the JAX
module's order, so that one seed gives the same transitions bit for bit.
``PusherCriticModel`` is the Q(s, a) critic on the port's ``CriticModel``:
a 64-wide MLP (``_PusherQNet``, flax's lecun-normal ``Dense`` kernels and
zero biases) trained against the shaped reward; it reaches no kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.layers.basic import Dense
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    NoOpPreprocessor)
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['ACTION_SIZE', 'PusherCriticModel', 'PusherCriticPolicy',
           'PusherEnv', 'PusherRandomPolicy', 'STATE_SIZE',
           'episode_to_transitions_pusher']

STATE_SIZE = 6    # position (2) + velocity (2) + goal (2)
ACTION_SIZE = 2
_DIAMETER = 2.0 * np.sqrt(2.0)


class PusherEnv:
  """Gym-style 2D pusher (``reset() -> obs``; ``step(a) -> obs, r, done,
  debug``)."""

  def __init__(self, episode_length: int = 8, dt: float = 0.25,
               damping: float = 0.85, force_scale: float = 1.6,
               noise_std: float = 0.02, seed: Optional[int] = None):
    self._episode_length = episode_length
    self._dt = dt
    self._damping = damping
    self._force_scale = force_scale
    self._noise_std = noise_std
    self._rng = np.random.RandomState(seed)
    self._p = np.zeros(2)
    self._v = np.zeros(2)
    self._goal = np.zeros(2)
    self._t = 0

  def _obs(self) -> np.ndarray:
    return np.concatenate([self._p, self._v, self._goal]).astype(np.float32)

  def reset(self) -> np.ndarray:
    self._p = self._rng.uniform(-0.8, 0.8, 2)
    self._v = np.zeros(2)
    self._goal = self._rng.uniform(-0.8, 0.8, 2)
    while np.linalg.norm(self._goal - self._p) < 0.5:
      self._goal = self._rng.uniform(-0.8, 0.8, 2)
    self._t = 0
    return self._obs()

  def step(self, action):
    action = np.clip(np.asarray(action, np.float64).ravel()[:2], -1.0, 1.0)
    self._v = (self._damping * self._v + self._dt * self._force_scale *
               action + self._rng.randn(2) * self._noise_std)
    p_new = self._p + self._dt * self._v
    clipped = np.clip(p_new, -1.0, 1.0)
    self._v[clipped != p_new] = 0.0   # inelastic wall contact
    self._p = clipped
    self._t += 1
    reward = 1.0 - np.linalg.norm(self._p - self._goal) / _DIAMETER
    done = self._t >= self._episode_length
    return self._obs(), float(reward), done, {}

  def close(self):
    pass


class PusherRandomPolicy:
  """Uniform random forces (the collect loop's policy protocol)."""

  def __init__(self, seed: Optional[int] = None):
    self._rng = np.random.RandomState(seed)

  def reset(self):
    pass

  def restore(self) -> bool:
    return True

  def init_randomly(self) -> None:
    pass

  @property
  def global_step(self) -> int:
    return 0

  def sample_action(self, obs, explore_prob):
    del obs, explore_prob
    return self._rng.uniform(-1.0, 1.0, ACTION_SIZE), None


class PusherCriticPolicy:
  """The best of ``num_samples`` uniform actions by the predictor's q."""

  def __init__(self, predictor, num_samples: int = 128,
               seed: Optional[int] = None):
    self._predictor = predictor
    self._num_samples = num_samples
    self._rng = np.random.RandomState(seed)

  def reset(self):
    pass

  def restore(self) -> bool:
    return self._predictor.restore()

  def init_randomly(self) -> None:
    self._predictor.init_randomly()

  @property
  def global_step(self) -> int:
    return self._predictor.global_step

  def sample_action(self, obs, explore_prob):
    del explore_prob
    actions = self._rng.uniform(-1.0, 1.0,
                                (self._num_samples, ACTION_SIZE))
    states = np.tile(np.asarray(obs, np.float32)[None, :],
                     (self._num_samples, 1))
    out = self._predictor.predict({'state/obs': states,
                                   'action/force':
                                       actions.astype(np.float32)})
    q = np.asarray(out['q_predicted']).ravel()
    return actions[int(np.argmax(q))], {'q': float(q.max())}


def episode_to_transitions_pusher(episode_data) -> List[bytes]:
  """``(obs, action, reward, obs_tp1, done, debug)`` steps -> serialized
  tf.Examples of ``state``, ``action`` and ``reward``."""
  transitions = []
  for obs_t, action, reward, _obs_tp1, _done, _debug in episode_data:
    transitions.append(wire.build_example({
        'state': np.asarray(obs_t, np.float32).ravel(),
        'action': np.asarray(action, np.float32).ravel(),
        'reward': np.asarray([reward], np.float32),
    }))
  return transitions


class _PusherQNet(nn.Module):
  """An MLP over concat(state, action) -> the logit and q in [0, 1], under
  flax's auto-names (``Dense_0`` .. ``Dense_2``)."""

  def __init__(self, hidden: int = 64):
    super().__init__()
    self.Dense_0 = Dense(STATE_SIZE + ACTION_SIZE, hidden)
    self.Dense_1 = Dense(hidden, hidden)
    self.Dense_2 = Dense(hidden, 1)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    del mode
    x = torch.cat([torch.as_tensor(features['state/obs']).to(torch.float32),
                   torch.as_tensor(features['action/force']).to(
                       torch.float32)], dim=-1)
    x = F.relu(self.Dense_0(x))
    x = F.relu(self.Dense_1(x))
    logits = self.Dense_2(x)
    return {'q_logits': logits, 'q_predicted': torch.sigmoid(logits)}


class PusherCriticModel(CriticModel):
  """Q(s, a) against the env's shaped reward in [0, 1] (sigmoid cross
  entropy), on ``cuda`` unless given ``device='cpu'``."""

  def __init__(self, **kwargs):
    kwargs.setdefault('preprocessor_cls', NoOpPreprocessor)
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(**kwargs)

  def get_state_specification(self) -> Dict[str, TensorSpec]:
    return {'obs': TensorSpec((STATE_SIZE,), np.float32, name='state')}

  def get_action_specification(self) -> Dict[str, TensorSpec]:
    return {'force': TensorSpec((ACTION_SIZE,), np.float32, name='action')}

  def get_label_specification(self, mode: str) -> Dict[str, TensorSpec]:
    del mode
    return {'reward': TensorSpec((1,), np.float32, name='reward')}

  def create_network(self) -> nn.Module:
    return _PusherQNet()
