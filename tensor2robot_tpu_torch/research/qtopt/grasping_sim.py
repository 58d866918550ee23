"""A synthetic visual grasping MDP whose optimal Q-function is known: the
off-policy testbed (the JAX package's ``research/qtopt/grasping_sim.py``).

The MDP, in the Grasping44 action layout (``t2r_models.ACTION_DIM_LAYOUT``):

  * State: the gripper at height ``h`` above an object
    (``height_to_bottom`` in the observation, drawn into the camera frame).
  * ``close_gripper > 0.5`` ends the episode, a terminal, with reward
    ``1 if h <= threshold else 0``.
  * Otherwise the vertical component of ``world_vector`` moves the gripper:
    ``h' = clip(h - descent_scale * clip(wv_z, -1, 1), 0, h_max)`` with
    reward 0, for up to ``episode_length`` steps. A timeout is written with
    ``done=0`` (the target bootstraps through a time limit); only a terminal
    carries ``done=1``.

With ``n(h) = ceil(max(0, h - threshold) / descent_scale)``:
``V*(h) = gamma ** n(h)``, ``Q*(h, close) = 1 if h <= threshold else 0`` and
``Q*(h, no close) = gamma * V*(h')``. Q* of a state two steps out exists
only once value has passed through two lagged target networks.

The environment and the random policy are numpy with ``RandomState``, line
for line the JAX package's, so that the same seed gives the same pixels,
rewards, terminals and dones bit for bit; the records are the JAX
package's bytes (PIL's JPEG at its default quality). The Bellman target's
candidate actions are drawn from a ``torch.Generator`` (they cannot be
JAX's draws), and ``make_sim_critic_model`` is the test-scale critic whose
flax weights ``convert.from_flax`` carries over name for name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    ACTION_DIM_LAYOUT)
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.utils.image import numpy_to_image_string

__all__ = ['CLOSE_INDEX', 'DONE_NAME', 'GAMMA', 'H_MAX', 'OPEN_INDEX',
           'SimGraspingEnv', 'SimGraspingRandomPolicy', 'TERMINATE_INDEX',
           'THRESHOLD', 'WV_Z_INDEX', 'build_ranking_pairs',
           'episode_to_transitions_grasping', 'gradient_background',
           'make_candidate_actions_fn', 'make_sim_critic_model',
           'offpolicy_extra_feature_specs', 'optimal_value',
           'steps_to_grasp']

# Balanced under random exploration: heights are about uniform over
# [0, H_MAX] in steady state, so P(h <= THRESHOLD) is about 0.4.
THRESHOLD = 0.5
DESCENT_SCALE = 0.35
H_MAX = 1.6
GAMMA = 0.8


def action_dim_offset(name: str) -> int:
  """Start of one ``ACTION_DIM_LAYOUT`` block in the flat CEM vector."""
  offset = 0
  for key, size in ACTION_DIM_LAYOUT:
    if key == name:
      return offset
    offset += size
  raise KeyError(name)


WV_Z_INDEX = action_dim_offset('world_vector') + 2
CLOSE_INDEX = action_dim_offset('close_gripper')
OPEN_INDEX = action_dim_offset('open_gripper')
TERMINATE_INDEX = action_dim_offset('terminate_episode')
# The action keys of the flagship critic after the 8 CEM dims: the gripper
# status, read from the (next) state.
STATE_ACTION_KEYS = ('gripper_closed', 'height_to_bottom')


def steps_to_grasp(h: float, threshold: float = THRESHOLD,
                   descent_scale: float = DESCENT_SCALE) -> int:
  return int(math.ceil(max(0.0, h - threshold) / descent_scale))


def optimal_value(h: float, gamma: float = GAMMA, **kwargs) -> float:
  return gamma ** steps_to_grasp(h, **kwargs)


def _action_vector(wv_z: float = 0.0, close: float = 0.0) -> np.ndarray:
  """The 8-dim CEM action with its descent and close dims set."""
  action = np.zeros((8,), np.float32)
  action[WV_Z_INDEX] = wv_z
  action[CLOSE_INDEX] = close
  return action


def gradient_background(height: int, width: int) -> np.ndarray:
  """The camera frame's background, float32 [H, W, 3]."""
  x = np.linspace(0, 1, width)
  y = np.linspace(0, 1, height)
  return (np.outer(y, x)[..., None]
          * np.array([140, 160, 180])).astype(np.float32)


class SimGraspingEnv:
  """Gym-style visual grasping env: ``reset() -> obs``, ``step(a) -> (obs,
  reward, done, info)``.

  Observations are the flagship critic's serving state: ``image`` uint8
  [H, W, 3], ``gripper_closed`` and ``height_to_bottom`` scalars.
  ``info['terminal']`` tells a grasp attempt from a timeout.
  ``safe_region`` ((y0, y1), (x0, x1)) is the pixel box that every train
  crop keeps; the scene stays inside it (512x640 -> 472x472 by default).
  """

  def __init__(self,
               height: int = 512,
               width: int = 640,
               episode_length: int = 3,
               threshold: float = THRESHOLD,
               descent_scale: float = DESCENT_SCALE,
               safe_region: Optional[Tuple[Tuple[int, int],
                                           Tuple[int, int]]] = None,
               noise_scale: float = 4.0,
               seed: Optional[int] = None):
    self._height = height
    self._width = width
    self._episode_length = episode_length
    self._threshold = threshold
    self._descent_scale = descent_scale
    self._noise_scale = float(noise_scale)
    if safe_region is None:
      if (height, width) == (512, 640):
        safe_region = ((40, 472), (168, 472))
      else:
        safe_region = ((0, height), (0, width))
    self._safe = safe_region
    self._rng = np.random.RandomState(seed)
    self._h = 0.0
    self._t = 0
    self._background = None

  @property
  def threshold(self) -> float:
    return self._threshold

  @property
  def descent_scale(self) -> float:
    return self._descent_scale

  def _render(self, h: float) -> np.ndarray:
    """Gradient and noise, the object block, the gripper at height h."""
    height, width = self._height, self._width
    if self._background is None:
      self._background = gradient_background(height, width)
    img = self._background.copy()
    (y0, y1), (x0, x1) = self._safe
    band_h, band_w = y1 - y0, x1 - x0
    block = max(6, band_h // 14)
    cx = x0 + band_w // 2
    # The object sits at the bottom of the safe band.
    obj_y = y1 - 2 * block
    img[obj_y:obj_y + block, cx - block:cx + block] = (200, 40, 40)
    # Height h in [0, H_MAX] maps to the band above the object.
    frac = min(max(h / H_MAX, 0.0), 1.0)
    grip_y = int(obj_y - block - frac * (band_h - 4 * block))
    grip_y = max(y0, grip_y)
    img[grip_y:grip_y + block, cx - block // 2:cx + block // 2] = (
        40, 200, 60)
    if self._noise_scale:
      img = img + self._rng.randn(height, width, 1) * self._noise_scale
    return np.clip(img, 0, 255).astype(np.uint8)

  def _obs(self) -> dict:
    return {'image': self._render(self._h),
            'gripper_closed': 0.0,
            'height_to_bottom': float(self._h)}

  def reset(self) -> dict:
    self._h = float(self._rng.uniform(0.1, 1.1))
    self._t = 0
    return self._obs()

  def step(self, action):
    action = np.asarray(action, np.float32).ravel()
    close = float(action[CLOSE_INDEX]) > 0.5
    self._t += 1
    if close:
      reward = 1.0 if self._h <= self._threshold else 0.0
      return self._obs(), reward, True, {'terminal': True}
    wv_z = float(np.clip(action[WV_Z_INDEX], -1.0, 1.0))
    self._h = float(np.clip(self._h - self._descent_scale * wv_z,
                            0.0, H_MAX))
    timeout = self._t >= self._episode_length
    return self._obs(), 0.0, timeout, {'terminal': False}

  def close(self):
    pass


class SimGraspingRandomPolicy:
  """Random exploration (the policy protocol of ``collect_eval_loop``)."""

  def __init__(self, close_prob: float = 0.4, seed: Optional[int] = None):
    self._close_prob = close_prob
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
    action = self._rng.uniform(-1.0, 1.0, 8).astype(np.float32)
    action[CLOSE_INDEX] = float(self._rng.rand() < self._close_prob)
    action[OPEN_INDEX] = float(self._rng.rand() < 0.5)
    action[TERMINATE_INDEX] = 0.0
    return action, None


# -- replay records ----------------------------------------------------------

# The on-disk names of the off-policy extras; the state's own follow the
# flagship critic's specifications ('image_1', the action keys).
NEXT_IMAGE_NAME = 'next/image_1'
NEXT_GRIPPER_CLOSED_NAME = 'next/gripper_closed'
NEXT_HEIGHT_NAME = 'next/height_to_bottom'
DONE_NAME = 'done'


def offpolicy_extra_feature_specs(image_spec: TensorSpec
                                  ) -> Dict[str, TensorSpec]:
  """The parsing specifications of the next state and ``done``, the next
  frame's a copy of ``image_spec`` under its own name. Keyed so that
  ``rl.offpolicy.split_offpolicy_batch`` renames ``next/<key>`` back to the
  critic's keys."""
  fields = dict(image_spec.fields(), name=NEXT_IMAGE_NAME)
  return {
      'next/state/image': TensorSpec(image_spec.shape, image_spec.dtype,
                                     **fields),
      'next/action/gripper_closed': TensorSpec(
          (1,), np.float32, name=NEXT_GRIPPER_CLOSED_NAME),
      'next/action/height_to_bottom': TensorSpec(
          (1,), np.float32, name=NEXT_HEIGHT_NAME),
      DONE_NAME: TensorSpec((1,), np.float32, name=DONE_NAME),
  }


def episode_to_transitions_grasping(episode_data,
                                    image_name: str = 'image_1',
                                    reward_name: str = 'grasp_success'
                                    ) -> List[bytes]:
  """An episode's ``(obs, action, reward, next_obs, done, info)`` steps as
  serialized transition Examples. ``done`` is ``info['terminal']`` (was a
  grasp attempted), not whether the episode stopped."""
  transitions = []
  for obs, action, reward, next_obs, _done, info in episode_data:
    terminal = bool(info.get('terminal', False))
    example = {
        image_name: numpy_to_image_string(obs['image'], 'jpeg'),
        NEXT_IMAGE_NAME: numpy_to_image_string(next_obs['image'], 'jpeg'),
        NEXT_GRIPPER_CLOSED_NAME: np.asarray(
            [next_obs['gripper_closed']], np.float32),
        NEXT_HEIGHT_NAME: np.asarray(
            [next_obs['height_to_bottom']], np.float32),
        DONE_NAME: np.asarray([1.0 if terminal else 0.0], np.float32),
        reward_name: np.asarray([reward], np.float32),
    }
    flat_action = np.asarray(action, np.float32).ravel()
    offset = 0
    for key, size in ACTION_DIM_LAYOUT:
      example[key] = flat_action[offset:offset + size]
      offset += size
    example['gripper_closed'] = np.asarray(
        [obs['gripper_closed']], np.float32)
    example['height_to_bottom'] = np.asarray(
        [obs['height_to_bottom']], np.float32)
    transitions.append(wire.build_example(example))
  return transitions


def make_candidate_actions_fn(num_candidates: int):
  """Uniform candidates for the Bellman target's max (``rl/offpolicy.py``).

  Returns ``candidate_actions(generator, batch, next_features)``: every
  Grasping44 action key as [B*K, size] tensors on the next state's device,
  state-major (row b*K + j is state b's j-th candidate), drawn from
  ``generator`` (on that device): world_vector and vertical_rotation
  uniform in [-1, 1), close and open 0 or 1 with even odds, terminate 0;
  the gripper status keys repeat the next state's values.
  """

  def candidate_actions(generator: torch.Generator, batch: int,
                        next_features) -> Dict[str, torch.Tensor]:
    k = num_candidates
    n = batch * k
    device = next_features['action/height_to_bottom'].device

    def uniform(width):
      return torch.rand((n, width), generator=generator,
                        device=device) * 2.0 - 1.0

    out = {'action/world_vector': uniform(3),
           'action/vertical_rotation': uniform(2)}
    disc = (torch.rand((n, 3), generator=generator, device=device) <
            0.5).to(torch.float32)
    out['action/close_gripper'] = disc[:, 0:1]
    out['action/open_gripper'] = disc[:, 1:2]
    out['action/terminate_episode'] = torch.zeros((n, 1), device=device)
    for key in STATE_ACTION_KEYS:
      out['action/' + key] = torch.as_tensor(
          next_features['action/' + key], dtype=torch.float32).reshape(
              batch, 1).repeat_interleave(k, dim=0)
    return out

  return candidate_actions


# -- the test-scale critic ---------------------------------------------------


class SimImagePreprocessor:
  """uint8 frames (JPEG on disk) at the critic's resolution to float32 in
  [0, 1]; the other features pass through. Draws nothing, in any mode."""

  def __init__(self, feature_spec_fn, label_spec_fn):
    self._feature_spec_fn = feature_spec_fn
    self._label_spec_fn = label_spec_fn

  def get_in_feature_specification(self, mode: str) -> Dict[str, tuple]:
    spec = dict(self._feature_spec_fn(mode))
    image = spec['state/image']
    spec['state/image'] = TensorSpec(image.shape, np.uint8, name=image.name,
                                     data_format='jpeg')
    return spec

  def get_in_label_specification(self, mode: str) -> Dict[str, tuple]:
    return dict(self._label_spec_fn(mode))

  def preprocess(self, features, labels, mode: str, **unused_draws):
    del mode, unused_draws
    features = dict(features)
    features['state/image'] = torch.as_tensor(
        features['state/image']).to(torch.float32) / 255.0
    return features, labels


class SimQNet(nn.Module):
  """The JAX package's ``SimQNet``, under its flax names: two 3x3 stride-2
  SAME convs (8 and 16 channels) with ReLU, Dense_0 (the state embedding),
  Dense_1 (the action embedding), Dense_2 and the logit Dense_3. With
  B*K action rows for B images the image tower runs once a state and each
  state's K rows score against its embedding (the megabatch contract of
  ``GraspingQNetwork``)."""

  def __init__(self, height: int, width: int, hidden: int = 64):
    super().__init__()
    self.Conv_0 = networks.Conv(3, 8, 3, stride=2, bias=True)
    self.Conv_1 = networks.Conv(8, 16, 3, stride=2, bias=True)
    # Each SAME stride-2 conv takes a dim n to ceil(n / 2).
    def out(n):
      return -(-(-(-n // 2)) // 2)

    flat = 16 * out(height) * out(width)
    action_dim = sum(size for _, size in ACTION_DIM_LAYOUT) + len(
        STATE_ACTION_KEYS)
    self.Dense_0 = networks.Dense(flat, hidden)
    self.Dense_1 = networks.Dense(action_dim, hidden)
    self.Dense_2 = networks.Dense(2 * hidden, hidden)
    self.Dense_3 = networks.Dense(hidden, 1)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    del mode
    image = torch.as_tensor(features['state/image']).to(torch.float32)
    keys = [k for k, _ in ACTION_DIM_LAYOUT] + list(STATE_ACTION_KEYS)
    params = torch.cat(
        [torch.as_tensor(features['action/' + key]).to(torch.float32)
         .reshape(features['action/' + key].shape[0], -1) for key in keys],
        dim=-1)
    x = image.permute(0, 3, 1, 2)
    for conv in (self.Conv_0, self.Conv_1):
      x = F.relu(conv(x))
    # Flattened in (H, W, C) order, as the NHWC flax network flattens.
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(self.Dense_0(x))
    batch = x.shape[0]
    if params.shape[0] != batch:
      params = params.reshape(batch, -1, params.shape[-1])
      x = x[:, None, :].expand(batch, params.shape[1], x.shape[-1])
    h = torch.cat([x, F.relu(self.Dense_1(params))], dim=-1)
    h = F.relu(self.Dense_2(h))
    logits = self.Dense_3(h).reshape(-1)
    return {'q_logits': logits, 'q_predicted': torch.sigmoid(logits)}


class SimGraspingCriticModel(CriticModel):
  """The test-scale critic over ``SimGraspingEnv`` observations: the
  flagship's keys and on-disk names at any resolution, ``SimQNet``, flax's
  default initializers (lecun normal kernels, zero biases)."""

  def __init__(self, height: int = 64, width: int = 80, **kwargs):
    self._height, self._width = height, width
    kwargs.setdefault('preprocessor_cls', SimImagePreprocessor)
    super().__init__(**kwargs)

  def get_state_specification(self) -> Dict[str, tuple]:
    return {'image': TensorSpec((self._height, self._width, 3), np.float32,
                                name='image_1')}

  def get_action_specification(self) -> Dict[str, tuple]:
    return {key: TensorSpec((size,), np.float32, name=key) for key, size in
            ACTION_DIM_LAYOUT + tuple((k, 1) for k in STATE_ACTION_KEYS)}

  def get_label_specification(self, mode: str) -> Dict[str, tuple]:
    del mode
    return {'reward': TensorSpec((1,), np.float32, name='grasp_success')}

  def create_network(self) -> nn.Module:
    return SimQNet(self._height, self._width)


def make_sim_critic_model(height: int = 64, width: int = 80,
                          **kwargs) -> SimGraspingCriticModel:
  """The test-scale critic (``SimGraspingCriticModel``); the flagship
  critic is what trains at the camera's resolution."""
  return SimGraspingCriticModel(height, width, **kwargs)


# -- the held-out criterion --------------------------------------------------


def build_ranking_pairs(env: SimGraspingEnv,
                        per_type: int = 32,
                        seed: int = 7,
                        gamma: float = GAMMA
                        ) -> Sequence[Tuple[dict, dict]]:
  """(better, worse) feature batches whose Q* order is known with margin.

  Three families, deeper and deeper in bootstrap:
    1. at the threshold: close now (Q* = 1) > ascend (Q* = gamma ** 2);
    2. one step out: descend (Q* = gamma) > ascend (Q* = gamma ** 3);
    3. two steps out: descend (Q* = gamma ** 2) > ascend (Q* = gamma ** 4).
  Families 2 and 3 compare two bootstrapped arms, which the terminal
  rewards alone cannot order; family 3 orders only after value has passed
  through two target generations. The order holds for any gamma in (0, 1).
  """
  del gamma
  rng = np.random.RandomState(seed)
  thr, scale = env.threshold, env.descent_scale
  descend = _action_vector(wv_z=1.0, close=0.0)
  ascend = _action_vector(wv_z=-1.0, close=0.0)
  families = [
      (rng.uniform(0.02, thr - 0.05, per_type),
       _action_vector(wv_z=0.0, close=1.0), ascend),
      (rng.uniform(thr + 0.25 * scale, thr + 0.75 * scale, per_type),
       descend, ascend),
      (rng.uniform(thr + 1.3 * scale, thr + 1.8 * scale, per_type),
       descend, ascend),
  ]
  pairs = []
  for heights, better_action, worse_action in families:
    images = np.stack([env._render(h) for h in heights])
    better, worse = {}, {}
    for feats, action in ((better, better_action), (worse, worse_action)):
      feats['state/image'] = images
      offset = 0
      for key, size in ACTION_DIM_LAYOUT:
        feats['action/' + key] = np.tile(
            action[offset:offset + size], (per_type, 1))
        offset += size
      feats['action/gripper_closed'] = np.zeros((per_type, 1), np.float32)
      feats['action/height_to_bottom'] = np.asarray(
          heights, np.float32).reshape(per_type, 1)
    pairs.append((better, worse))
  return pairs
