"""VecGraspingEnv: B grasping MDPs advanced in one vectorized step on the
env's device (the JAX package's ``envs/grasping.py``).

Per slot, the MDP is ``research/qtopt/grasping_sim.SimGraspingEnv``'s:

  * The state is explicit: ``GraspState(h, t)`` with a leading
    ``num_envs`` dim, tensors on the env's device; a step is a handful of
    tensor operations over all B slots, with no Python loop over them.
  * Scenarios are a batch dimension: every slot carries its own grasp
    threshold, descent scale, camera shift and sensor noise, sampled once
    from a seeded ``ScenarioConfig`` with numpy (the JAX package's draws
    for the same seed), and a difficulty ``bucket`` that keys the
    per-scenario success telemetry.
  * Grasp attempts end with ``terminal`` True; timeouts end the episode
    (``done``) but are not terminals, so that value bootstraps through the
    time limit.

Frames are drawn over ``grasping_sim.gradient_background`` with index masks
in the JAX env's float32 arithmetic, so a noise-free frame is bit-equal to
the JAX env's and to the numpy env's (away from float32-vs-float64 rounding
of the gripper's row).

Kept deviation: JAX draws the sensor noise and the reset heights from
per-slot ``jax.random`` keys carried in the state; the port draws them from
the env's ``torch.Generator`` (``generator``, on the env's device, seeded
from ``seed`` and reseeded by ``reset(seed)``). Tests pin the state
(``state_for_heights``) and the noise (a noise scale of 0) instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.envs.vec_env import VecEnv, VecStep
from tensor2robot_tpu_torch.research.qtopt.grasping_sim import (
    CLOSE_INDEX,
    DESCENT_SCALE,
    GAMMA,
    H_MAX,
    THRESHOLD,
    WV_Z_INDEX,
    gradient_background,
)

__all__ = ['GraspState', 'ScenarioConfig', 'Scenarios', 'VecGraspingEnv',
           'sample_scenarios']

_OBJECT_RGB = (200.0, 40.0, 40.0)
_GRIPPER_RGB = (40.0, 200.0, 60.0)


class GraspState(NamedTuple):
  """Per-slot env state; every tensor is [num_envs]-leading."""

  h: torch.Tensor  # [B] float32 gripper height above the object
  t: torch.Tensor  # [B] int32 step index within the episode


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
  """Per-slot randomization ranges; the defaults are the numpy env's fixed
  constants (no randomization).

  ``randomized()`` is the sweep the loop uses: a spread of grasp thresholds
  (object geometry), descent scales (dynamics), small camera shifts and
  sensor-noise levels. Buckets partition ``threshold_range`` into
  ``num_buckets`` equal difficulty bins.
  """

  num_buckets: int = 8
  threshold_range: Tuple[float, float] = (THRESHOLD, THRESHOLD)
  descent_scale_range: Tuple[float, float] = (DESCENT_SCALE, DESCENT_SCALE)
  camera_shift_px: int = 0
  noise_scale_range: Tuple[float, float] = (4.0, 4.0)
  reset_h_range: Tuple[float, float] = (0.1, 1.1)

  @classmethod
  def randomized(cls, num_buckets: int = 8,
                 camera_shift_px: int = 2) -> 'ScenarioConfig':
    return cls(num_buckets=num_buckets,
               threshold_range=(0.35, 0.65),
               descent_scale_range=(0.25, 0.45),
               camera_shift_px=camera_shift_px,
               noise_scale_range=(0.0, 6.0))


class Scenarios(NamedTuple):
  """One sampled scenario per env slot (host numpy arrays)."""

  threshold: np.ndarray      # [B] float32
  descent_scale: np.ndarray  # [B] float32
  shift_y: np.ndarray        # [B] int32 camera shift (rows)
  shift_x: np.ndarray        # [B] int32 camera shift (cols)
  noise_scale: np.ndarray    # [B] float32 sensor noise stddev
  bucket: np.ndarray         # [B] int32 difficulty bucket id


def sample_scenarios(config: ScenarioConfig, num_envs: int,
                     seed: int = 0) -> Scenarios:
  """Draws ``num_envs`` scenarios from a seeded config, as the JAX package
  does (numpy ``RandomState``, the same draws in the same order)."""
  rng = np.random.RandomState(seed)
  lo, hi = config.threshold_range
  threshold = rng.uniform(lo, hi, num_envs).astype(np.float32)
  descent = rng.uniform(*config.descent_scale_range,
                        size=num_envs).astype(np.float32)
  shift = int(config.camera_shift_px)
  shift_y = rng.randint(-shift, shift + 1, num_envs).astype(np.int32)
  shift_x = rng.randint(-shift, shift + 1, num_envs).astype(np.int32)
  noise = rng.uniform(*config.noise_scale_range,
                      size=num_envs).astype(np.float32)
  if hi > lo:
    bucket = np.clip(((threshold - lo) / (hi - lo))
                     * config.num_buckets, 0,
                     config.num_buckets - 1).astype(np.int32)
  else:
    bucket = np.zeros(num_envs, np.int32)
  return Scenarios(threshold=threshold, descent_scale=descent,
                   shift_y=shift_y, shift_x=shift_x, noise_scale=noise,
                   bucket=bucket)


class VecGraspingEnv(VecEnv):
  """B independent grasping MDPs on ``device`` (module docstring).

  Observations match the numpy env's per slot: ``image`` uint8 [B, H, W,
  3], ``gripper_closed`` and ``height_to_bottom`` float32 [B]. ``device``
  is the card unless the caller asks for the CPU.
  """

  def __init__(self,
               num_envs: int,
               height: int = 64,
               width: int = 80,
               episode_length: int = 3,
               scenarios: Optional[Scenarios] = None,
               scenario_config: Optional[ScenarioConfig] = None,
               seed: int = 0,
               safe_region: Optional[Tuple[Tuple[int, int],
                                           Tuple[int, int]]] = None,
               device='cuda'):
    if num_envs < 1:
      raise ValueError('num_envs must be >= 1; got {}'.format(num_envs))
    self._num_envs = int(num_envs)
    self._height = int(height)
    self._width = int(width)
    self._episode_length = int(episode_length)
    self.device = torch.device(device)
    self.scenario_config = scenario_config or ScenarioConfig()
    if scenarios is None:
      scenarios = sample_scenarios(self.scenario_config, num_envs, seed)
    if len(scenarios.threshold) != num_envs:
      raise ValueError('scenarios carry {} slots for num_envs={}'.format(
          len(scenarios.threshold), num_envs))
    self.scenarios = scenarios
    if safe_region is None:
      # SimGraspingEnv's rule: the 512x640 camera frame keeps the scene
      # inside the band every train crop keeps.
      if (self._height, self._width) == (512, 640):
        safe_region = ((40, 472), (168, 472))
      else:
        safe_region = ((0, self._height), (0, self._width))
    self._safe = safe_region
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(int(seed))

    def put(array):
      return torch.as_tensor(np.asarray(array)).to(self.device)

    self._background = put(gradient_background(height, width))
    self._threshold = put(scenarios.threshold)
    self._descent_scale = put(scenarios.descent_scale)
    self._noise_scale = put(scenarios.noise_scale).reshape(-1, 1, 1, 1)
    (y0, y1), (x0, x1) = self._safe
    band_h, band_w = y1 - y0, x1 - x0
    self._block = block = max(6, band_h // 14)
    # The object's column and row per slot, int32 as in JAX.
    self._cx = torch.clamp(x0 + band_w // 2 + put(scenarios.shift_x),
                           x0 + block, x1 - block).reshape(-1, 1, 1)
    self._obj_y = torch.clamp(y1 - 2 * block + put(scenarios.shift_y),
                              y0, y1 - 2 * block).reshape(-1, 1, 1)
    self._ys = torch.arange(self._height, device=self.device).reshape(
        1, -1, 1)
    self._xs = torch.arange(self._width, device=self.device).reshape(1, 1, -1)
    self._object_rgb = torch.tensor(_OBJECT_RGB, device=self.device)
    self._gripper_rgb = torch.tensor(_GRIPPER_RGB, device=self.device)

  # -- properties ------------------------------------------------------------

  @property
  def num_envs(self) -> int:
    return self._num_envs

  @property
  def height(self) -> int:
    return self._height

  @property
  def width(self) -> int:
    return self._width

  @property
  def episode_length(self) -> int:
    return self._episode_length

  @property
  def buckets(self) -> np.ndarray:
    """Per-slot difficulty bucket ids (host numpy)."""
    return self.scenarios.bucket

  @property
  def num_buckets(self) -> int:
    return int(self.scenario_config.num_buckets)

  # -- rendering -------------------------------------------------------------

  def _heights(self, h) -> torch.Tensor:
    return torch.as_tensor(h, dtype=torch.float32).to(self.device).reshape(
        self._num_envs)

  def _frames(self, h: torch.Tensor) -> torch.Tensor:
    """Every slot's frame before noise, float32 [B, H, W, 3]: the object
    block, then the gripper at height h, over the gradient."""
    (y0, _), _ = self._safe
    band_h = self._safe[0][1] - y0
    block = self._block
    cx, obj_y, ys, xs = self._cx, self._obj_y, self._ys, self._xs
    frac = torch.clamp(h / H_MAX, 0.0, 1.0).reshape(-1, 1, 1)
    # The numpy env's int() truncation is floor here: the value is at
    # least y0 + block by the band's geometry.
    grip_y = torch.clamp(
        torch.floor(obj_y - block - frac * (band_h - 4 * block)).to(
            torch.int32), min=y0)
    obj = ((ys >= obj_y) & (ys < obj_y + block)
           & (xs >= cx - block) & (xs < cx + block))
    img = torch.where(obj[..., None], self._object_rgb, self._background)
    grip = ((ys >= grip_y) & (ys < grip_y + block)
            & (xs >= cx - block // 2) & (xs < cx + block // 2))
    return torch.where(grip[..., None], self._gripper_rgb, img)

  def _observe(self, h: torch.Tensor):
    """Observations at heights ``h``, with each slot's sensor noise drawn
    from the env's generator."""
    noise = torch.randn((self._num_envs, self._height, self._width, 1),
                        generator=self.generator, device=self.device)
    image = torch.clamp(self._frames(h) + noise * self._noise_scale, 0.0,
                        255.0).to(torch.uint8)
    return {'image': image,
            'gripper_closed': torch.zeros_like(h),
            'height_to_bottom': h}

  def render(self, h) -> torch.Tensor:
    """[B] heights -> uint8 frames under each slot's scenario, no noise."""
    return torch.clamp(self._frames(self._heights(h)), 0.0, 255.0).to(
        torch.uint8)

  # -- the contract ----------------------------------------------------------

  def _reset_heights(self) -> torch.Tensor:
    lo, hi = self.scenario_config.reset_h_range
    return torch.rand(self._num_envs, generator=self.generator,
                      device=self.device) * (hi - lo) + lo

  def state_for_heights(self, heights) -> GraspState:
    """A fresh state pinned at explicit per-slot heights."""
    return GraspState(h=self._heights(heights),
                      t=torch.zeros(self._num_envs, dtype=torch.int32,
                                    device=self.device))

  def reset(self, seed: Optional[int] = None):
    """Fresh episodes in every slot; ``seed`` reseeds the generator."""
    if seed is not None:
      self.generator.manual_seed(int(seed))
    state = self.state_for_heights(self._reset_heights())
    return state, self._observe(state.h)

  def step(self, state: GraspState, action) -> VecStep:
    """Advances every slot; auto-resets finished episodes (VecEnv)."""
    action = torch.as_tensor(action).to(self.device, torch.float32).reshape(
        self._num_envs, -1)
    h, t = state.h, state.t
    close = action[:, CLOSE_INDEX] > 0.5
    t1 = t + 1
    wv_z = torch.clamp(action[:, WV_Z_INDEX], -1.0, 1.0)
    h_moved = torch.clamp(h - self._descent_scale * wv_z, 0.0, H_MAX)
    h_next = torch.where(close, h, h_moved)
    terminal = close
    reward = (close & (h <= self._threshold)).to(torch.float32)
    timeout = (~close) & (t1 >= self._episode_length)
    done = terminal | timeout
    next_obs = self._observe(h_next)
    h_new = torch.where(done, self._reset_heights(), h_next)
    t_new = torch.where(done, torch.zeros_like(t1), t1)
    reset_obs = self._observe(h_new)
    obs = {'image': torch.where(done.reshape(-1, 1, 1, 1),
                                reset_obs['image'], next_obs['image']),
           'gripper_closed': reset_obs['gripper_closed'],
           'height_to_bottom': h_new}
    return VecStep(state=GraspState(h=h_new, t=t_new), obs=obs,
                   reward=reward, done=done,
                   info={'terminal': terminal, 'timeout': timeout,
                         'next_obs': next_obs})

  # -- the analytic criterion ------------------------------------------------

  def steps_to_grasp(self, h) -> torch.Tensor:
    """Per-slot n(h) under each slot's threshold and descent scale."""
    need = torch.clamp(self._heights(h) - self._threshold, min=0.0)
    return torch.ceil(need / self._descent_scale).to(torch.int32)

  def optimal_value(self, h, gamma: float = GAMMA) -> torch.Tensor:
    """V*(h) = gamma ** n(h) per slot."""
    return torch.tensor(gamma, dtype=torch.float32,
                        device=self.device) ** self.steps_to_grasp(h)
