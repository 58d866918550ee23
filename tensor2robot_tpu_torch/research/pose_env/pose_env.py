"""The duck pose toy task, a numpy environment (the port's copy of the JAX
package's ``research/pose_env/pose_env.py``, bit for bit).

The observation is a 64x64x3 uint8 image of a duck on a table from a
random camera (a numpy pinhole rasterizer: gray ground, brown table top,
yellow body, orange head along the yaw); the action is the predicted (x,
y) pose, the reward ``-||target - action||``, and an episode is one step.
``hidden_drift`` offsets the true pose from the rendered one by a task's
constant, which only adaptation can learn. The camera changes on
``reset_task`` only; ``reset`` draws a new pose (``new_pose_on_reset``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class PoseEnvRandomPolicy:
  """Uniform-random pose guesses, for dataset generation."""

  def reset(self):
    pass

  def restore(self) -> bool:
    """Nothing to restore (collect_eval_loop polling protocol)."""
    return True

  def init_randomly(self) -> None:
    pass

  @property
  def global_step(self) -> int:
    return 0

  def sample_action(self, obs, explore_prob):
    del obs, explore_prob
    return np.random.uniform(low=-1., high=1., size=2), None


def _look_at_matrix(yaw_deg: float, pitch_deg: float, distance: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
  """Camera rotation (world->cam) + position for a look-at-origin orbit."""
  yaw = np.deg2rad(yaw_deg)
  pitch = np.deg2rad(pitch_deg)
  # Camera position on the orbit sphere.
  eye = distance * np.array([
      np.cos(pitch) * np.sin(yaw),
      -np.cos(pitch) * np.cos(yaw),
      -np.sin(pitch),
  ])
  forward = -eye / np.linalg.norm(eye)           # towards the origin
  world_up = np.array([0.0, 0.0, 1.0])
  right = np.cross(forward, world_up)
  right /= max(np.linalg.norm(right), 1e-8)
  up = np.cross(right, forward)
  rotation = np.stack([right, up, forward])      # rows: cam axes in world
  return rotation, eye


class PoseToyEnv:
  """Predict the object's pose from the current image.

  Observation: [height, width, 3] uint8 image, random camera per task.
  Action: predicted (x, y) pose. Reward: -||target_xy - action||_2.
  Episodes are single-step.

  ``reset()`` samples a fresh object pose each episode by default; the
  camera changes only on ``reset_task()``. ``new_pose_on_reset=False``
  keeps the pose until ``reset_task``.
  """

  def __init__(self,
               render_mode: str = 'DIRECT',
               hidden_drift: bool = False,
               urdf_root: str = '',
               width: int = 64,
               height: int = 64,
               new_pose_on_reset: bool = True,
               seed: Optional[int] = None):
    del render_mode, urdf_root  # no GUI / asset files in the numpy renderer
    self._width, self._height = width, height
    self._hidden_drift = hidden_drift
    self._hidden_drift_xyz = None
    self._new_pose_on_reset = new_pose_on_reset
    self._rng = np.random.RandomState(seed)
    self._fov_deg = 30.0
    self._distance = 3.0
    self.reset_task()

  # -- task / pose sampling --------------------------------------------------

  def reset_task(self) -> None:
    self._reset_camera()
    if self._hidden_drift:
      self._hidden_drift_xyz = self._rng.uniform(low=-.3, high=.3, size=3)
      self._hidden_drift_xyz[2] = 0
    self.set_new_pose()

  def set_new_pose(self) -> None:
    self._target_pose = self._sample_pose()
    self._rendered_pose = self._target_pose.copy()
    if self._hidden_drift:
      self._target_pose = self._target_pose + self._hidden_drift_xyz

  def _sample_pose(self) -> np.ndarray:
    return np.array([
        self._rng.uniform(low=-.7, high=.7),
        self._rng.uniform(low=-.4, high=.4),
        self._rng.uniform(low=-180, high=180),
    ])

  def _reset_camera(self) -> None:
    self._cam_pitch = -30 + self._rng.uniform(-10, 10)
    self._cam_yaw = self._rng.uniform(-180, 180)

  # -- rendering -------------------------------------------------------------

  def _project(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World points [N, 3] -> (pixel coords [N, 2], depth [N])."""
    rotation, eye = _look_at_matrix(self._cam_yaw, self._cam_pitch,
                                    self._distance)
    cam = (points - eye) @ rotation.T
    depth = np.maximum(cam[:, 2], 1e-6)
    focal = (self._height / 2.0) / np.tan(np.deg2rad(self._fov_deg) / 2.0)
    u = self._width / 2.0 + focal * cam[:, 0] / depth
    v = self._height / 2.0 - focal * cam[:, 1] / depth
    return np.stack([u, v], axis=1), depth

  def _splat(self, image, pixels, depth, radius_world, color) -> None:
    """Draws filled disks (radius scaled by 1/depth) into the image."""
    focal = (self._height / 2.0) / np.tan(np.deg2rad(self._fov_deg) / 2.0)
    ys, xs = np.mgrid[0:self._height, 0:self._width]
    for (u, v), z in zip(pixels, depth):
      r = max(focal * radius_world / z, 1.0)
      mask = (xs - u) ** 2 + (ys - v) ** 2 <= r ** 2
      image[mask] = color

  def _get_image(self) -> np.ndarray:
    image = np.full((self._height, self._width, 3), 178, np.uint8)  # sky/bg
    # Table top: a grid of brown splats over the tray area.
    gx, gy = np.meshgrid(np.linspace(-0.95, 0.95, 13),
                         np.linspace(-0.65, 0.65, 9))
    table = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -0.02)],
                     axis=1)
    pixels, depth = self._project(table)
    self._splat(image, pixels, depth, 0.09, np.array([120, 85, 60], np.uint8))
    # Duck: yellow body at (x, y), orange head offset along the yaw angle.
    x, y, angle = self._rendered_pose
    heading = np.deg2rad(angle)
    body = np.array([[x, y, 0.05]])
    head = np.array([[x + 0.12 * np.cos(heading),
                      y + 0.12 * np.sin(heading), 0.12]])
    pixels, depth = self._project(body)
    self._splat(image, pixels, depth, 0.11, np.array([230, 200, 30], np.uint8))
    pixels, depth = self._project(head)
    self._splat(image, pixels, depth, 0.055, np.array([240, 140, 20], np.uint8))
    return image

  def get_observation(self) -> np.ndarray:
    return self._get_image()

  # -- env API ---------------------------------------------------------------

  def reset(self) -> np.ndarray:
    if self._new_pose_on_reset:
      self.set_new_pose()
    return self.get_observation()

  def step(self, action):
    """A single-step episode with the distance reward."""
    action = np.asarray(action, np.float32)
    reward = -np.linalg.norm(action - self._target_pose[:2]).astype(np.float32)
    done = True
    debug = {'target_pose': self._target_pose[:2].astype(np.float32)}
    return self.get_observation(), float(reward), done, debug

  def close(self) -> None:
    pass
