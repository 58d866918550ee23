"""An episode of the pose toy env as serialized transition Examples (the
JAX package's ``research/pose_env/episode_to_transitions.py``): the JPEG
observation, the attempted pose, its reward and the true target pose, a
supervised regression dataset that the collect loop writes."""

from __future__ import annotations

from typing import List

import numpy as np

from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.utils import image as image_lib

__all__ = ['episode_to_transitions_pose_toy']


def episode_to_transitions_pose_toy(episode_data) -> List[bytes]:
  """(obs, action, reward, obs_tp1, done, debug) steps -> Example bytes."""
  transitions = []
  for obs_t, action, reward, _obs_tp1, _done, debug in episode_data:
    features = {
        'state/image': image_lib.numpy_to_image_string(
            np.asarray(obs_t, np.uint8), 'jpeg'),
        'pose': np.asarray(action, np.float32).ravel(),
        'reward': np.asarray([reward], np.float32),
        'target_pose': np.asarray(debug['target_pose'], np.float32).ravel(),
    }
    transitions.append(wire.build_example(features))
  return transitions
