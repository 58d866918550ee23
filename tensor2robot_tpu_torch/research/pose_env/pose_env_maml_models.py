"""The duck pose task's MAML model (the JAX package's ``research/pose_env/
pose_env_maml_models.py``): regression MAML whose robot-time features pack
the conditioning demo episode beside the inference state, with a
zero-reward dummy sample, which masks the inner gradient step, where there
is no demo yet."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tensor2robot_tpu_torch.meta_learning.maml_model import (
    MAMLRegressionModel)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel)

__all__ = ['PoseEnvRegressionModelMAML']


class PoseEnvRegressionModelMAML(MAMLRegressionModel):
  """MAML regression for the duck task."""

  def __init__(self, base_model: Optional[PoseEnvRegressionModel] = None,
               **kwargs):
    super().__init__(base_model=base_model or PoseEnvRegressionModel(),
                     **kwargs)

  def _make_dummy_labels(self) -> dict:
    """Zero labels, whose zero reward masks the inner gradient."""
    spec = self._base_model.get_label_specification(ModeKeys.TRAIN)
    return {key: np.zeros(tuple(spec[key].shape), np.float32)
            for key in ('target_pose', 'reward')}

  def pack_features(self, state, prev_episode_data, timestep) -> dict:
    """The demo's first step (or a dummy zero-reward sample) as the
    condition and ``state`` as the inference, [task 1, sample 1, ...]."""
    del timestep
    if prev_episode_data:
      obs, action, reward = prev_episode_data[0][0][:3]
      cond_state = np.asarray(obs)
      cond_labels = {'target_pose': np.asarray(action, np.float32),
                     'reward': np.asarray([2.0 * reward - 1.0], np.float32)}
    else:
      cond_state = np.asarray(state)
      cond_labels = self._make_dummy_labels()
    expand = lambda x: np.asarray(x)[None, None]
    return {
        'condition/features/state': expand(cond_state),
        'condition/labels/target_pose': expand(cond_labels['target_pose']),
        'condition/labels/reward': expand(cond_labels['reward']),
        'inference/features/state': expand(np.asarray(state)),
    }
