"""The duck pose task's models (the JAX package's ``research/pose_env/
pose_env_models.py``):

  * ``PoseEnvRegressionModel``: the image -> ``ImagesToFeaturesNet``'s
    keypoints (``state_features``) -> ``ImageFeaturesToPoseNet``
    (``pose_net``) -> the (x, y) pose, trained by the reward-weighted mean
    squared error against the true pose; its preprocessor converts the
    uint8 image to float32.
  * ``PoseEnvContinuousMCModel``: a Monte-Carlo critic of (image, pose):
    three SAME convs with flax LayerNorms, the action broadcast over the
    map, two dense layers, a scalar q regressed onto the return.

The uint8 -> float32 conversion multiplies by float32(1 / 255), what XLA
compiles JAX's ``/ 255.0`` to in its jitted step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import vision_layers
from tensor2robot_tpu_torch.layers.basic import Dense
from tensor2robot_tpu_torch.layers.transformer import LayerNorm
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor)
from tensor2robot_tpu_torch.research.qtopt.networks import Conv
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['DefaultPoseEnvContinuousPreprocessor',
           'DefaultPoseEnvRegressionPreprocessor', 'PoseEnvContinuousMCModel',
           'PoseEnvRegressionModel', 'convert_image']


def convert_image(image: torch.Tensor) -> torch.Tensor:
  """uint8 [0, 255] -> float32 [0, 1]; a float image passes through."""
  image = torch.as_tensor(image)
  if image.is_floating_point():
    return image.to(torch.float32)
  one = torch.ones((), dtype=torch.float32, device=image.device)
  return image.to(torch.float32) * (one / 255.0)


class _ImagePreprocessor(AbstractPreprocessor):
  """The model's specs, with the image key uint8 on disk."""

  image_key = 'state'

  def get_in_feature_specification(self, mode: str):
    spec = algebra.flat_specs(self._model_feature_specification(mode))
    image = spec[self.image_key]
    spec[self.image_key] = TensorSpec(image.shape, np.uint8,
                                      **image.fields())
    return spec

  def get_in_label_specification(self, mode: str):
    return algebra.flat_specs(self._model_label_specification(mode))

  def get_out_feature_specification(self, mode: str):
    return algebra.flat_specs(self._model_feature_specification(mode))

  def get_out_label_specification(self, mode: str):
    return algebra.flat_specs(self._model_label_specification(mode))

  def _preprocess_fn(self, features, labels, mode, generator=None,
                     draws=None):
    features = dict(features)
    features[self.image_key] = convert_image(features[self.image_key])
    return features, labels


class DefaultPoseEnvContinuousPreprocessor(_ImagePreprocessor):
  """uint8 images on disk -> float32 for the critic."""

  image_key = 'state/image'


class DefaultPoseEnvRegressionPreprocessor(_ImagePreprocessor):
  """uint8 images on disk -> float32 for the regression model."""


class _QNetwork(nn.Module):
  """Conv state tower + broadcast action context -> scalar q."""

  def __init__(self, channels: int = 32, image_size=(64, 64),
               action_size: int = 2):
    super().__init__()
    features = 3
    for i in range(3):
      setattr(self, 'conv{}'.format(i), Conv(features, channels, 3,
                                             bias=True))
      setattr(self, 'norm{}'.format(i), LayerNorm(channels))
      features = channels
    self.action_fc = Dense(action_size, channels)
    width = image_size[0] * image_size[1] * channels
    for i, hidden in enumerate((100, 100)):
      setattr(self, 'fc{}'.format(i), Dense(width, hidden))
      setattr(self, 'fc_norm{}'.format(i), LayerNorm(hidden))
      width = hidden
    self.q_head = Dense(width, 1)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    net = convert_image(features['state/image']).permute(0, 3, 1, 2)
    net = net.contiguous(memory_format=torch.channels_last)
    for i in range(3):
      net = getattr(self, 'conv{}'.format(i))(net).permute(0, 2, 3, 1)
      net = F.relu(getattr(self, 'norm{}'.format(i))(net)).permute(
          0, 3, 1, 2)
    action = features['action/pose'].to(torch.float32)
    context = F.relu(self.action_fc(action))
    net = net.permute(0, 2, 3, 1) + context[:, None, None, :]
    net = net.reshape(net.shape[0], -1)
    for i in range(2):
      net = getattr(self, 'fc{}'.format(i))(net)
      net = F.relu(getattr(self, 'fc_norm{}'.format(i))(net))
    return {'q_predicted': self.q_head(net).squeeze(-1)}


class PoseEnvContinuousMCModel(CriticModel):
  """The continuous Monte-Carlo critic of the pose env."""

  def __init__(self, preprocessor_cls=DefaultPoseEnvContinuousPreprocessor,
               **kwargs):
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)

  def get_state_specification(self):
    return {'image': TensorSpec((64, 64, 3), np.float32, name='state/image',
                                data_format='jpeg')}

  def get_action_specification(self):
    return {'pose': TensorSpec((2,), np.float32, name='pose')}

  def get_label_specification(self, mode: str):
    del mode
    return {'reward': TensorSpec((), np.float32, name='reward')}

  def create_network(self) -> nn.Module:
    return _QNetwork()

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """Regression of q onto the (negative distance) return, not the log
    loss: the pose env's rewards are not in [0, 1]."""
    q = inference_outputs['q_predicted']
    target = labels['reward'].to(q.dtype).reshape(q.shape)
    return ((q - target).to(torch.float32) ** 2).mean(), {}

  def pack_features(self, state, context, timestep, actions) -> dict:
    """One observation and N candidate poses, for CEM."""
    del context, timestep
    return {'state/image': np.expand_dims(state, 0),
            'action/pose': np.asarray(actions, np.float32)}


class _RegressionNetwork(nn.Module):
  """Vision tower -> spatial-softmax keypoints -> pose head."""

  def __init__(self, action_size: int = 2):
    super().__init__()
    self.state_features = vision_layers.ImagesToFeaturesNet()
    self.pose_net = vision_layers.ImageFeaturesToPoseNet(
        input_size=64, num_outputs=action_size)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    image = convert_image(features['state'])
    points, _ = self.state_features(image, train=mode == ModeKeys.TRAIN)
    return {'inference_output': self.pose_net(points),
            'state_features': points}


class PoseEnvRegressionModel(RegressionModel):
  """Image -> (x, y) pose regression."""

  def __init__(self, action_size: int = 2,
               preprocessor_cls=DefaultPoseEnvRegressionPreprocessor,
               **kwargs):
    super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)
    self._action_size = action_size

  @property
  def action_size(self) -> int:
    return self._action_size

  def get_feature_specification(self, mode: str) -> Dict[str, TensorSpec]:
    del mode
    return {'state': TensorSpec((64, 64, 3), np.float32, name='state/image',
                                data_format='jpeg')}

  def get_label_specification(self, mode: str) -> Dict[str, TensorSpec]:
    del mode
    return {'target_pose': TensorSpec((self._action_size,), np.float32,
                                      name='target_pose'),
            'reward': TensorSpec((1,), np.float32, name='reward')}

  def create_network(self) -> nn.Module:
    return _RegressionNetwork(self._action_size)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """The reward-weighted squared error against the true pose, summed
    over the nonzero weights' count (tf.losses.mean_squared_error with
    weights)."""
    predictions = inference_outputs['inference_output']
    targets = labels['target_pose'].to(predictions.dtype)
    weights = labels['reward'].to(torch.float32)
    squared = (predictions - targets).to(torch.float32) ** 2
    num_present = ((weights != 0).to(torch.float32) *
                   torch.ones_like(squared)).sum().clamp_min(1.0)
    return (squared * weights).sum() / num_present, {}

  def pack_features(self, state, context, timestep) -> dict:
    del context, timestep
    return {'state': np.expand_dims(state, 0)}
