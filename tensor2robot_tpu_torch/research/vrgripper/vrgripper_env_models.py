"""VRGripper behavior cloning models, in PyTorch (the JAX package's
``research/vrgripper/vrgripper_env_models.py``).

  * ``DefaultVRGripperPreprocessor``: uint8 episodes of 220x300 frames ->
    float32 in [0, 1] at the spec's 100x100. The crop and the conversion
    are kernel K1 (``preprocessors/pallas_crop.crop_convert``), one launch
    for all the batch's frames: TRAIN crops each episode at its own random
    (y, x) offset, shared by its T frames (a fixed camera does not jitter
    within an episode), EVAL and PREDICT at the center. K1 multiplies by
    float32 1/255, what XLA compiles JAX's ``/ 255.0`` to. Then the
    bilinear resize, ``F.interpolate`` with ``antialias=True``, which is
    what ``jax.image.resize(..., 'bilinear')`` computes when it shrinks
    (no Pallas kernel in JAX: the library call serves). Then mixup, where
    ``mixup_alpha`` > 0. TRAIN's offsets and mixup's Beta(alpha, alpha)
    lambda are drawn from the step's generator (``draw``) or given
    (``preprocess(..., draws=)``), so that a test can feed JAX's.
  * ``VRGripperRegressionModel``: a per-frame keypoint tower
    (``state_features``), the gripper pose beside it, and a mixture head
    (``mdn_head``, with more than one component) or a pose net
    (``pose_net``); its loss the mixture's negative log likelihood or the
    mean squared error.
  * ``VRGripperDomainAdaptiveModel``: the DAML network: a ``policy`` (the
    tower, the pose net, and optionally a gripper pose predictor) that
    predicts the action with the gripper pose and without it (the video
    only inner head), and a ``learned_loss`` (temporal convs) that drives
    the inner loop. Wrapped in ``MAMLRegressionModel`` with
    ``var_scope='policy'``, only the policy adapts.

Episodes carry their fixed ``episode_length`` as the dim after the batch:
[B, T, ...].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers import vision_layers
from tensor2robot_tpu_torch.layers.basic import Conv1D, Dense
from tensor2robot_tpu_torch.layers.transformer import LayerNorm
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import pallas_crop
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor)
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['DefaultVRGripperPreprocessor', 'VRGripperDomainAdaptiveModel',
           'VRGripperDomainAdaptiveNet', 'VRGripperRegressionModel',
           'VRGripperRegressionNet', 'resize_bilinear']

# The keypoint tower's output: 32 maps, an (x, y) each.
POINTS = 64
GRIPPER_POSE_SIZE = 14


def _is_image_key(key: str) -> bool:
  return key == 'image' or key.endswith('/image')


def resize_bilinear(frames: torch.Tensor, size: Tuple[int, int]
                    ) -> torch.Tensor:
  """[N, H, W, C] -> [N, h, w, C]: ``jax.image.resize(..., 'bilinear')``
  (half-pixel centers, a triangle kernel widened when it shrinks)."""
  out = F.interpolate(frames.permute(0, 3, 1, 2), size=tuple(size),
                      mode='bilinear', align_corners=False, antialias=True)
  return out.permute(0, 2, 3, 1)


def _episodes(images) -> int:
  """The episodes of [B, T, H, W, C] frames (one where unbatched)."""
  shape = tuple(torch.as_tensor(images).shape)
  return shape[0] if len(shape) == 5 else 1


class DefaultVRGripperPreprocessor(AbstractPreprocessor):
  """uint8 source-size episodes -> cropped, resized float32 (module
  docstring)."""

  def __init__(self, model_feature_specification_fn=None,
               model_label_specification_fn=None,
               src_img_res: Tuple[int, int] = (220, 300),
               crop_size: Tuple[int, int] = (200, 280),
               mixup_alpha: float = 0.0):
    super().__init__(model_feature_specification_fn,
                     model_label_specification_fn)
    self._src_img_res = tuple(src_img_res)
    self._crop_size = tuple(crop_size)
    self._mixup_alpha = float(mixup_alpha)

  def get_in_feature_specification(self, mode: str):
    """The model's features, with each image uint8 at the source size."""
    out = {}
    for key, spec in algebra.flat_specs(
        self._model_feature_specification(mode)).items():
      if _is_image_key(key):
        shape = list(spec.shape)
        shape[-3:-1] = self._src_img_res
        spec = TensorSpec(tuple(shape), np.uint8, **spec.fields())
      out[key] = spec
    return out

  def get_in_label_specification(self, mode: str):
    return algebra.flat_specs(self._model_label_specification(mode))

  def get_out_feature_specification(self, mode: str):
    return algebra.flat_specs(self._model_feature_specification(mode))

  def get_out_label_specification(self, mode: str):
    return algebra.flat_specs(self._model_label_specification(mode))

  def draw(self, batch: int, generator: torch.Generator):
    """TRAIN's draws from ``generator``: ``offsets`` (int32 [batch, 2], an
    episode's (y, x), y drawn before x) and, with mixup,
    ``mixup_lambda``."""
    src_h, src_w = self._src_img_res
    ch, cw = self._crop_size
    draw = lambda high: torch.randint(0, high, (batch,), generator=generator,
                                      device=generator.device)
    draws = {'offsets': torch.stack([draw(src_h - ch + 1),
                                     draw(src_w - cw + 1)], -1).to(
                                         torch.int32)}
    if self._mixup_alpha > 0.0:
      # torch's Beta takes no generator: numpy's, seeded from it.
      seed = int(torch.randint(2 ** 31 - 1, (1,), generator=generator,
                               device=generator.device))
      draws['mixup_lambda'] = float(np.random.RandomState(seed).beta(
          self._mixup_alpha, self._mixup_alpha))
    return draws

  def _offsets(self, batch: int, mode: str, draws, device) -> torch.Tensor:
    src_h, src_w = self._src_img_res
    ch, cw = self._crop_size
    if mode == ModeKeys.TRAIN and (ch, cw) != (src_h, src_w):
      return torch.as_tensor(draws['offsets'], dtype=torch.int32).to(device)
    center = torch.tensor([(src_h - ch) // 2, (src_w - cw) // 2],
                          dtype=torch.int32, device=device)
    return center.expand(batch, 2)

  def _preprocess_fn(self, features, labels, mode, generator=None,
                     draws=None):
    features = dict(features)
    labels = None if labels is None else dict(labels)
    image_keys = [key for key in features if _is_image_key(key)]
    needs_draws = mode == ModeKeys.TRAIN and (
        (image_keys and self._crop_size != self._src_img_res) or
        (self._mixup_alpha > 0.0 and labels is not None))
    if needs_draws and draws is None:
      if generator is None:
        raise ValueError('TRAIN-mode preprocessing needs a generator (or '
                         'draws) for its crops and mixup.')
      draws = self.draw(_episodes(features[image_keys[0]]) if image_keys
                        else 0, generator)
    out_spec = self.get_out_feature_specification(mode)
    for key in image_keys:
      images = torch.as_tensor(features[key])
      squeeze = images.dim() == 4   # one episode, unbatched
      if squeeze:
        images = images[None]
      batch, steps = images.shape[:2]
      offsets = self._offsets(batch, mode, draws, images.device)
      # One launch of K1: every frame at its episode's offset.
      frames = pallas_crop.crop_convert(
          images.reshape((batch * steps,) + tuple(images.shape[2:]))
          .contiguous(),
          offsets.repeat_interleave(steps, 0).contiguous(), self._crop_size)
      target = tuple(out_spec[key].shape[-3:-1])
      if target != self._crop_size:
        frames = resize_bilinear(frames, target)
      images = frames.reshape((batch, steps) + tuple(frames.shape[1:]))
      features[key] = images[0] if squeeze else images
    if (self._mixup_alpha > 0.0 and labels is not None and
        mode == ModeKeys.TRAIN):
      lmbda = float(draws['mixup_lambda'])
      for struct in (features, labels):
        for key, value in struct.items():
          value = torch.as_tensor(value)
          if value.is_floating_point():
            struct[key] = lmbda * value + (1 - lmbda) * value.flip(0)
    return features, labels


def _as_float(value) -> torch.Tensor:
  """A feature as float32, as JAX's networks cast their inputs; a float64
  one stays float64 (the tests' double precision, where JAX's float64
  weights promote its float32 inputs)."""
  value = torch.as_tensor(value)
  return value.to(torch.promote_types(value.dtype, torch.float32))


def _constant(values, like: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(np.asarray(values, np.float32), device=like.device)


class VRGripperRegressionNet(nn.Module):
  """``forward(features, mode, generator=None)``: the per-frame tower, the
  gripper pose beside it, and the mixture head or the pose net."""

  def __init__(self, action_size: int, use_gripper_input: bool = True,
               num_mixture_components: int = 1,
               condition_mixture_stddev: bool = False,
               output_mixture_sample: bool = False,
               output_mean: Optional[Sequence[float]] = None,
               output_stddev: Optional[Sequence[float]] = None):
    super().__init__()
    self.action_size = action_size
    self.use_gripper_input = use_gripper_input
    self.num_mixture_components = num_mixture_components
    self.output_mixture_sample = output_mixture_sample
    self.output_mean = output_mean
    self.output_stddev = output_stddev
    self.state_features = vision_layers.ImagesToFeaturesNet()
    width = POINTS + (GRIPPER_POSE_SIZE if use_gripper_input else 0)
    if num_mixture_components > 1:
      self.mdn_head = mdn.MDNParamsLayer(width, num_mixture_components,
                                         action_size,
                                         condition_mixture_stddev)
    else:
      self.pose_net = vision_layers.ImageFeaturesToPoseNet(
          width, num_outputs=action_size)

  def forward(self, features, mode: str = ModeKeys.PREDICT,
              generator: Optional[torch.Generator] = None):
    train = mode == ModeKeys.TRAIN
    feature_points, end_points = meta_data.multi_batch_apply(
        lambda image: self.state_features(image, train=train), 2,
        _as_float(features['image']))
    fc_input = feature_points
    if self.use_gripper_input:
      fc_input = torch.cat([feature_points,
                            _as_float(features['gripper_pose'])], -1)
    outputs = {}
    if self.num_mixture_components > 1:
      dist_params = self.mdn_head(fc_input)
      output_mean = (None if self.output_mean is None
                     else _constant(self.output_mean, dist_params))
      gm = mdn.get_mixture_distribution(
          dist_params.to(torch.float32), self.num_mixture_components,
          self.action_size, output_mean)
      if self.output_mixture_sample and generator is not None:
        # A sampled action where the step hands the network its draws
        # (JAX: where it has a 'dropout' stream), else the mode.
        action = mdn.mixture_sample(gm, generator)
      else:
        action = mdn.gaussian_mixture_approximate_mode(gm)
      outputs['dist_params'] = dist_params
    else:
      action = self.pose_net(fc_input)
      if self.output_mean is not None and self.output_stddev is not None:
        action = (_constant(self.output_mean, action) +
                  _constant(self.output_stddev, action) * action)
    outputs['inference_output'] = action
    outputs['feature_points'] = feature_points
    outputs['softmax'] = end_points['softmax']
    return outputs


class VRGripperRegressionModel(RegressionModel):
  """Continuous behavior cloning of the VRGripper env."""

  label_key = 'action'

  def __init__(self, use_gripper_input: bool = True,
               normalize_outputs: bool = False,
               output_mean: Optional[Sequence[float]] = None,
               output_stddev: Optional[Sequence[float]] = None,
               outer_loss_multiplier: float = 1.0,
               num_mixture_components: int = 1,
               output_mixture_sample: bool = False,
               condition_mixture_stddev: bool = False,
               episode_length: int = 40, action_size: int = 7,
               preprocessor_cls=DefaultVRGripperPreprocessor, **kwargs):
    super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)
    self._use_gripper_input = use_gripper_input
    self._normalize_outputs = normalize_outputs
    self._outer_loss_multiplier = outer_loss_multiplier
    self._num_mixture_components = num_mixture_components
    self._output_mixture_sample = output_mixture_sample
    self._condition_mixture_stddev = condition_mixture_stddev
    self._episode_length = episode_length
    self._action_size = action_size
    self._output_mean = self._output_stddev = None
    if output_mean is not None and output_stddev is not None:
      if not len(output_mean) == len(output_stddev) == action_size:
        raise ValueError(
            'Output mean and stddev have lengths {:d} and {:d}.'.format(
                len(output_mean), len(output_stddev)))
      self._output_mean = tuple(float(x) for x in output_mean)
      self._output_stddev = tuple(float(x) for x in output_stddev)

  @property
  def action_size(self) -> int:
    return self._action_size

  @property
  def episode_length(self) -> int:
    return self._episode_length

  def get_feature_specification(self, mode: str):
    """[T, 100, 100, 3] frames and the [T, 14] gripper pose."""
    del mode
    return {'image': TensorSpec((self._episode_length, 100, 100, 3),
                                np.float32, name='image0',
                                data_format='jpeg'),
            'gripper_pose': TensorSpec(
                (self._episode_length, GRIPPER_POSE_SIZE), np.float32,
                name='world_pose_gripper')}

  def get_label_specification(self, mode: str):
    del mode
    return {'action': TensorSpec((self._episode_length, self._action_size),
                                 np.float32, name='action_world')}

  def create_network(self) -> nn.Module:
    denormalize = (self._normalize_outputs or
                   self._num_mixture_components == 1)
    return VRGripperRegressionNet(
        action_size=self._action_size,
        use_gripper_input=self._use_gripper_input,
        num_mixture_components=self._num_mixture_components,
        condition_mixture_stddev=self._condition_mixture_stddev,
        output_mixture_sample=self._output_mixture_sample,
        output_mean=self._output_mean if denormalize else None,
        output_stddev=self._output_stddev if denormalize else None)

  @property
  def draws_in_training(self) -> bool:
    return self._output_mixture_sample

  def network_kwargs(self, mode: str, generator=None):
    kwargs = {'mode': mode}
    if self._output_mixture_sample:
      kwargs['generator'] = generator
    return kwargs

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """The mixture's negative log likelihood, or the scaled MSE."""
    action_labels = _as_float(labels[self.label_key])
    if self._num_mixture_components > 1:
      output_mean = None
      if self._normalize_outputs and self._output_mean is not None:
        output_mean = _constant(self._output_mean, action_labels)
      gm = mdn.get_mixture_distribution(
          inference_outputs['dist_params'].to(torch.float32),
          self._num_mixture_components, self._action_size, output_mean)
      loss = -mdn.mixture_log_prob(gm, action_labels).mean()
    else:
      predictions = inference_outputs['inference_output']
      loss = self._outer_loss_multiplier * (
          (predictions.to(torch.float32) - action_labels) ** 2).mean()
    return loss, {}

  def pack_features(self, state, context, timestep) -> dict:
    """One observation tiled over the episode (serving)."""
    del context, timestep
    image = np.tile(np.asarray(state['image'])[None],
                    (self._episode_length, 1, 1, 1))
    pose = np.tile(np.asarray(state['pose'], np.float32)[None],
                   (self._episode_length, 1))
    return {'image': image[None], 'gripper_pose': pose[None]}


class _PredictGripperPose(nn.Module):
  """The gripper pose from the feature points: ``Dense_0`` (no bias),
  ``LayerNorm_0``, relu, ``Dense_1``."""

  def __init__(self):
    super().__init__()
    self.Dense_0 = Dense(POINTS, 40, bias=False)
    self.LayerNorm_0 = LayerNorm(40)
    self.Dense_1 = Dense(40, GRIPPER_POSE_SIZE)

  def forward(self, feature_points: torch.Tensor) -> torch.Tensor:
    return self.Dense_1(F.relu(self.LayerNorm_0(self.Dense_0(
        feature_points))))


class _Policy(nn.Module):
  """The adapted part of the DAML network: the tower, the pose net and the
  optional gripper pose predictor, under one scope (``policy``)."""

  def __init__(self, action_size: int, predict_con_gripper_pose: bool):
    super().__init__()
    self.predict_con_gripper_pose = predict_con_gripper_pose
    self.state_features = vision_layers.ImagesToFeaturesNet()
    if predict_con_gripper_pose:
      self.gripper_pose_predictor = _PredictGripperPose()
    self.pose_net = vision_layers.ImageFeaturesToPoseNet(
        POINTS + GRIPPER_POSE_SIZE, num_outputs=action_size)

  def forward(self, images, gripper_pose, train: bool):
    feature_points, end_points = meta_data.multi_batch_apply(
        lambda image: self.state_features(image, train=train), 2, images)
    # The inner (video only) head's gripper pose: predicted, or zeros.
    con_pose = (self.gripper_pose_predictor(feature_points)
                if self.predict_con_gripper_pose
                else torch.zeros_like(gripper_pose))
    action = self.pose_net(feature_points, aux_input=gripper_pose)
    action_inner = self.pose_net(feature_points, aux_input=con_pose)
    return action, action_inner, feature_points, end_points


class _LearnedLoss(nn.Module):
  """The learned inner loss: ``ll_pose`` predicts the action from the
  feature points; then temporal VALID convs of kernel 10 (``ll_conv{i}``,
  no bias, relu, ``LayerNorm_{i}``) and a 1x1 ``ll_conv_out`` over [the
  prediction, the points, the policy's inner action], whose squares sum
  over time and channels. Without convs: the prediction's squared error
  against the (stopped) inner action."""

  def __init__(self, action_size: int,
               conv1d_layers: Optional[Sequence[int]] = (10, 10, 6)):
    super().__init__()
    self.conv1d_layers = None if conv1d_layers is None else tuple(
        conv1d_layers)
    self.ll_pose = vision_layers.ImageFeaturesToPoseNet(
        POINTS, num_outputs=action_size)
    if self.conv1d_layers is not None:
      width = 2 * action_size + POINTS
      for i, filters in enumerate(self.conv1d_layers[:-1]):
        self.add_module('ll_conv{}'.format(i),
                        Conv1D(width, filters, 10, bias=False))
        self.add_module('LayerNorm_{}'.format(i), LayerNorm(filters))
        width = filters
      self.ll_conv_out = Conv1D(width, self.conv1d_layers[-1], 1)

  def forward(self, feature_points, inference_output):
    predicted = self.ll_pose(feature_points)
    if self.conv1d_layers is None:
      return ((predicted - inference_output.detach()) ** 2).mean()
    net = torch.cat([predicted, feature_points, inference_output], -1)
    for i in range(len(self.conv1d_layers) - 1):
      net = getattr(self, 'LayerNorm_{}'.format(i))(F.relu(
          getattr(self, 'll_conv{}'.format(i))(net)))
    net = self.ll_conv_out(net)
    return (net ** 2).sum((1, 2)).mean()


class VRGripperDomainAdaptiveNet(nn.Module):
  """The DAML network: ``policy`` and ``learned_loss``."""

  def __init__(self, action_size: int, predict_con_gripper_pose: bool = False,
               learned_loss_conv1d_layers: Optional[Sequence[int]] = (
                   10, 10, 6),
               output_mean: Optional[Sequence[float]] = None,
               output_stddev: Optional[Sequence[float]] = None):
    super().__init__()
    self.output_mean = output_mean
    self.output_stddev = output_stddev
    self.policy = _Policy(action_size, predict_con_gripper_pose)
    self.learned_loss = _LearnedLoss(action_size, learned_loss_conv1d_layers)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    action, action_inner, feature_points, end_points = self.policy(
        _as_float(features['image']), _as_float(features['gripper_pose']),
        train=mode == ModeKeys.TRAIN)
    if self.output_mean is not None and self.output_stddev is not None:
      mean = _constant(self.output_mean, action)
      stddev = _constant(self.output_stddev, action)
      action = mean + stddev * action
      action_inner = mean + stddev * action_inner
    return {'inference_output': action,
            'inference_output_inner': action_inner,
            'feature_points': feature_points,
            'softmax': end_points['softmax'],
            'learned_loss_value': self.learned_loss(feature_points,
                                                    action_inner)}


class VRGripperDomainAdaptiveModel(VRGripperRegressionModel):
  """Learned-loss domain-adaptive imitation: wrap it as
  ``MAMLRegressionModel(base_model=..., inner_loop=
  MAMLInnerLoopGradientDescent(var_scope='policy'))``, so that only the
  policy adapts (on the learned loss) and the outer loop meta-trains the
  learned loss."""

  def __init__(self, predict_con_gripper_pose: bool = False,
               learned_loss_conv1d_layers: Optional[Sequence[int]] = (
                   10, 10, 6), **kwargs):
    super().__init__(**kwargs)
    self._predict_con_gripper_pose = predict_con_gripper_pose
    self._learned_loss_conv1d_layers = (
        None if learned_loss_conv1d_layers is None
        else tuple(learned_loss_conv1d_layers))

  def create_network(self) -> nn.Module:
    return VRGripperDomainAdaptiveNet(
        action_size=self._action_size,
        predict_con_gripper_pose=self._predict_con_gripper_pose,
        learned_loss_conv1d_layers=self._learned_loss_conv1d_layers,
        output_mean=self._output_mean, output_stddev=self._output_stddev)

  def inner_loop_loss_fn(self, state, features, labels, inference_outputs,
                         mode: str):
    """The learned loss drives the inner loop's adaptation."""
    del state, features, labels, mode
    return inference_outputs['learned_loss_value'], {}

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """The outer loss: behavior cloning's mean squared error."""
    predictions = inference_outputs['inference_output']
    loss = self._outer_loss_multiplier * (
        (predictions.to(torch.float32) -
         _as_float(labels[self.label_key])) ** 2).mean()
    return loss, {}
