"""Watch-Try-Learn trial and retrial models, in PyTorch (the JAX
package's ``research/vrgripper/vrgripper_env_wtl_models.py``; Zhou et
al., arXiv:1906.03352).

The trial model conditions on the demo episode; the retrial model
(2 condition episodes: the demo, then the first trial) also embeds the
trial with its success signal (``condition/labels/success``, mapped from
{0, 1} to {-1, 1}). ``VRGripperEnvSimpleTrialModel`` runs on the low-dim
``full_state_pose``; ``VRGripperEnvVisionTrialModel`` on the frames, its
demo and trial frames embedded by one keypoint tower (``image_embedding``)
and its inference frames by another (``state_features``), each frame
cropped by K1 in the preprocessor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers import tec
from tensor2robot_tpu_torch.layers import vision_layers
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.vrgripper.episode_to_transitions import (
    make_fixed_length)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_meta_models \
    import _FixedCountMetaModel, _image_spec, add_meta_dims, get_field
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    GRIPPER_POSE_SIZE, POINTS, _as_float)
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['VRGripperEnvSimpleTrialModel', 'VRGripperEnvVisionTrialModel',
           'pack_wtl_meta_features']


def pack_wtl_meta_features(state, prev_episode_data, timestep,
                           fixed_length: int,
                           num_condition_samples_per_task: int,
                           vision: bool = False,
                           deterministic_condition: bool = True
                           ) -> Dict[str, np.ndarray]:
  """The state tiled over the episode, and the conditioning episodes
  resampled to ``fixed_length`` (evenly where ``deterministic_condition``)
  with their actions and success (a positive return), as one task's meta
  features; the frames and gripper pose where ``vision``, else the
  ``full_state_pose``."""
  del timestep
  if len(prev_episode_data) < 1:
    raise ValueError(
        'prev_episode_data should at least contain one (demo) episode.')
  tile = lambda x: np.tile(x[None], (fixed_length,) + (1,) * x.ndim)
  features = {}
  if vision:
    features['inference/features/image'] = tile(
        np.asarray(get_field(state, 'image'))).astype(np.uint8)
    features['inference/features/gripper_pose'] = tile(
        np.asarray(get_field(state, 'pose'), np.float32))
  else:
    features['inference/features/full_state_pose'] = tile(
        np.asarray(get_field(state, 'full_state_pose'), np.float32))
  packed = {k: [] for k in ('image', 'gripper_pose', 'full_state_pose',
                            'action', 'success')}
  for i in range(num_condition_samples_per_task):
    episode = make_fixed_length(
        prev_episode_data[i % len(prev_episode_data)], fixed_length,
        randomized=not deterministic_condition)
    obs = [t[0] for t in episode]
    if vision:
      packed['image'].append(np.stack([np.asarray(get_field(o, 'image'))
                                       for o in obs]))
      packed['gripper_pose'].append(np.stack(
          [np.asarray(get_field(o, 'pose'), np.float32) for o in obs]))
    else:
      packed['full_state_pose'].append(np.stack(
          [np.asarray(get_field(o, 'full_state_pose'), np.float32)
           for o in obs]))
    packed['action'].append(np.stack([np.asarray(t[1], np.float32)
                                      for t in episode]))
    success = float(np.sum([t[2] for t in episode]) > 0)
    packed['success'].append(success * np.ones((fixed_length, 1),
                                               np.float32))
  if vision:
    features['condition/features/image'] = np.stack(
        packed['image']).astype(np.uint8)
    features['condition/features/gripper_pose'] = np.stack(
        packed['gripper_pose'])
  else:
    features['condition/features/full_state_pose'] = np.stack(
        packed['full_state_pose'])
  features['condition/labels/action'] = np.stack(packed['action'])
  features['condition/labels/success'] = np.stack(packed['success'])
  return add_meta_dims(features)


def _tile_time(x: torch.Tensor, steps: int) -> torch.Tensor:
  """[B, n, F] -> [B, n, steps, F]."""
  return x[:, :, None, :].expand(tuple(x.shape[:2]) + (steps, x.shape[-1]))


class _Head(nn.Module):
  """The policy's head: with a mixture, ``mdn_head`` (after ``a_func``'s
  hidden layers where ``mdn_after_hidden``), its mode, and the labels'
  negative log likelihood; else ``a_func``'s pose and the mean squared
  error."""

  def _build_head(self, width: int, action_size: int,
                  num_mixture_components: int, mdn_after_hidden: bool):
    self.action_size = action_size
    self.num_mixture_components = num_mixture_components
    if num_mixture_components > 1:
      if mdn_after_hidden:
        self.a_func = vision_layers.ImageFeaturesToPoseNet(width,
                                                           num_outputs=None)
        width = self.a_func.fc_layers[-1]
      self.mdn_head = mdn.MDNParamsLayer(width, num_mixture_components,
                                         action_size)
    else:
      self.a_func = vision_layers.ImageFeaturesToPoseNet(
          width, num_outputs=action_size)

  def head(self, fc_inputs: torch.Tensor, labels):
    outputs = {}
    action_labels = None if labels is None else _as_float(labels['action'])
    if self.num_mixture_components > 1:
      hidden = (self.a_func(fc_inputs) if hasattr(self, 'a_func')
                else fc_inputs)
      dist_params = self.mdn_head(hidden)
      outputs['dist_params'] = dist_params
      gm = mdn.get_mixture_distribution(dist_params.to(torch.float32),
                                        self.num_mixture_components,
                                        self.action_size)
      action = mdn.gaussian_mixture_approximate_mode(gm)
      if action_labels is not None:
        outputs['bc_loss'] = -mdn.mixture_log_prob(gm, action_labels).mean()
    else:
      action = self.a_func(fc_inputs)
      if action_labels is not None:
        outputs['bc_loss'] = ((action.to(torch.float32) - action_labels) **
                              2).mean()
    outputs['inference_output'] = action
    return outputs


class _SimpleTrialNet(_Head):
  """The low-dim WTL policy: the demo's embedding (``demo_embedding``, a
  temporal reduction, or the demo's last state where ``embed_type`` is
  'mean'), the trial's with its success for a retrial
  (``trial_embedding``), beside each inference state."""

  def __init__(self, action_size: int, episode_length: int,
               fc_embed_size: int, ignore_embedding: bool,
               num_mixture_components: int, retrial: bool, embed_type: str,
               obs_size: int = 32):
    super().__init__()
    if embed_type not in ('temporal', 'mean'):
      raise ValueError('Invalid embed_type: {}.'.format(embed_type))
    self.retrial = retrial
    self.embed_type = embed_type
    self.ignore_embedding = ignore_embedding
    if embed_type == 'temporal':
      self.demo_embedding = tec.ReduceTemporalEmbeddings(
          obs_size, episode_length, fc_embed_size)
      width = fc_embed_size
    else:
      width = obs_size
    if retrial:
      trial_in = obs_size + 1 + width
      self.trial_embedding = (
          tec.EmbedFullstate(trial_in, fc_embed_size) if embed_type == 'mean'
          else tec.ReduceTemporalEmbeddings(trial_in, episode_length,
                                            fc_embed_size))
      width += fc_embed_size
    fc_width = obs_size if ignore_embedding else (
        obs_size + width + (1 if retrial else 0))
    self._build_head(fc_width, action_size, num_mixture_components, True)

  def forward(self, features, labels=None, mode: str = ModeKeys.PREDICT):
    del mode
    inf_pose = _as_float(features['inference/features/full_state_pose'])
    con_pose = _as_float(features['condition/features/full_state_pose'])
    con_success = 2.0 * _as_float(features['condition/labels/success']) - 1.0
    if self.retrial and con_pose.shape[1] != 2:
      raise ValueError('Unexpected shape {}.'.format(tuple(con_pose.shape)))
    steps = inf_pose.shape[2]
    if self.embed_type == 'temporal':
      fc_embedding = _tile_time(meta_data.multi_batch_apply(
          self.demo_embedding, 2, con_pose[:, 0:1]), steps)
    else:
      fc_embedding = con_pose[:, 0:1, -1:, :].expand(
          tuple(con_pose.shape[:1]) + (1, steps, con_pose.shape[-1]))
    if self.retrial:
      # The trial episode, its success signal and the demo's embedding.
      con_input = torch.cat([con_pose[:, 1:2], con_success[:, 1:2],
                             fc_embedding], -1)
      if self.embed_type == 'mean':
        trial_embedding = self.trial_embedding(con_input).mean(-2)
      else:
        trial_embedding = meta_data.multi_batch_apply(
            self.trial_embedding, 2, con_input)
      fc_embedding = torch.cat(
          [fc_embedding, _tile_time(trial_embedding, steps)], -1)
    if self.ignore_embedding:
      fc_inputs = inf_pose
    else:
      parts = [inf_pose, fc_embedding]
      if self.retrial:
        parts.append(con_success[:, 1:2])
      fc_inputs = torch.cat(parts, -1)
    return self.head(fc_inputs, labels)


class VRGripperEnvSimpleTrialModel(_FixedCountMetaModel):
  """The low-dim-state WTL trial (or retrial) model."""

  def __init__(self, action_size: int = 7, fc_embed_size: int = 32,
               ignore_embedding: bool = False,
               num_mixture_components: int = 1, retrial: bool = False,
               embed_type: str = 'temporal', obs_size: int = 32, **kwargs):
    if retrial:
      kwargs.setdefault('num_condition_samples_per_task', 2)
    super().__init__(**kwargs)
    self._action_size = action_size
    self._fc_embed_size = fc_embed_size
    self._ignore_embedding = ignore_embedding
    self._num_mixture_components = num_mixture_components
    self._retrial = retrial
    self._embed_type = embed_type
    self._obs_size = obs_size

  def _episode_feature_specification(self, mode: str):
    del mode
    return {'full_state_pose': TensorSpec(
        (self._episode_length, self._obs_size), np.float32,
        name='full_state_pose')}

  def _episode_label_specification(self, mode: str):
    del mode
    return {'action': TensorSpec((self._episode_length, self._action_size),
                                 np.float32, name='action_world'),
            'success': TensorSpec((self._episode_length, 1), np.float32,
                                  name='success')}

  def create_network(self) -> nn.Module:
    return _SimpleTrialNet(
        action_size=self._action_size, episode_length=self._episode_length,
        fc_embed_size=self._fc_embed_size,
        ignore_embedding=self._ignore_embedding,
        num_mixture_components=self._num_mixture_components,
        retrial=self._retrial, embed_type=self._embed_type,
        obs_size=self._obs_size)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    bc_loss = inference_outputs['bc_loss']
    return bc_loss, {'bc_loss': bc_loss}

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str):
    loss, train_outputs = self.model_train_fn(state, features, labels,
                                              inference_outputs, mode)
    return {'loss': loss, **{'mean_' + k: v
                             for k, v in train_outputs.items()}}

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_wtl_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition)


class _VisionTrialNet(_Head):
  """The vision WTL policy: the demo's keypoints (``image_embedding``) and
  gripper poses reduced over time (``fc_demo_reduce``); for a retrial the
  trial's, with its success and the demo's embedding
  (``fc_trial_reduce``); the inference frames' keypoints
  (``state_features``), their gripper poses and the embedding, then the
  head (``mdn_head`` directly, or ``a_func``)."""

  def __init__(self, action_size: int, episode_length: int,
               fc_embed_size: int, ignore_embedding: bool,
               num_mixture_components: int,
               num_condition_samples_per_task: int):
    super().__init__()
    self.episode_length = episode_length
    self.ignore_embedding = ignore_embedding
    self.retrial = num_condition_samples_per_task > 1
    self.image_embedding = tec.EmbedConditionImages()
    self.fc_demo_reduce = tec.ReduceTemporalEmbeddings(
        POINTS + GRIPPER_POSE_SIZE, episode_length, fc_embed_size)
    width = fc_embed_size
    if self.retrial:
      self.fc_trial_reduce = tec.ReduceTemporalEmbeddings(
          POINTS + GRIPPER_POSE_SIZE + 1 + fc_embed_size, episode_length,
          fc_embed_size)
      width += fc_embed_size
    self.state_features = vision_layers.ImagesToFeaturesNet()
    fc_width = POINTS + GRIPPER_POSE_SIZE + (0 if ignore_embedding
                                             else width)
    self._build_head(fc_width, action_size, num_mixture_components, False)

  def _points(self, images: torch.Tensor, train: bool) -> torch.Tensor:
    return meta_data.multi_batch_apply(
        lambda image: self.image_embedding(image, train=train), 3, images)

  def embed_episodes(self, images, gripper_pose, success, train: bool):
    """The demo's (and the trial's) embedding, [B, 1, E or 2 E]."""
    demo = torch.cat([self._points(images[:, 0:1], train),
                      gripper_pose[:, 0:1]], -1)
    embedding = meta_data.multi_batch_apply(self.fc_demo_reduce, 2, demo)
    if self.retrial:
      trial = torch.cat([self._points(images[:, 1:2], train),
                         gripper_pose[:, 1:2], 2.0 * success[:, 1:2] - 1.0,
                         _tile_time(embedding, images.shape[2])], -1)
      embedding = torch.cat([embedding, meta_data.multi_batch_apply(
          self.fc_trial_reduce, 2, trial)], -1)
    return embedding

  def forward(self, features, labels=None, mode: str = ModeKeys.PREDICT):
    train = mode == ModeKeys.TRAIN
    condition_embedding = self.embed_episodes(
        _as_float(features['condition/features/image']),
        _as_float(features['condition/features/gripper_pose']),
        _as_float(features['condition/labels/success']), train)
    state_features, _ = meta_data.multi_batch_apply(
        lambda image: self.state_features(image, train=train), 3,
        _as_float(features['inference/features/image']))
    parts = [state_features,
             _as_float(features['inference/features/gripper_pose'])]
    if not self.ignore_embedding:
      parts.append(_tile_time(condition_embedding, self.episode_length))
    return self.head(torch.cat(parts, -1), labels)


class VRGripperEnvVisionTrialModel(_FixedCountMetaModel):
  """The vision WTL trial model; with 2 condition episodes a task, the
  retrial model."""

  def __init__(self, action_size: int = 7, embed_loss_weight: float = 0.0,
               fc_embed_size: int = 32, ignore_embedding: bool = False,
               num_mixture_components: int = 1, **kwargs):
    super().__init__(**kwargs)
    self._action_size = action_size
    self._embed_loss_weight = embed_loss_weight
    self._fc_embed_size = fc_embed_size
    self._ignore_embedding = ignore_embedding
    self._num_mixture_components = num_mixture_components

  def _episode_feature_specification(self, mode: str):
    del mode
    return {'image': _image_spec(self._episode_length),
            'gripper_pose': TensorSpec(
                (self._episode_length, GRIPPER_POSE_SIZE), np.float32,
                name='world_pose_gripper')}

  def _episode_label_specification(self, mode: str):
    del mode
    return {'action': TensorSpec((self._episode_length, self._action_size),
                                 np.float32, name='action_world'),
            'success': TensorSpec((self._episode_length, 1), np.float32,
                                  name='success')}

  def create_network(self) -> nn.Module:
    return _VisionTrialNet(
        action_size=self._action_size, episode_length=self._episode_length,
        fc_embed_size=self._fc_embed_size,
        ignore_embedding=self._ignore_embedding,
        num_mixture_components=self._num_mixture_components,
        num_condition_samples_per_task=self._num_condition)

  model_train_fn = VRGripperEnvSimpleTrialModel.model_train_fn
  model_eval_fn = VRGripperEnvSimpleTrialModel.model_eval_fn

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_wtl_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition, vision=True)
