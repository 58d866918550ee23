"""VRGripper meta models, in PyTorch (the JAX package's
``research/vrgripper/vrgripper_env_meta_models.py``): the MAML wrapper of
the regression models, TEC (task-embedded control, arXiv:1810.03237) and
the SNAIL sequential learner.

The meta models that read the meta layout whole (TEC, SNAIL and the
Watch-Try-Learn models) share ``_FixedCountMetaModel``: fixed condition
and inference episode counts, the vrgripper preprocessor over each side
(``FixedLenMetaExamplePreprocessor``: one K1 launch a side), and the
labels handed to the network (``network_inputs``), whose decoder computes
the loss in the forward. Meta features:

  condition/features/image        [B, n_cond, T, 100, 100, 3]
  condition/features/gripper_pose [B, n_cond, T, 14]
  condition/labels/action         [B, n_cond, T, A]
  inference/features/*            [B, n_inf, T, ...]
  labels: action                  [B, n_inf, T, A]

Modules shared by the condition and the inference episodes (TEC's image
embedding and temporal reduction) are one module applied twice, JAX's
reused scopes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.layers import tec
from tensor2robot_tpu_torch.layers import vision_layers
from tensor2robot_tpu_torch.layers.basic import Dense
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.meta_learning import (
    preprocessors as meta_preprocessors)
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    MAMLRegressionModel)
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.vrgripper import decoders
from tensor2robot_tpu_torch.research.vrgripper import vrgripper_env_models
from tensor2robot_tpu_torch.research.vrgripper.episode_to_transitions import (
    make_fixed_length)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    GRIPPER_POSE_SIZE, POINTS, _as_float)
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['VRGripperEnvRegressionModelMAML', 'VRGripperEnvSequentialModel',
           'VRGripperEnvTecModel', 'pack_vrgripper_meta_features']


def get_field(obj, key):
  """``obj[key]`` of a dict, else ``obj.key`` (a namedtuple's)."""
  return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def add_meta_dims(features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """A task dim before every value, and an episodes dim before each
  inference value."""
  return {key: (value[None, None] if key.startswith('inference/')
                else value[None]) for key, value in features.items()}


def pack_vrgripper_meta_features(state, prev_episode_data, timestep,
                                 fixed_length: int,
                                 num_condition_samples_per_task: int
                                 ) -> Dict[str, np.ndarray]:
  """The current state (``image`` uint8 [H, W, 3], ``pose``) tiled over
  the episode, and the conditioning episodes (lists of (obs, action, rew,
  new_obs, done, debug), resampled to ``fixed_length``), as one task's
  meta features."""
  del timestep
  if len(prev_episode_data) < 1:
    raise ValueError(
        'prev_episode_data should at least contain one (demo) episode.')
  image = np.asarray(get_field(state, 'image'))
  pose = np.asarray(get_field(state, 'pose'), np.float32)
  features = {
      'inference/features/image': np.tile(
          image[None], (fixed_length,) + (1,) * image.ndim).astype(np.uint8),
      'inference/features/gripper_pose': np.tile(
          pose[None], (fixed_length,) + (1,) * pose.ndim)}
  images, poses, actions = [], [], []
  for i in range(num_condition_samples_per_task):
    episode = make_fixed_length(
        prev_episode_data[i % len(prev_episode_data)], fixed_length)
    images.append(np.stack([np.asarray(get_field(t[0], 'image'))
                            for t in episode]))
    poses.append(np.stack([np.asarray(get_field(t[0], 'pose'), np.float32)
                           for t in episode]))
    actions.append(np.stack([np.asarray(t[1], np.float32)
                             for t in episode]))
  features['condition/features/image'] = np.stack(images).astype(np.uint8)
  features['condition/features/gripper_pose'] = np.stack(poses)
  features['condition/labels/action'] = np.stack(actions)
  return add_meta_dims(features)


class VRGripperEnvRegressionModelMAML(MAMLRegressionModel):
  """MAML over a VRGripper regression model (or the DAML model)."""

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_vrgripper_meta_features(
        state, prev_episode_data, timestep,
        self._base_model.episode_length, 1)


class _FixedCountMetaModel(AbstractT2RModel):
  """The meta specs of fixed episode counts from a subclass's episode
  specs, the vrgripper preprocessor on each side, and the labels handed to
  the network."""

  def __init__(self, episode_length: int = 40,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1, **kwargs):
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(**kwargs)
    self._episode_length = episode_length
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  @property
  def episode_length(self) -> int:
    return self._episode_length

  def _episode_feature_specification(self, mode: str):
    raise NotImplementedError

  def _episode_label_specification(self, mode: str):
    raise NotImplementedError

  @property
  def preprocessor(self):
    if self._preprocessor is None:
      base = vrgripper_env_models.DefaultVRGripperPreprocessor(
          model_feature_specification_fn=self._episode_feature_specification,
          model_label_specification_fn=self._episode_label_specification)
      self._preprocessor = meta_preprocessors.FixedLenMetaExamplePreprocessor(
          base_preprocessor=base,
          num_condition_samples_per_task=self._num_condition,
          num_inference_samples_per_task=self._num_inference)
    return self._preprocessor

  def get_feature_specification(self, mode: str):
    return meta_preprocessors.create_maml_feature_spec(
        self._episode_feature_specification(mode),
        self._episode_label_specification(mode),
        self._num_condition, self._num_inference)

  def get_label_specification(self, mode: str):
    return meta_preprocessors.create_maml_label_spec(
        self._episode_label_specification(mode), self._num_inference)

  def network_inputs(self, features, labels):
    """The features and the labels (None or empty: no loss)."""
    return (features, dict(labels) if labels else None)

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str):
    """The loss and the train outputs, by their names."""
    loss, train_outputs = self.model_train_fn(state, features, labels,
                                              inference_outputs, mode)
    return {'loss': loss, **train_outputs}


def _image_spec(episode_length: int) -> TensorSpec:
  return TensorSpec((episode_length, 100, 100, 3), np.float32, name='image0',
                    data_format='jpeg')


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                         min=1e-12)


class _TecNet(nn.Module):
  """The TEC network: the condition episodes' embedding (the image
  embedding's keypoints reduced over time, l2-normalized), FiLM of the
  inference tower where asked, and the policy (``a_func``) decoded by the
  action decoder."""

  def __init__(self, action_size: int, num_waypoints: int,
               episode_length: int, fc_embed_size: int,
               ignore_embedding: bool, use_film: bool,
               predict_end_weight: float, decoder_cls: Type[nn.Module],
               decoder_kwargs: Optional[Dict[str, Any]] = None,
               gripper_pose_size: int = GRIPPER_POSE_SIZE):
    super().__init__()
    self.episode_length = episode_length
    self.fc_embed_size = fc_embed_size
    self.ignore_embedding = ignore_embedding
    self.use_film = use_film
    self.image_embedding = tec.EmbedConditionImages()
    self.fc_reduce = tec.ReduceTemporalEmbeddings(POINTS, episode_length,
                                                  fc_embed_size)
    if use_film:
      self.film_params = vision_layers.FilmParams(fc_embed_size)
    self.state_features = vision_layers.ImagesToFeaturesNet()
    width = POINTS + gripper_pose_size + (
        0 if ignore_embedding else fc_embed_size)
    self.aux_output_dim = 1 if predict_end_weight > 0 else 0
    self.a_func = vision_layers.ImageFeaturesToPoseNet(
        width, num_outputs=None, aux_output_dim=self.aux_output_dim)
    self.action_decoder = decoder_cls(
        in_features=self.a_func.fc_layers[-1],
        output_size=num_waypoints * action_size, **(decoder_kwargs or {}))

  def embed_episode(self, images: torch.Tensor, train: bool):
    """[B, n, T, H, W, C] -> the l2-normalized [B, n, fc_embed_size]."""
    image_embedding = meta_data.multi_batch_apply(
        lambda image: self.image_embedding(image, train=train), 3, images)
    return _l2_normalize(meta_data.multi_batch_apply(
        self.fc_reduce, 2, image_embedding))

  def forward(self, features, labels=None, mode: str = ModeKeys.PREDICT):
    train = mode == ModeKeys.TRAIN
    condition_images = _as_float(features['condition/features/image'])
    inference_images = _as_float(features['inference/features/image'])
    gripper_pose = _as_float(features['inference/features/gripper_pose'])
    condition_embedding = self.embed_episode(condition_images, train)
    if self.use_film:
      film = self.film_params(condition_embedding)
      film = film[:, :, None, :].expand(
          tuple(film.shape[:2]) + (self.episode_length, film.shape[-1]))
      state_features, _ = meta_data.multi_batch_apply(
          lambda image, params: self.state_features(
              image, film_output_params=params, train=train), 3,
          inference_images, film)
    else:
      state_features, _ = meta_data.multi_batch_apply(
          lambda image: self.state_features(image, train=train), 3,
          inference_images)
    parts = [state_features, gripper_pose]
    if not self.ignore_embedding:
      parts.append(condition_embedding[..., :self.fc_embed_size][
          :, :, None, :].expand(tuple(state_features.shape[:3]) +
                                (self.fc_embed_size,)))
    if self.aux_output_dim:
      action_params, end_token = self.a_func(torch.cat(parts, -1))
    else:
      action_params, end_token = self.a_func(torch.cat(parts, -1)), None
    decoded = self.action_decoder(
        action_params,
        labels_action=None if labels is None else labels['action'])
    outputs = {'inference_output': decoded['action'],
               'condition_embedding': condition_embedding}
    if 'loss' in decoded:
      outputs['bc_loss'] = decoded['loss']
    if end_token is not None:
      outputs['end_token_logits'] = end_token
      outputs['end_token'] = torch.sigmoid(end_token)
      outputs['inference_output'] = torch.cat(
          [outputs['inference_output'], outputs['end_token']], -1)
    if mode != ModeKeys.PREDICT:
      outputs['inference_embedding'] = self.embed_episode(inference_images,
                                                          train)
    return outputs


class VRGripperEnvTecModel(_FixedCountMetaModel):
  """Task-embedded control: behavior cloning conditioned on a demo's
  embedding, with a contrastive embedding loss and an optional end-token
  loss."""

  def __init__(self, action_size: int = 7, gripper_pose_size: int = 14,
               num_waypoints: int = 1, embed_loss_weight: float = 0.0,
               fc_embed_size: int = 32, ignore_embedding: bool = False,
               action_decoder_cls: Type[nn.Module] = decoders.MDNActionDecoder,
               action_decoder_kwargs: Optional[dict] = None,
               predict_end_weight: float = 0.0, use_film: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    self._action_size = action_size
    self._gripper_pose_size = gripper_pose_size
    self._num_waypoints = num_waypoints
    self._embed_loss_weight = embed_loss_weight
    self._fc_embed_size = fc_embed_size
    self._ignore_embedding = ignore_embedding
    self._action_decoder_cls = action_decoder_cls
    self._action_decoder_kwargs = dict(action_decoder_kwargs or {})
    self._predict_end_weight = predict_end_weight
    self._use_film = use_film

  def _episode_feature_specification(self, mode: str):
    del mode
    return {'image': _image_spec(self._episode_length),
            'gripper_pose': TensorSpec(
                (self._episode_length, self._gripper_pose_size), np.float32,
                name='world_pose_gripper')}

  def _episode_label_specification(self, mode: str):
    del mode
    return {'action': TensorSpec(
        (self._episode_length, self._num_waypoints * self._action_size),
        np.float32, name='action_world')}

  def create_network(self) -> nn.Module:
    return _TecNet(
        action_size=self._action_size, num_waypoints=self._num_waypoints,
        episode_length=self._episode_length,
        fc_embed_size=self._fc_embed_size,
        ignore_embedding=self._ignore_embedding, use_film=self._use_film,
        predict_end_weight=self._predict_end_weight,
        decoder_cls=self._action_decoder_cls,
        decoder_kwargs=self._action_decoder_kwargs or None,
        gripper_pose_size=self._gripper_pose_size)

  def _end_loss(self, inference_outputs) -> torch.Tensor:
    """The end token's cross entropy, the last two steps labeled ends."""
    if self._predict_end_weight <= 0:
      return torch.zeros((), dtype=torch.float32, device=self.device)
    logits = inference_outputs['end_token_logits'].to(torch.float32)
    end_labels = torch.zeros_like(logits)
    end_labels[:, :, -2:, :] = 1.0
    return F.binary_cross_entropy_with_logits(logits, end_labels)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """bc + embed_loss_weight contrastive + predict_end_weight end."""
    bc_loss = inference_outputs['bc_loss']
    embed_loss = tec.compute_embedding_contrastive_loss(
        inference_outputs['inference_embedding'],
        inference_outputs['condition_embedding'])
    end_loss = self._end_loss(inference_outputs)
    return (bc_loss + self._embed_loss_weight * embed_loss +
            self._predict_end_weight * end_loss), {
                'bc_loss': bc_loss, 'embed_loss': embed_loss,
                'end_loss': end_loss}

  def pack_features(self, state, prev_episode_data, timestep):
    return pack_vrgripper_meta_features(
        state, prev_episode_data, timestep, self._episode_length,
        self._num_condition)


class _SnailSequenceNet(nn.Module):
  """The per-frame tower and SNAIL's stack (``tc1``, ``attn1``, ``tc2``,
  ``attn2``, then ``poses``) over the whole frame sequence, causally."""

  def __init__(self, output_size: int, sequence_length: int,
               aux_size: int = GRIPPER_POSE_SIZE, filters: int = 32,
               key_size: int = 16, value_size: int = 16):
    super().__init__()
    self.state_features = vision_layers.ImagesToFeaturesNet()
    self.tc1 = snail.TCBlock(POINTS + aux_size, sequence_length, filters)
    self.attn1 = snail.AttentionBlock(self.tc1.out_features, key_size,
                                      value_size)
    self.tc2 = snail.TCBlock(self.attn1.out_features, sequence_length,
                             filters)
    self.attn2 = snail.AttentionBlock(self.tc2.out_features, key_size,
                                      value_size)
    self.poses = Dense(self.attn2.out_features, output_size)

  def forward(self, images, aux_input, train: bool = False):
    state_features, _ = meta_data.multi_batch_apply(
        lambda image: self.state_features(image, train=train), 2, images)
    net = self.tc1(torch.cat([state_features, aux_input], -1))
    net, _ = self.attn1(net)
    net, end_points = self.attn2(self.tc2(net))
    return self.poses(net), {'attn_probs/0': end_points['attn_prob']}


class _SequentialNet(nn.Module):
  """Condition episode 0 then inference episode 0 as one sequence through
  ``snail``; the inference tail decoded (a mixture's mode, or the poses)."""

  def __init__(self, action_size: int, episode_length: int,
               num_mixture_components: int = 1,
               condition_gripper_pose: bool = False):
    super().__init__()
    self.action_size = action_size
    self.num_mixture_components = num_mixture_components
    self.condition_gripper_pose = condition_gripper_pose
    if num_mixture_components > 1:
      num_outputs = num_mixture_components * (1 + 2 * action_size)
    else:
      num_outputs = action_size
    self.snail = _SnailSequenceNet(num_outputs, 2 * episode_length)

  def forward(self, features, labels=None, mode: str = ModeKeys.PREDICT):
    condition_images = _as_float(features['condition/features/image'])
    inference_images = _as_float(features['inference/features/image'])
    cond_pose = _as_float(features['condition/features/gripper_pose'])
    inf_pose = _as_float(features['inference/features/gripper_pose'])
    if not self.condition_gripper_pose:
      # Imitation from video: the demo's poses are hidden.
      cond_pose = torch.zeros_like(cond_pose)
    condition_length = condition_images.shape[2]
    images = torch.cat([condition_images[:, 0], inference_images[:, 0]], 1)
    aux_input = torch.cat([cond_pose[:, 0], inf_pose[:, 0]], 1)
    poses, end_points = self.snail(images, aux_input,
                                   train=mode == ModeKeys.TRAIN)
    tail = poses[:, condition_length:]
    action_labels = (None if labels is None
                     else _as_float(labels['action'])[:, 0])
    outputs = {}
    if self.num_mixture_components > 1:
      gm = mdn.get_mixture_distribution(tail.to(torch.float32),
                                        self.num_mixture_components,
                                        self.action_size)
      inference_poses = mdn.gaussian_mixture_approximate_mode(gm)
      if action_labels is not None:
        outputs['bc_loss'] = -mdn.mixture_log_prob(gm, action_labels).mean()
    else:
      inference_poses = tail
      if action_labels is not None:
        outputs['bc_loss'] = ((tail.to(torch.float32) - action_labels) **
                              2).mean()
    outputs['inference_output'] = inference_poses[:, None]
    outputs.update(end_points)
    return outputs


class VRGripperEnvSequentialModel(VRGripperEnvTecModel):
  """The SNAIL (RL^2-style) sequential meta-learner: the demo's frames
  then the trial's, causally, one action a trial step."""

  def __init__(self, condition_gripper_pose: bool = False,
               num_mixture_components: int = 1, greedy_action: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    self._condition_gripper_pose = condition_gripper_pose
    self._num_mixture_components = num_mixture_components
    self._greedy_action = greedy_action

  def create_network(self) -> nn.Module:
    return _SequentialNet(
        action_size=self._action_size, episode_length=self._episode_length,
        num_mixture_components=self._num_mixture_components,
        condition_gripper_pose=self._condition_gripper_pose)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    bc_loss = inference_outputs['bc_loss']
    return bc_loss, {'bc_loss': bc_loss}
