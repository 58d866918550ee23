"""QT-Opt T2R models: the Grasping44 critic, its training loss and its CEM
action selector.

The counterpart of the JAX package's ``research/qtopt/t2r_models.py``:

  * ``GraspingQNetwork`` extracts the image and the action features from a
    feature dict and runs ``Grasping44Network``;
  * ``DefaultGrasping44ImagePreprocessor`` crops the uint8 512x640 frame to
    472x472 and divides by 255, through the port's crop + convert kernel
    K1: at random offsets in TRAIN, in the center otherwise; in TRAIN it
    then applies the photometric distortions it is configured with;
  * ``LegacyGraspingModelWrapper`` holds the legacy hparams (momentum with
    staircase decay, the EMA of the weights) and the loss: mean sigmoid
    cross entropy of the Q logit against the grasp success, plus the l2
    weight decay;
  * ``Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom`` is the
    flagship critic, with its specifications, ``serving_feature_spec``,
    the CEM selectors that ``PolicyServer`` serves and ``pack_features``,
    the feed of ``policies.CEMPolicy``.

The specifications carry the JAX critic's on-disk names (``TensorSpec``):
the frame is the JPEG ``image_1``, each action and gripper feature is
stored under its own key, and the label ``reward`` is ``grasp_success``;
so the records that the JAX package writes for its critic are this
critic's records too.

The batched selector writes the batch dimension out where the JAX one
vmaps over requests: the crop and the image tower run over the B frames
at once, and each CEM iteration scores the B x cem_samples candidates in
one pass of the network's head.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.models.critic_model import (
    sigmoid_binary_cross_entropy)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors import pallas_crop
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.research.qtopt import optimizer_builder
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.utils import cross_entropy

__all__ = ['ACTION_DIM_LAYOUT', 'CEM_ACTION_SIZE', 'INPUT_SHAPE',
           'TARGET_SHAPE', 'DefaultGrasping44ImagePreprocessor',
           'GraspingQNetwork',
           'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom',
           'LegacyGraspingModelWrapper', 'pack_features_kuka_e2e']

INPUT_SHAPE = (512, 640, 3)
TARGET_SHAPE = (472, 472)

# Flat [N, 10] action-vector layout: the first 8 dims are CEM-sampled
# controls, the last 2 the gripper status carried in the action spec.
ACTION_DIM_LAYOUT = (
    ('world_vector', 3),
    ('vertical_rotation', 2),
    ('close_gripper', 1),
    ('open_gripper', 1),
    ('terminate_episode', 1),
)
CEM_ACTION_SIZE = 8
_STATE_SCALARS = ('gripper_closed', 'height_to_bottom')
# Grasping44Network's weight decay (the JAX module's l2_regularization).
L2_REGULARIZATION = 0.00007
_NETWORK = 'grasping44'


def pack_features_kuka_e2e(t2r_model, state, context, timestep, actions
                           ) -> Dict[str, np.ndarray]:
  """One observation and N candidate actions as the PREDICT feed of the
  flagship critic (the JAX package's ``pack_features_kuka_e2e``).

  ``state`` holds 'image' (the uint8 [512, 640, 3] frame) and the scalars
  'gripper_closed' and 'height_to_bottom'; ``actions`` are [N, 8] CEM
  samples laid out by ``ACTION_DIM_LAYOUT``. The frame goes in once (batch
  1), the N actions as rows, each with the gripper scalars.
  """
  del t2r_model, context, timestep
  actions = np.asarray(actions, np.float32)
  features = {'state/image': np.expand_dims(np.asarray(state['image']), 0)}
  offset = 0
  for key, size in ACTION_DIM_LAYOUT:
    features['action/' + key] = actions[:, offset:offset + size]
    offset += size
  for key in _STATE_SCALARS:
    features['action/' + key] = np.full((actions.shape[0], 1),
                                        np.float32(state[key]))
  return features


class GraspingQNetwork(nn.Module):
  """Feature-dict adapter around ``Grasping44Network``.

  Concatenates the action features in ``grasp_param_keys`` order; with
  ``B * A`` action rows for ``B`` images (the CEM megabatch) the image
  tower runs once per image and scores its ``A`` candidates.
  """

  def __init__(self,
               grasp_param_keys: Tuple[str, ...] = networks.E2E_GRASP_PARAM_KEYS,
               grasp_param_names: Optional[Dict[str, Tuple[int, int]]] = None,
               dtype: torch.dtype = torch.float32,
               network_kwargs: Optional[Dict[str, Any]] = None,
               image_size: int = TARGET_SHAPE[0]):
    super().__init__()
    self.grasp_param_keys = tuple(grasp_param_keys)
    network_kwargs = {'image_size': image_size, **(network_kwargs or {})}
    self.grasping44 = networks.Grasping44Network(
        grasp_param_names=grasp_param_names, dtype=dtype, **network_kwargs)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    image = features['state/image']
    grasp_params = torch.cat(
        [torch.as_tensor(features['action/' + key]).to(torch.float32)
         .reshape(features['action/' + key].shape[0], -1)
         for key in self.grasp_param_keys], dim=-1)
    batch = image.shape[0]
    if grasp_params.shape[0] != batch:
      grasp_params = grasp_params.reshape(batch, -1, grasp_params.shape[-1])
    endpoints = self.grasping44(image, grasp_params,
                                train=mode == ModeKeys.TRAIN)
    q_logits = endpoints['logits']
    if q_logits.dim() > 1 and q_logits.shape[-1] == 1:
      q_logits = q_logits.squeeze(-1)
    return {'q_predicted': endpoints['predictions'].reshape(-1),
            'q_logits': q_logits.reshape(-1),
            'pool2': endpoints['pool2'],
            'final_conv': endpoints['final_conv']}


class DefaultGrasping44ImagePreprocessor:
  """The Grasping44 image preprocessor.

  uint8 [B, 512, 640, 3] frames become float32 [B, 472, 472, 3] in
  [0, 1]: the crop, then ``/ 255``, in one pass of kernel K1. TRAIN crops
  at uniform random offsets drawn from the caller's ``torch.Generator``
  (or at given ``offsets``); EVAL and PREDICT crop the center. In TRAIN
  only, the photometric distortions of ``distortion_kwargs`` (the keyword
  arguments of ``image_transformations.apply_photometric_image_distortions``;
  none by default, as in JAX and ``train_qtopt.gin``) follow the crop,
  drawn from the same generator after the offsets (or given as
  ``distortion_parameters``), so that a resumed run draws what an
  uninterrupted one would have.

  ``feature_spec_fn`` and ``label_spec_fn`` are the model's specification
  functions; the in-specifications (what an input generator makes) are
  theirs with the raw uint8 frame in place of the cropped image.
  """

  def __init__(self, feature_spec_fn: Optional[Callable] = None,
               label_spec_fn: Optional[Callable] = None,
               distortion_kwargs: Optional[dict] = None):
    self._distortion_kwargs = dict(distortion_kwargs or {})
    unknown = sorted(set(self._distortion_kwargs) -
                     set(image_transformations.PHOTOMETRIC_DEFAULTS))
    if unknown:
      raise TypeError('distortion_kwargs has unknown keys {}.'.format(
          unknown))
    self._feature_spec_fn = feature_spec_fn
    self._label_spec_fn = label_spec_fn

  def get_in_feature_specification(self, mode: str) -> Dict[str, tuple]:
    """The model's specification with the raw frame, JPEG on disk, in
    place of the crop."""
    spec = dict(self._feature_spec_fn(mode))
    image = spec['state/image']
    spec['state/image'] = TensorSpec(INPUT_SHAPE, np.uint8,
                                     name=getattr(image, 'name', None),
                                     data_format='jpeg')
    return spec

  def get_in_label_specification(self, mode: str) -> Dict[str, tuple]:
    return dict(self._label_spec_fn(mode))

  def preprocess_images(self, images: torch.Tensor,
                        mode: str = ModeKeys.PREDICT,
                        generator: Optional[torch.Generator] = None,
                        offsets: Optional[torch.Tensor] = None,
                        distortion_parameters: Optional[list] = None
                        ) -> torch.Tensor:
    if offsets is None:
      shape = tuple(images.shape[1:3])
      if mode == ModeKeys.TRAIN:
        if generator is None:
          raise ValueError('TRAIN-mode preprocessing needs a generator (or '
                           'offsets) for its random crop.')
        offsets = image_transformations.random_crop_offsets(
            images.shape[0], shape, TARGET_SHAPE, generator)
      else:
        offsets = image_transformations.center_crop_offsets(
            images.shape[0], shape, TARGET_SHAPE, device=images.device)
    image = pallas_crop.crop_convert(images, offsets, TARGET_SHAPE,
                                     torch.float32, 255.0)
    if mode != ModeKeys.TRAIN or not self._distortion_kwargs:
      return image
    return image_transformations.apply_photometric_image_distortions(
        [image], distortion_parameters, generator,
        **self._distortion_kwargs)[0]

  def preprocess(self, features, labels, mode: str,
                 generator: Optional[torch.Generator] = None,
                 offsets: Optional[torch.Tensor] = None,
                 distortion_parameters: Optional[list] = None):
    """(features, labels) with ``state/image`` cropped, converted and, in
    TRAIN, distorted."""
    features = dict(features)
    features['state/image'] = self.preprocess_images(
        features['state/image'], mode, generator, offsets,
        distortion_parameters)
    return features, labels


class LegacyGraspingModelWrapper(CriticModel):
  """The Grasping44 family's model wrapper.

  Trains with the legacy optimizer (momentum, staircase decay; see
  ``optimizer_builder``) and an EMA of the weights, which it serves and
  evaluates (``use_avg_model_params``), as the JAX wrapper does.
  ``network_kwargs`` go to ``Grasping44Network``; ``loss_function(targets,
  q_predicted)`` replaces the default loss; ``optimizer_override`` is a
  zero-arg optimizer factory that replaces the legacy one.
  """

  def __init__(self,
               loss_function: Optional[Callable] = None,
               learning_rate: float = 1e-4,
               model_weights_averaging: float = 0.9999,
               momentum: float = 0.9,
               use_avg_model_params: bool = True,
               learning_rate_decay_factor: float = 0.999,
               preprocessor_cls=DefaultGrasping44ImagePreprocessor,
               optimizer_override: Optional[Callable] = None,
               network_kwargs: Optional[Dict[str, Any]] = None,
               **kwargs):
    self.hparams = optimizer_builder.default_hparams(
        learning_rate=learning_rate,
        learning_rate_decay_factor=learning_rate_decay_factor,
        model_weights_averaging=model_weights_averaging,
        momentum=momentum,
        use_avg_model_params=use_avg_model_params)
    self._loss_function = loss_function
    self._network_kwargs = dict(network_kwargs or {})
    super().__init__(
        preprocessor_cls=preprocessor_cls,
        use_avg_model_params=use_avg_model_params,
        create_optimizer_fn=(optimizer_override or
                             (lambda: optimizer_builder.build_opt(
                                 self.hparams))),
        avg_model_params_decay=model_weights_averaging,
        **kwargs)

  @property
  def legacy_network_kwargs(self) -> dict:
    return dict(self._network_kwargs)

  def get_label_specification(self, mode: str) -> Dict[str, tuple]:
    """The grasp success, served as the ``reward`` label."""
    del mode
    return {'reward': TensorSpec((1,), np.float32, name='grasp_success')}

  @property
  def l2_regularization_scale(self) -> float:
    return self._network_kwargs.get('l2_regularization', L2_REGULARIZATION)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """Grasp cross entropy + l2 weight decay; returns (loss,
    {'grasp_loss', 'l2_loss'})."""
    q_logits = inference_outputs['q_logits']
    targets = labels[self.reward_key].to(torch.float32).reshape(
        q_logits.shape)
    if self._loss_function is not None:
      grasp_loss = self._loss_function(targets,
                                       inference_outputs[self.q_key])
    else:
      grasp_loss = sigmoid_binary_cross_entropy(
          q_logits.to(torch.float32), targets).mean()
    l2_loss = networks.l2_regularization_loss(state,
                                              self.l2_regularization_scale)
    return grasp_loss + l2_loss, {'grasp_loss': grasp_loss,
                                  'l2_loss': l2_loss}


class Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
    LegacyGraspingModelWrapper):
  """The QT-Opt flagship critic: open/close/terminate controls with the
  gripper status and height to bottom in the action vector."""

  def get_state_specification(self) -> Dict[str, tuple]:
    return {'image': TensorSpec(TARGET_SHAPE + (3,), np.float32,
                                name='image_1')}

  def get_action_specification(self) -> Dict[str, tuple]:
    return {key: TensorSpec((size,), np.float32, name=key) for key, size in
            ACTION_DIM_LAYOUT + tuple((k, 1) for k in _STATE_SCALARS)}

  def pack_features(self, state, context, timestep, actions):
    """``pack_features_kuka_e2e``: the feed of ``policies.CEMPolicy``."""
    return pack_features_kuka_e2e(self, state, context, timestep, actions)

  def create_network(self) -> nn.Module:
    network_kwargs = self.legacy_network_kwargs
    # The flax module reads l2_regularization only in its loss helper.
    network_kwargs.pop('l2_regularization', None)
    return GraspingQNetwork(
        grasp_param_keys=networks.E2E_GRASP_PARAM_KEYS,
        grasp_param_names=networks.E2E_GRASP_PARAM_NAMES,
        dtype=self.compute_dtype,
        network_kwargs=network_kwargs or None)

  def serving_feature_spec(self, image_shape=INPUT_SHAPE):
    """Per-request ``{name: (shape, dtype)}``, no batch dim: the raw
    camera frame and the two gripper scalars."""
    return {
        'image': (tuple(image_shape), np.uint8),
        'gripper_closed': ((), np.float32),
        'height_to_bottom': ((), np.float32),
    }

  def make_batched_select_action(self, cem_samples: int = 64,
                                 cem_iters: int = 3, num_elites: int = 10,
                                 network: Optional[nn.Module] = None):
    """The serving batch program: B independent CEM selects in one call.

    Returns ``batch_select(variables, states, seed, noise=None)`` with
    ``states`` = {'image' uint8 [B, H, W, 3], 'gripper_closed' [B],
    'height_to_bottom' [B]} (numpy or tensors) and ``seed`` an integer
    that seeds the device generator of the CEM noise; it returns
    {'action' [B, 8], 'q' [B]} on the model's device, ``q`` being the
    selected action's Q-value. ``noise`` [cem_iters, B, cem_samples, 8]
    replaces the generator's draws (tests feed JAX's).

    This is the ``batch_fn(variables, features, seed)`` contract of
    ``serving.PolicyServer``.

    ``network`` is the module the weights are called through (the model's
    own by default). ``torch.func.functional_call`` swaps a module's
    tensors while it runs, so two threads must not call through one
    module: each replica of a serving fleet passes a copy of its own.
    """
    device = self.device
    network = getattr(self.network if network is None else network,
                      _NETWORK)
    prefix = _NETWORK + '.'

    def batch_select(variables, states, seed, noise=None):
      params = {name[len(prefix):]: value for name, value
                in self.select_params(variables).items()}
      with torch.inference_mode():
        images = torch.as_tensor(states['image']).to(device)
        batch = images.shape[0]
        scalars = [torch.as_tensor(states[key], dtype=torch.float32)
                   .to(device).reshape(batch, 1, 1)
                   for key in _STATE_SCALARS]
        image = self.preprocessor.preprocess_images(images)
        # The tower does not depend on the candidate actions, so it runs
        # once per request and every CEM iteration scores its candidates
        # against the same pool2. (The JAX selector recomputes the tower
        # inside each iteration; the outputs are the same.)
        pool2 = torch.func.functional_call(network, params, (image,),
                                           strict=True)['pool2']

        def objective(samples):  # [B, S, 8] -> [B, S]
          grasp_params = torch.cat(
              [samples] + [s.expand(batch, samples.shape[1], 1)
                           for s in scalars], dim=-1)
          return torch.func.functional_call(
              network, params, (None, grasp_params), {'pool2': pool2},
              strict=True)['predictions']

        generator = None
        if noise is None:
          generator = torch.Generator(device=device)
          generator.manual_seed(int(seed))
        mean = torch.zeros((batch, CEM_ACTION_SIZE), device=device)
        _, _, best = cross_entropy.normal_cem(
            objective, mean, torch.ones_like(mean), generator,
            num_samples=cem_samples, num_elites=num_elites,
            num_iterations=cem_iters,
            noise=None if noise is None else torch.as_tensor(noise))
        q = objective(best[:, None, :])[:, 0]
      return {'action': best, 'q': q}

    return batch_select

  def make_on_device_select_action(self, cem_samples: int = 64,
                                   cem_iters: int = 3, num_elites: int = 10):
    """One request's CEM select: ``select(variables, state, seed,
    noise=None) -> (action [8], q)``, the batched program at B = 1."""
    batch_select = self.make_batched_select_action(cem_samples, cem_iters,
                                                   num_elites)

    def select(variables, state, seed, noise=None):
      states = {key: torch.as_tensor(value)[None]
                for key, value in state.items()}
      if noise is not None:
        noise = torch.as_tensor(noise)[:, None]
      outputs = batch_select(variables, states, seed, noise)
      return outputs['action'][0], outputs['q'][0]

    return select
