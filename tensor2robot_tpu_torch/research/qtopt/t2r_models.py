"""QT-Opt T2R models, serving half: the Grasping44 critic and its CEM
action selector.

The counterpart of the JAX package's ``research/qtopt/t2r_models.py``:

  * ``GraspingQNetwork`` extracts the image and the action features from a
    feature dict and runs ``Grasping44Network``;
  * ``DefaultGrasping44ImagePreprocessor`` center-crops the uint8 512x640
    frame to 472x472 and divides by 255 (the PREDICT path), through the
    port's crop + convert kernel K1;
  * ``Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom`` is the
    flagship critic, with ``serving_feature_spec`` and the CEM selectors
    that ``PolicyServer`` serves.

The batched selector writes the batch dimension out where the JAX one
vmaps over requests: the crop and the image tower run over the B frames
at once, and each CEM iteration scores the B x cem_samples candidates in
one pass of the network's head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors import pallas_crop
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.utils import cross_entropy

__all__ = ['ACTION_DIM_LAYOUT', 'CEM_ACTION_SIZE', 'INPUT_SHAPE',
           'TARGET_SHAPE', 'DefaultGrasping44ImagePreprocessor',
           'GraspingQNetwork',
           'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom',
           'LegacyGraspingModelWrapper']

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
_NETWORK = 'grasping44'


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
    self.grasping44 = networks.Grasping44Network(
        grasp_param_names=grasp_param_names, dtype=dtype,
        image_size=image_size, **(network_kwargs or {}))

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    if mode == ModeKeys.TRAIN:
      raise NotImplementedError('Training comes with the training slice.')
    image = features['state/image']
    grasp_params = torch.cat(
        [torch.as_tensor(features['action/' + key]).to(torch.float32)
         .reshape(features['action/' + key].shape[0], -1)
         for key in self.grasp_param_keys], dim=-1)
    batch = image.shape[0]
    if grasp_params.shape[0] != batch:
      grasp_params = grasp_params.reshape(batch, -1, grasp_params.shape[-1])
    endpoints = self.grasping44(image, grasp_params)
    q_logits = endpoints['logits']
    if q_logits.dim() > 1 and q_logits.shape[-1] == 1:
      q_logits = q_logits.squeeze(-1)
    return {'q_predicted': endpoints['predictions'].reshape(-1),
            'q_logits': q_logits.reshape(-1),
            'pool2': endpoints['pool2'],
            'final_conv': endpoints['final_conv']}


class DefaultGrasping44ImagePreprocessor:
  """The Grasping44 image preprocessor, PREDICT and EVAL path.

  uint8 [B, 512, 640, 3] frames become float32 [B, 472, 472, 3] in
  [0, 1]: the center crop, then ``/ 255``, in one pass of kernel K1.
  The TRAIN path (random crop, photometric distortions) comes with the
  training slice.
  """

  def preprocess_images(self, images: torch.Tensor) -> torch.Tensor:
    offsets = image_transformations.center_crop_offsets(
        images.shape[0], tuple(images.shape[1:3]), TARGET_SHAPE,
        device=images.device)
    return pallas_crop.crop_convert(images, offsets, TARGET_SHAPE,
                                    torch.float32, 255.0)


class LegacyGraspingModelWrapper(CriticModel):
  """The Grasping44 family's model wrapper (inference half).

  Serves the EMA weights (``use_avg_model_params``) by default, as the
  JAX wrapper does; ``network_kwargs`` go to ``Grasping44Network``.
  """

  def __init__(self,
               use_avg_model_params: bool = True,
               preprocessor_cls=DefaultGrasping44ImagePreprocessor,
               network_kwargs: Optional[Dict[str, Any]] = None,
               **kwargs):
    self._network_kwargs = dict(network_kwargs or {})
    super().__init__(preprocessor_cls=preprocessor_cls,
                     use_avg_model_params=use_avg_model_params, **kwargs)

  @property
  def legacy_network_kwargs(self) -> dict:
    return dict(self._network_kwargs)


class Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
    LegacyGraspingModelWrapper):
  """The QT-Opt flagship critic: open/close/terminate controls with the
  gripper status and height to bottom in the action vector."""

  def create_network(self) -> nn.Module:
    return GraspingQNetwork(
        grasp_param_keys=networks.E2E_GRASP_PARAM_KEYS,
        grasp_param_names=networks.E2E_GRASP_PARAM_NAMES,
        dtype=self.compute_dtype,
        network_kwargs=self.legacy_network_kwargs or None)

  def serving_feature_spec(self, image_shape=INPUT_SHAPE):
    """Per-request ``{name: (shape, dtype)}``, no batch dim: the raw
    camera frame and the two gripper scalars."""
    return {
        'image': (tuple(image_shape), np.uint8),
        'gripper_closed': ((), np.float32),
        'height_to_bottom': ((), np.float32),
    }

  def make_batched_select_action(self, cem_samples: int = 64,
                                 cem_iters: int = 3, num_elites: int = 10):
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
    """
    device = self.device
    network = getattr(self.network, _NETWORK)
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
