"""Grasp2Vec: self-supervised object embeddings, in PyTorch.

The counterpart of the JAX package's ``research/grasp2vec/
grasp2vec_model.py``: ``maybe_crop_images``, ``Grasp2VecPreprocessor``,
``EmbeddingNet`` (a ResNet tower without its head: the mean of its relu'd
last map, and the map), ``Grasp2VecNet`` (the scene and goal towers) and
``Grasp2VecModel``, whose loss holds phi(pregrasp) - phi(postgrasp) to
phi(goal) (``losses.n_pairs_loss`` by default).

The preprocessor crops the uint8 512x640 frames to 472x472 and divides by
255 through kernel K1 (``preprocessors/pallas_crop.crop_convert``), JAX's
``dynamic_slice`` and ``/ 255.0`` exactly (K1 multiplies by float32 1/255,
which is what XLA compiles the division to): pregrasp and postgrasp at one
shared offset, the goal at its own, all three in one launch where their
crops have one size (the per-frame offsets of K1 take the two offsets),
else one launch for the scene and one for the goal.
The flips come after. The scene tower takes pregrasp and postgrasp as one
doubled batch, so its batch norms' statistics are JAX's.

TRAIN draws the two offsets and the flips from the step's generator
(``Grasp2VecPreprocessor.draw``); ``preprocess(..., draws=)`` takes them
given, so that a test can feed JAX's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import resnet as resnet_lib
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import pallas_crop
from tensor2robot_tpu_torch.preprocessors.spec_transformation_preprocessor \
    import SpecTransformationPreprocessor
from tensor2robot_tpu_torch.research.grasp2vec import losses
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['EmbeddingNet', 'Grasp2VecModel', 'Grasp2VecNet',
           'Grasp2VecPreprocessor', 'maybe_crop_images']

CropParams = Tuple[int, int, int, int, int, int]
_IMAGE_KEYS = ('pregrasp_image', 'postgrasp_image', 'goal_image')


def crop_offset(params: CropParams, mode: str,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
  """The (y, x) offset of one crop, int32 [2]: uniform in the window in
  TRAIN (from ``generator``, on its device), its center otherwise."""
  min_oh, max_oh, _, min_ow, max_ow, _ = params
  if mode != ModeKeys.TRAIN:
    return torch.tensor([(min_oh + max_oh) // 2, (min_ow + max_ow) // 2],
                        dtype=torch.int32, device=device)
  if generator is None:
    raise ValueError('TRAIN-mode cropping needs a generator (or draws).')
  draw = lambda lo, hi: torch.randint(lo, max(hi, lo + 1), (1,),
                                      generator=generator,
                                      device=generator.device)
  return torch.cat([draw(min_oh, max_oh), draw(min_ow, max_ow)]).to(
      torch.int32)


def maybe_crop_images(images: Sequence[torch.Tensor], params: CropParams,
                      mode: str, generator: Optional[torch.Generator] = None,
                      offset: Optional[torch.Tensor] = None
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
  """Every uint8 batch in ``images`` cropped at one shared (y, x) offset
  and converted to float32 / 255, all in one launch of K1; returns
  (crops, offset). ``offset`` given replaces ``crop_offset``'s."""
  if offset is None:
    offset = crop_offset(params, mode, generator, images[0].device)
  frames = torch.cat(list(images)) if len(images) > 1 else images[0]
  offsets = torch.as_tensor(offset, dtype=torch.int32).to(
      frames.device).reshape(1, 2).expand(frames.shape[0], 2).contiguous()
  crops = pallas_crop.crop_convert(frames, offsets, (params[2], params[5]))
  return list(crops.split([image.shape[0] for image in images])), offset


class Grasp2VecPreprocessor(SpecTransformationPreprocessor):
  """512x640 uint8 JPEG frames -> shared-crop, flipped float32."""

  def __init__(self, model_feature_specification_fn=None,
               model_label_specification_fn=None,
               scene_crop: CropParams = (0, 40, 472, 0, 168, 472),
               goal_crop: CropParams = (0, 40, 472, 0, 168, 472),
               src_img_shape: Tuple[int, int, int] = (512, 640, 3)):
    super().__init__(model_feature_specification_fn,
                     model_label_specification_fn)
    self._scene_crop = tuple(scene_crop)
    self._goal_crop = tuple(goal_crop)
    self._src_img_shape = tuple(src_img_shape)

  def update_spec_transform(self, key: str, spec: TensorSpec,
                            mode: str) -> TensorSpec:
    del mode
    if key in _IMAGE_KEYS:
      return TensorSpec(self._src_img_shape, np.uint8, **{
          **spec.fields(), 'data_format': 'jpeg'})
    return spec

  def draw(self, batch: int, generator: torch.Generator
           ) -> Dict[str, torch.Tensor]:
    """TRAIN's draws from ``generator``: ``scene_offset`` and
    ``goal_offset`` (int32 (y, x)), and ``flips`` (bool [3, 2, batch]: per
    image key, left-right then up-down, per example)."""
    scene = crop_offset(self._scene_crop, ModeKeys.TRAIN, generator)
    goal = crop_offset(self._goal_crop, ModeKeys.TRAIN, generator)
    flips = torch.rand((len(_IMAGE_KEYS), 2, batch), generator=generator,
                       device=generator.device) < 0.5
    return {'scene_offset': scene, 'goal_offset': goal, 'flips': flips}

  def _preprocess_fn(self, features, labels, mode, generator=None,
                     draws=None):
    features = dict(features)
    images = [torch.as_tensor(features[key]) for key in _IMAGE_KEYS]
    batch = images[0].shape[0]
    if mode == ModeKeys.TRAIN and draws is None:
      if generator is None:
        raise ValueError('TRAIN-mode preprocessing needs a generator (or '
                         'draws) for its crops and flips.')
      draws = self.draw(batch, generator)
    device = images[0].device
    if mode == ModeKeys.TRAIN:
      scene_offset, goal_offset = draws['scene_offset'], draws['goal_offset']
    else:
      scene_offset = crop_offset(self._scene_crop, mode, device=device)
      goal_offset = crop_offset(self._goal_crop, mode, device=device)
    offset = lambda o: torch.as_tensor(o, dtype=torch.int32).to(
        device).reshape(1, 2)
    if self._scene_crop[2::3] == self._goal_crop[2::3]:
      # One launch of K1 over the three batches, each frame at its offset.
      offsets = torch.cat([offset(scene_offset).expand(2 * batch, 2),
                           offset(goal_offset).expand(batch, 2)])
      crops = pallas_crop.crop_convert(
          torch.cat(images), offsets.contiguous(),
          (self._scene_crop[2], self._scene_crop[5])).split(batch)
    else:
      crops = (maybe_crop_images(images[:2], self._scene_crop, mode,
                                 offset=scene_offset)[0] +
               maybe_crop_images(images[2:], self._goal_crop, mode,
                                 offset=goal_offset)[0])
    for idx, (key, image) in enumerate(zip(_IMAGE_KEYS, crops)):
      if mode == ModeKeys.TRAIN:
        flips = torch.as_tensor(draws['flips']).to(device)
        flip_lr = flips[idx, 0].reshape(batch, 1, 1, 1)
        flip_ud = flips[idx, 1].reshape(batch, 1, 1, 1)
        image = torch.where(flip_lr, image.flip(2), image)
        image = torch.where(flip_ud, image.flip(1), image)
      features[key] = image
    return features, labels


class EmbeddingNet(nn.Module):
  """A ResNet tower without its head: (the mean of its relu'd last map
  [B, D], that map [B, h, w, D]), float32."""

  def __init__(self, resnet_size: int = 50,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.resnet = resnet_lib.ResNet(resnet_size=resnet_size, dtype=dtype,
                                    include_head=False)

  def forward(self, image: torch.Tensor, train: bool = False):
    _, endpoints = self.resnet(image, train=train)
    spatial = F.relu(endpoints['pre_final_pool'])
    return (spatial.mean((1, 2)).to(torch.float32),
            spatial.to(torch.float32))


class Grasp2VecNet(nn.Module):
  """The scene tower over pregrasp and postgrasp as one doubled batch, and
  the goal tower."""

  def __init__(self, resnet_size: int = 50,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.scene = EmbeddingNet(resnet_size, dtype)
    self.goal = EmbeddingNet(resnet_size, dtype)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    train = mode == ModeKeys.TRAIN
    scene_images = torch.cat([features['pregrasp_image'].to(self.dtype),
                              features['postgrasp_image'].to(self.dtype)])
    vector, spatial = self.scene(scene_images, train=train)
    pre_v, post_v = vector.chunk(2)
    pre_s, post_s = spatial.chunk(2)
    goal_v, goal_s = self.goal(features['goal_image'].to(self.dtype),
                               train=train)
    return {'pre_vector': pre_v, 'post_vector': post_v,
            'pre_spatial': pre_s, 'post_spatial': post_s,
            'goal_vector': goal_v, 'goal_spatial': goal_s}


class Grasp2VecModel(AbstractT2RModel):
  """The Grasp2Vec embedding model. ``embedding_loss_fn(pregrasp, goal,
  postgrasp)`` is ``losses.n_pairs_loss`` or ``losses.triplet_loss``;
  the optimizer is ``create_adam_optimizer`` as the gin binds it."""

  def __init__(self,
               scene_size: Tuple[int, int] = (472, 472),
               goal_size: Tuple[int, int] = (472, 472),
               embedding_loss_fn: Callable = losses.n_pairs_loss,
               resnet_size: int = 50,
               preprocessor_cls=Grasp2VecPreprocessor,
               **kwargs):
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)
    self._scene_size = tuple(scene_size)
    self._goal_size = tuple(goal_size)
    self._embedding_loss_fn = embedding_loss_fn
    self._resnet_size = resnet_size

  def get_feature_specification(self, mode: str) -> Dict[str, TensorSpec]:
    """The three images under their on-disk names ``image``,
    ``postgrasp_image`` and ``present_image``."""
    del mode
    return {
        'pregrasp_image': TensorSpec(self._scene_size + (3,), np.float32,
                                     name='image', data_format='jpeg'),
        'postgrasp_image': TensorSpec(self._scene_size + (3,), np.float32,
                                      name='postgrasp_image',
                                      data_format='jpeg'),
        'goal_image': TensorSpec(self._goal_size + (3,), np.float32,
                                 name='present_image', data_format='jpeg')}

  def get_label_specification(self, mode: str) -> Dict[str, TensorSpec]:
    """Grasp2Vec is self-supervised: no labels."""
    del mode
    return {}

  def create_network(self) -> nn.Module:
    return Grasp2VecNet(self._resnet_size, self.compute_dtype)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    embed_loss = self._embedding_loss_fn(inference_outputs['pre_vector'],
                                         inference_outputs['goal_vector'],
                                         inference_outputs['post_vector'])
    if isinstance(embed_loss, tuple):   # triplet_loss: (loss, pairs, labels)
      embed_loss = embed_loss[0]
    return embed_loss, {'embed_loss': embed_loss}

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str):
    loss, train_outputs = self.model_train_fn(state, features, labels,
                                              inference_outputs, mode)
    return {'loss': loss, **train_outputs}

  def add_summaries(self, features, labels, inference_outputs, mode: str):
    """Heatmaps, keypoints and distance histograms: ``{'images': {...},
    'histograms': {...}}`` of numpy arrays."""
    del labels, mode
    from tensor2robot_tpu_torch.research.grasp2vec import visualization

    raw = visualization.grasp2vec_summaries(features, inference_outputs)
    return {'images': {k: v for k, v in raw.items()
                       if not k.startswith('hist/')},
            'histograms': {k[len('hist/'):]: v for k, v in raw.items()
                           if k.startswith('hist/')}}
