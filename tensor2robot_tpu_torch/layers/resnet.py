"""ResNet v2 with per-block FiLM conditioning and endpoint taps.

The counterpart of the JAX package's ``layers/resnet.py``: ``ResNet`` with
``ResidualBlock`` (v2, 3x3 + 3x3) or ``BottleneckBlock`` (v2, 1x1, 3x3,
1x1 with 4x expansion) by ``resnet_size``, ``apply_film``,
``LinearFilmGenerator``, ``resnet_model`` and ``get_block_sizes``. Module
and parameter names are flax's (``initial_conv``, ``block_layer{i}_{j}``
with ``preact_bn``, ``proj_conv``, ``conv1``..``conv3``, ``bn1``,
``bn2``; ``final_bn``, ``final_dense``), so ``convert.from_flax`` maps a
JAX ResNet leaf for leaf.

Public tensors are NHWC, as in the JAX package; inside, activations are
NCHW views of NHWC memory (``channels_last``), as in the QT-Opt critic.
flax's ``padding='SAME'`` is TF's: at stride 2 on an even size it pads
(lo, hi) = (k // 2 - 1, k // 2), so the 7x7/2 stem on 472 pads (2, 3) and
a 3x3/2 conv or the 3x3/2 stem pool pads (0, 1); the convs pad explicitly
where the two sides differ (``networks.Conv``), and the stem pool pads
with -inf and runs ``F.max_pool2d`` (JAX runs ``nn.max_pool`` there, no
Pallas kernel). The batch norms are flax's (``layers.basic.BatchNorm``:
momentum 0.9, epsilon 1e-5, the biased running variance).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import initializers
from tensor2robot_tpu_torch.layers.basic import BatchNorm, Dense
from tensor2robot_tpu_torch.layers.basic import same_padding
from tensor2robot_tpu_torch.research.qtopt.networks import Conv

__all__ = ['BottleneckBlock', 'LinearFilmGenerator', 'ResNet',
           'ResidualBlock', 'apply_film', 'get_block_sizes', 'resnet_model']

_BLOCK_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
}
_MOMENTUM, _EPSILON = 0.9, 1e-5


def get_block_sizes(resnet_size: int) -> Sequence[int]:
  try:
    return _BLOCK_SIZES[resnet_size]
  except KeyError:
    raise ValueError(
        'resnet_size {} not in {}'.format(resnet_size,
                                          sorted(_BLOCK_SIZES))) from None


def apply_film(activations: torch.Tensor,
               gamma_beta: Optional[torch.Tensor]) -> torch.Tensor:
  """``(1 + gamma) * h + beta`` of NHWC ``activations``; ``gamma_beta``
  is [batch, 2 C] (gamma, then beta)."""
  if gamma_beta is None:
    return activations
  gamma, beta = torch.chunk(gamma_beta, 2, dim=-1)
  gamma = (1.0 + gamma)[:, None, None, :].to(activations.dtype)
  beta = beta[:, None, None, :].to(activations.dtype)
  return gamma * activations + beta


def _film_nchw(x: torch.Tensor, gamma_beta) -> torch.Tensor:
  if gamma_beta is None:
    return x
  return apply_film(x.permute(0, 2, 3, 1), gamma_beta).permute(
      0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _norm(features: int) -> BatchNorm:
  return BatchNorm(features, epsilon=_EPSILON, momentum=_MOMENTUM)


class ResidualBlock(nn.Module):
  """v2 residual block: BN-ReLU-conv pre-activation ordering."""

  def __init__(self, in_features: int, filters: int, strides: int = 1,
               projection: bool = False):
    super().__init__()
    self.preact_bn = _norm(in_features)
    self.proj_conv = (Conv(in_features, filters, 1, strides)
                      if projection else None)
    self.conv1 = Conv(in_features, filters, 3, strides)
    self.bn1 = _norm(filters)
    self.conv2 = Conv(filters, filters, 3)

  def forward(self, x, film_gamma_beta=None, train: bool = False):
    preact = F.relu(self.preact_bn(x, train))
    shortcut = x if self.proj_conv is None else self.proj_conv(preact)
    y = F.relu(self.bn1(self.conv1(preact), train))
    y = _film_nchw(self.conv2(y), film_gamma_beta)
    return shortcut + y


class BottleneckBlock(nn.Module):
  """v2 bottleneck block (1x1 -> 3x3 -> 1x1, 4x expansion)."""

  def __init__(self, in_features: int, filters: int, strides: int = 1,
               projection: bool = False):
    super().__init__()
    self.preact_bn = _norm(in_features)
    self.proj_conv = (Conv(in_features, 4 * filters, 1, strides)
                      if projection else None)
    self.conv1 = Conv(in_features, filters, 1)
    self.bn1 = _norm(filters)
    self.conv2 = Conv(filters, filters, 3, strides)
    self.bn2 = _norm(filters)
    self.conv3 = Conv(filters, 4 * filters, 1)

  def forward(self, x, film_gamma_beta=None, train: bool = False):
    preact = F.relu(self.preact_bn(x, train))
    shortcut = x if self.proj_conv is None else self.proj_conv(preact)
    y = F.relu(self.bn1(self.conv1(preact), train))
    y = F.relu(self.bn2(self.conv2(y), train))
    y = _film_nchw(self.conv3(y), film_gamma_beta)
    return shortcut + y


def _max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
  """flax ``nn.max_pool(padding='SAME')`` of an NCHW map: -inf padding,
  (lo, hi) as TF pads."""
  ph = same_padding(x.shape[2], window, stride)
  pw = same_padding(x.shape[3], window, stride)
  x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float('-inf'))
  return F.max_pool2d(x.contiguous(memory_format=torch.channels_last),
                      window, stride)


class ResNet(nn.Module):
  """FiLM-conditionable ResNet v2.

  ``forward(images [B, H, W, 3], film_gamma_betas=None, train=False,
  include_head=None) -> (x, endpoints)``: ``film_gamma_betas`` is a list
  (per block layer) of lists (per block) of [B, 2 C] tensors or None;
  ``endpoints`` holds ``initial_conv``, ``initial_max_pool``,
  ``block_layer1``..``4``, ``pre_final_pool``, ``final_reduce_mean`` and,
  with the head, ``final_dense``, each NHWC or [B, C]. ``include_head``
  builds ``final_dense`` (flax makes it only where the call uses it).
  """

  def __init__(self, resnet_size: int = 50, num_classes: int = 1001,
               num_filters: int = 64, dtype: torch.dtype = torch.float32,
               include_head: bool = True, in_channels: int = 3):
    super().__init__()
    self.resnet_size = resnet_size
    self.dtype = dtype
    self.block_sizes = list(get_block_sizes(resnet_size))
    self.bottleneck = resnet_size >= 50
    block_cls = BottleneckBlock if self.bottleneck else ResidualBlock
    mult = 4 if self.bottleneck else 1
    self.filter_sizes = [num_filters * (2 ** i) * mult for i in range(4)]
    self.initial_conv = Conv(in_channels, num_filters, 7, 2)
    features = num_filters
    for i, (num_blocks, stride) in enumerate(zip(self.block_sizes,
                                                 (1, 2, 2, 2))):
      filters = num_filters * (2 ** i)
      for j in range(num_blocks):
        self.add_module('block_layer{}_{}'.format(i + 1, j), block_cls(
            features, filters, stride if j == 0 else 1, projection=j == 0))
        features = filters * mult
    self.final_bn = _norm(features)
    self.final_dense = (Dense(features, num_classes) if include_head
                        else None)
    # Every conv of the JAX network declares this; the head keeps flax's
    # default.
    initializers.declare(
        (m for m in self.modules() if isinstance(m, Conv)),
        kernel_init=initializers.variance_scaling(2.0, 'fan_out', 'normal'))

  def forward(self, images: torch.Tensor,
              film_gamma_betas: Optional[Sequence[Sequence]] = None,
              train: bool = False, include_head: Optional[bool] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if include_head is None:
      include_head = self.final_dense is not None
    if include_head and self.final_dense is None:
      raise ValueError('This ResNet was built without its head.')
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    endpoints: Dict[str, torch.Tensor] = {}
    x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = self.initial_conv(x)
    endpoints['initial_conv'] = nhwc(x)
    x = _max_pool_same(x, 3, 2)
    endpoints['initial_max_pool'] = nhwc(x)
    for i, num_blocks in enumerate(self.block_sizes):
      films = (film_gamma_betas[i] if film_gamma_betas is not None
               else [None] * num_blocks)
      if len(films) != num_blocks:
        raise ValueError(
            'block layer {} expects {} FiLM vectors, got {}.'.format(
                i + 1, num_blocks, len(films)))
      for j in range(num_blocks):
        x = getattr(self, 'block_layer{}_{}'.format(i + 1, j))(
            x, film_gamma_beta=films[j], train=train)
      endpoints['block_layer{}'.format(i + 1)] = nhwc(x)
    x = F.relu(self.final_bn(x, train))
    endpoints['pre_final_pool'] = nhwc(x)
    x = x.mean((2, 3))
    endpoints['final_reduce_mean'] = x
    if include_head:
      x = self.final_dense(x.to(torch.float32))
      endpoints['final_dense'] = x
    return x, endpoints


class LinearFilmGenerator(nn.Module):
  """A linear FiLM head a block layer (``film{i}``): an embedding ->
  [[B, 2 C] for each block] for each block layer, None where
  ``enabled_block_layers`` turns a layer off."""

  def __init__(self, embedding_size: int, block_sizes: Sequence[int],
               filter_sizes: Sequence[int],
               enabled_block_layers: Optional[Sequence[bool]] = None):
    super().__init__()
    if (enabled_block_layers is not None and
        len(enabled_block_layers) != len(block_sizes)):
      raise ValueError(
          'Got {} bools for enabled_block_layers, expected {}.'.format(
              len(enabled_block_layers), len(block_sizes)))
    self.block_sizes = list(block_sizes)
    self.enabled = (list(enabled_block_layers) if enabled_block_layers
                    is not None else [True] * len(block_sizes))
    for i, num_blocks in enumerate(self.block_sizes):
      if self.enabled[i]:
        self.add_module('film{}'.format(i), Dense(
            embedding_size, num_blocks * filter_sizes[i] * 2))

  def forward(self, embedding: torch.Tensor) -> List[list]:
    film_gamma_betas = []
    for i, num_blocks in enumerate(self.block_sizes):
      if not self.enabled[i]:
        film_gamma_betas.append([None] * num_blocks)
        continue
      flat = getattr(self, 'film{}'.format(i))(embedding)
      film_gamma_betas.append(list(torch.chunk(flat, num_blocks, dim=-1)))
    return film_gamma_betas


def resnet_model(images: torch.Tensor, state: Dict[str, torch.Tensor],
                 train: bool = False, num_classes: int = 1001,
                 resnet_size: int = 50,
                 film_embedding: Optional[torch.Tensor] = None,
                 film_generator=None, dtype: torch.dtype = torch.float32):
  """A ResNet on the state dict ``state`` (the JAX ``resnet_model``).
  Returns (outputs, endpoints) and, with ``train``, the updated batch
  norm buffers as a third value (``state`` is left as it was)."""
  model = ResNet(resnet_size=resnet_size, num_classes=num_classes,
                 dtype=dtype).to(images.device)
  film_gamma_betas = None
  if film_embedding is not None and film_generator is not None:
    film_gamma_betas = film_generator(film_embedding)
  buffers = {name for name, _ in model.named_buffers()}
  state = {k: v.clone() if k in buffers else v for k, v in state.items()}
  outputs, endpoints = torch.func.functional_call(
      model, state, (images,), {'film_gamma_betas': film_gamma_betas,
                                'train': train}, strict=True)
  if train:
    return outputs, endpoints, {k: state[k] for k in buffers}
  return outputs, endpoints
