"""Vision towers: images -> keypoint features -> pose heads, with FiLM (the
JAX package's ``layers/vision_layers.py``).

  * ``ImagesToFeaturesNet``: VALID convs (``conv2``.. with bias), each
    normalized (flax's LayerNorm over the channels, without a scale, or
    flax's batch norm), FiLM-modulated where given, relu; a 1x1
    ``final_conv_1x1`` and ``final_norm`` (with a scale); then the spatial
    softmax's expected keypoints.
  * ``ImagesToFeaturesHighResNet``: the multi-resolution tower: a 2x2
    average pool, a stride-2 conv, then blocks joined by 2x2 VALID max
    pools (``layers.pooling.max_pool``: kernels K2f and K2b on the card),
    each block's 1x1 tap resized (nearest) to the first tap's size and
    summed before the spatial softmax.
  * ``FilmParams`` (a dense ``film``), ``split_film_params`` and
    ``ImageFeaturesToPoseNet`` (a learned bias transform concatenated to
    the features, then ``Dense_i`` / ``LayerNorm_i`` / relu layers and a
    ``Dense_n`` head, flax's automatic names).

Public tensors are NHWC; the convs run on NCHW views of channels_last
memory, and each norm on the NHWC view.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import initializers
from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.layers.basic import BatchNorm, Dense
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.layers.transformer import LayerNorm
from tensor2robot_tpu_torch.research.qtopt.networks import Conv

__all__ = ['FilmParams', 'ImageFeaturesToPoseNet', 'ImagesToFeaturesNet',
           'ImagesToFeaturesHighResNet', 'split_film_params']

_CHANNELS_PER_BLOCK = 32


def split_film_params(film_output_params: torch.Tensor, num_blocks: int
                      ) -> Tuple[list, list]:
  """[batch, 2 num_blocks C] -> (the blocks' 1 + gamma, their beta), each
  [batch, 1, 1, C]."""
  expected = 2 * num_blocks * _CHANNELS_PER_BLOCK
  if film_output_params.dim() != 2 or film_output_params.shape[-1] != (
      expected):
    raise ValueError('FiLM params must be [batch, {}]; got {}.'.format(
        expected, tuple(film_output_params.shape)))
  chunks = film_output_params[:, None, None, :].chunk(2 * num_blocks, -1)
  return [1.0 + g for g in chunks[:num_blocks]], list(chunks[num_blocks:])


def _nhwc(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _make_norm(features: int, scale: bool, batch_norm: bool) -> nn.Module:
  """flax's batch norm (momentum 0.99, epsilon 1e-4) or LayerNorm over the
  channels (epsilon 1e-6)."""
  if batch_norm:
    return BatchNorm(features, scale=scale, epsilon=1e-4, momentum=0.99)
  return LayerNorm(features, use_scale=scale)


def _normalize(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
  """``norm`` of an NCHW map: the batch norm over its channel dim, the
  layer norm over the channels of its NHWC view."""
  if isinstance(norm, BatchNorm):
    return norm(x, train)
  return _nchw(norm(_nhwc(x)).to(x.dtype))


class ImagesToFeaturesNet(nn.Module):
  """Conv tower + spatial softmax: ``forward(images [B, H, W, 3],
  film_output_params=None, train=False) -> (points [B, 2
  num_output_maps], {'softmax': maps})``."""

  def __init__(self, filter_size: int = 3, num_blocks: int = 5,
               num_output_maps: int = 32, use_batch_norm: bool = False,
               stride2_blocks: Sequence[int] = (0, 1), in_channels: int = 3):
    super().__init__()
    self.num_blocks = num_blocks
    features = in_channels
    for i in range(num_blocks):
      stride = 2 if i in stride2_blocks else 1
      setattr(self, 'conv{:d}'.format(i + 2), Conv(
          features, _CHANNELS_PER_BLOCK, filter_size, stride, 'VALID',
          bias=True))
      setattr(self, 'norm{:d}'.format(i + 2),
              _make_norm(_CHANNELS_PER_BLOCK, False, use_batch_norm))
      features = _CHANNELS_PER_BLOCK
    self.final_conv_1x1 = Conv(features, num_output_maps, 1, 1, 'VALID',
                               bias=True)
    self.final_norm = _make_norm(num_output_maps, True, use_batch_norm)
    initializers.declare(
        (m for m in self.modules() if isinstance(m, Conv)),
        kernel_init=initializers.xavier_uniform,
        bias_init=initializers.constant(0.01))

  def forward(self, images: torch.Tensor,
              film_output_params: Optional[torch.Tensor] = None,
              train: bool = False):
    gammas = betas = None
    if film_output_params is not None:
      gammas, betas = split_film_params(film_output_params, self.num_blocks)
    net = _nchw(images)
    for i in range(self.num_blocks):
      net = getattr(self, 'conv{:d}'.format(i + 2))(net)
      net = _normalize(getattr(self, 'norm{:d}'.format(i + 2)), net, train)
      if gammas is not None:
        net = _nchw(gammas[i] * _nhwc(net) + betas[i])
      net = F.relu(net)
    net = self.final_conv_1x1(net)
    net = F.relu(_normalize(self.final_norm, net, train))
    expected_points, softmax_maps = spatial_softmax(_nhwc(net))
    return expected_points, {'softmax': softmax_maps}


def _resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
  """``jax.image.resize(method='nearest')`` of an NCHW map: half-pixel
  centers, output pixel i reads input floor((i + 0.5) in / out)."""
  return F.interpolate(x, size=tuple(size), mode='nearest-exact')


class ImagesToFeaturesHighResNet(nn.Module):
  """The multi-resolution feature-sum tower: ``forward(images, train) ->
  (points, {'softmax': maps})``; its 2x2 VALID max pools are K2f (and K2b
  in training) on the card."""

  def __init__(self, filter_size: int = 3, num_blocks: int = 5,
               num_output_maps: int = 32, use_batch_norm: bool = True,
               in_channels: int = 3):
    super().__init__()
    self.num_blocks = num_blocks
    self.conv1 = Conv(in_channels, 16, filter_size, 2, 'VALID', bias=True)
    self.norm1 = _make_norm(16, False, use_batch_norm)
    self.conv2 = Conv(16, 32, filter_size, 1, 'VALID', bias=True)
    self.norm2 = _make_norm(32, False, use_batch_norm)
    self.conv2_1x1 = Conv(32, 32, 1, 1, 'VALID', bias=True)
    self.norm2_1x1 = _make_norm(32, False, use_batch_norm)
    for i in range(1, num_blocks):
      setattr(self, 'conv{:d}'.format(i + 2),
              Conv(32, 32, filter_size, 1, 'VALID', bias=True))
      setattr(self, 'norm{:d}'.format(i + 2),
              _make_norm(32, False, use_batch_norm))
      setattr(self, 'conv{:d}_1x1'.format(i + 2),
              Conv(32, 32, 1, 1, 'VALID', bias=True))
      setattr(self, 'norm{:d}_1x1'.format(i + 2),
              _make_norm(32, False, use_batch_norm))
    self.final_conv_1x1 = Conv(32, num_output_maps, 1, 1, 'VALID', bias=True)
    self.final_norm = _make_norm(num_output_maps, True, use_batch_norm)
    initializers.declare(
        (m for m in self.modules() if isinstance(m, Conv)),
        kernel_init=initializers.truncated_normal(0.1))

  def _norm_relu(self, name, x, train):
    return F.relu(_normalize(getattr(self, name), x, train))

  def forward(self, images: torch.Tensor, train: bool = False):
    net = F.avg_pool2d(_nchw(images), 2, 2)
    net = self._norm_relu('norm1', self.conv1(net), train)
    net = self._norm_relu('norm2', self.conv2(net), train)
    taps = [self._norm_relu('norm2_1x1', self.conv2_1x1(net), train)]
    for i in range(1, self.num_blocks):
      net = _nchw(pooling.max_pool(_nhwc(net).contiguous(), (2, 2), (2, 2),
                                   'VALID'))
      net = self._norm_relu('norm{:d}'.format(i + 2),
                            getattr(self, 'conv{:d}'.format(i + 2))(net),
                            train)
      tap = getattr(self, 'conv{:d}_1x1'.format(i + 2))(net)
      taps.append(self._norm_relu('norm{:d}_1x1'.format(i + 2), tap, train))
    target = taps[0].shape[2:]
    net = sum(_resize_nearest(tap, target) for tap in taps)
    net = self._norm_relu('final_norm', self.final_conv_1x1(
        net.contiguous(memory_format=torch.channels_last)), train)
    expected_points, softmax_maps = spatial_softmax(_nhwc(net))
    return expected_points, {'softmax': softmax_maps}


class FilmParams(nn.Module):
  """A linear FiLM generator: one dense ``film``."""

  def __init__(self, embedding_size: int,
               film_output_size: int = 2 * 5 * _CHANNELS_PER_BLOCK):
    super().__init__()
    self.film = Dense(embedding_size, film_output_size)

  def forward(self, embedding: torch.Tensor) -> torch.Tensor:
    return self.film(embedding)


class ImageFeaturesToPoseNet(nn.Module):
  """Feature points (and an aux input) -> a pose: ``forward(points,
  aux_input=None)``; with ``aux_output_dim`` also the aux prediction, and
  with ``num_outputs`` None the last hidden layer. ``input_size`` is the
  width of the points and the aux input together (flax infers it)."""

  def __init__(self, input_size: int, num_outputs: Optional[int] = 7,
               fc_layers: Sequence[int] = (100, 100),
               bias_transform_size: int = 10, aux_output_dim: int = 0):
    super().__init__()
    self.fc_layers = tuple(fc_layers)
    self.num_outputs = num_outputs
    self.bias_transform_size = bias_transform_size
    self.aux_output_dim = aux_output_dim
    if bias_transform_size:
      self.bias_transform = nn.Parameter(torch.zeros(bias_transform_size))
    width = input_size + bias_transform_size
    for i, hidden in enumerate(self.fc_layers):
      setattr(self, 'Dense_{}'.format(i), Dense(width, hidden))
      setattr(self, 'LayerNorm_{}'.format(i), LayerNorm(hidden))
      width = hidden
    if num_outputs is not None:
      setattr(self, 'Dense_{}'.format(len(self.fc_layers)),
              Dense(width, num_outputs))
    if aux_output_dim:
      self.aux_dense = Dense(width, aux_output_dim)

  def forward(self, feature_points: torch.Tensor,
              aux_input: Optional[torch.Tensor] = None):
    net = feature_points
    if aux_input is not None:
      net = torch.cat([net, aux_input.to(net.dtype)], -1)
    if self.bias_transform_size:
      bias = self.bias_transform.to(net.dtype).expand(
          net.shape[:-1] + (self.bias_transform_size,))
      net = torch.cat([net, bias], -1)
    for i in range(len(self.fc_layers)):
      net = getattr(self, 'Dense_{}'.format(i))(net)
      net = F.relu(getattr(self, 'LayerNorm_{}'.format(i))(net).to(
          net.dtype))
    output = net if self.num_outputs is None else getattr(
        self, 'Dense_{}'.format(len(self.fc_layers)))(net)
    if self.aux_output_dim:
      return output, self.aux_dense(net)
    return output
