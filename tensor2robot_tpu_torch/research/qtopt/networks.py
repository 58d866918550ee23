"""The QT-Opt Grasping44 Q-network, in PyTorch.

The counterpart of the JAX package's ``research/qtopt/networks.py``
``Grasping44Network``, with the same layers, names and arithmetic:

  conv1_1 64x6x6/2 (+bias) -> pool 3x3/3 -> bn1(no scale) relu
  conv2..7 64x5x5 SAME (+bn relu) -> pool 3x3/3                  = pool2
  grasp params: per-block Dense 256 summed -> bngrasp(no scale) relu
                -> fcgrasp2 Dense 64 (+bn relu) -> added as [*,1,1,64]
  conv8..13 64x3x3 SAME (+bn relu) -> pool 2x2/2
  conv14..16 64x3x3 VALID (+bn relu)                            = final_conv
  flatten (H, W, C order) -> fc0, fc1 Dense 64 (+bn relu) -> logit

Public tensors are NHWC, as in the JAX package. Inside, activations are
NCHW views of NHWC memory (``channels_last``): ``x.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is one, the convolutions keep that layout, and
``x.permute(0, 2, 3, 1)`` of their output is a contiguous NHWC tensor again,
which the pool kernel takes without a copy. The three pools go through
``layers.pooling.max_pool``, the port's kernels K2f and, in training, K2b.

Batch norm computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` as
flax does. In eval mode mean and var are the running statistics. With
``train=True`` they are the batch's, in float32, ``mean = E[x]`` and
``var = max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), and the running
statistics are updated in place as ``momentum * ra + (1 - momentum) *
batch`` with the biased variance (so torch's own batch norm, whose momentum
is the complement and whose running variance is unbiased, is not used).
bn1 normalizes the pooled map. In training its statistics are those of the
pre-pool map and its variance is not clipped, as the JAX network's
``_PrePoolStatsBatchNorm`` computes them; the stem conv's bias reaches the
loss through that batch norm only, so in training it is applied without a
gradient, as the JAX network applies it through ``stop_gradient``.

The 5x5 stride-1 SAME body convs (conv2..conv7) take their weight gradient
from kernel K3 (``layers.wgrad``); their forward and input gradient stay
with the library (cuDNN on the card), as XLA computes them in the JAX
package. The network's other convs sum their weight gradients in float64
(``_ConvFloat64WeightGrad``), on the card and on the CPU alike.
``l2_regularization_loss`` is the weight decay of the conv and dense
weights.

With ``grasp_params`` of rank 3, ``[B, A, d]`` (the CEM megabatch), the
image tower runs once per state and its output is repeated A times; the
network can also be driven in two halves, ``image_tower`` and ``head``, so
that a caller scoring several candidate sets against one image runs the
tower once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.layers import wgrad

__all__ = ['E2E_GRASP_PARAM_KEYS', 'E2E_GRASP_PARAM_NAMES',
           'Grasping44Network', 'final_spatial_size', 'l2_regularization_loss',
           'same_padding']

# name -> (offset, size) into the concatenated grasp params vector.
E2E_GRASP_PARAM_NAMES = {
    'fcgrasp_wv': (0, 3),
    'fcgrasp_vr': (3, 2),
    'fcgrasp_gripper_close': (5, 1),
    'fcgrasp_gripper_open': (6, 1),
    'fcgrasp_terminate_episode': (7, 1),
    'fcgrasp_gripper_closed': (8, 1),
    'fcgrasp_height_to_bottom': (9, 1),
}

# Concatenation order of the action features.
E2E_GRASP_PARAM_KEYS = (
    'world_vector', 'vertical_rotation', 'close_gripper', 'open_gripper',
    'terminate_episode', 'gripper_closed', 'height_to_bottom')


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """TF-style SAME padding (lo, hi) of one dim; lo is total // 2."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class _Conv5x5Same(torch.autograd.Function):
  """A 5x5 stride-1 SAME conv without bias whose weight gradient is K3.

  Forward and input gradient are the library's; the weight gradient is
  ``wgrad.conv5x5_wgrad`` on the NHWC views of x and dy (each made
  channels_last first where it is not), HWIO permuted to OIHW.
  """

  @staticmethod
  def forward(ctx, x, weight):
    ctx.save_for_backward(x, weight)
    return F.conv2d(x, weight, None, 1, 2)

  @staticmethod
  def backward(ctx, dy):
    x, weight = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, 1, 2)
    if ctx.needs_input_grad[1]:
      nhwc = [t.contiguous(memory_format=torch.channels_last).permute(
          0, 2, 3, 1) for t in (x, dy)]
      dw = wgrad.conv5x5_wgrad(*nhwc).permute(3, 2, 0, 1)
      dw = dw.to(weight.dtype).contiguous(memory_format=torch.channels_last)
    return dx, dw


class _ConvFloat64WeightGrad(torch.autograd.Function):
  """A convolution whose weight gradient is summed in float64.

  Forward and input gradient are the library's in the inputs' type. The
  weight gradient sums every position of the batch: at the stem, 1.78M
  products a weight at batch 32, of pixels in [0, 1] that do not cancel
  the way the gradient does, so two float32 summation orders of it (the
  card's and the CPU's, or two of cuDNN's algorithms) differ by more than
  1e-4 of the network's largest gradient. Summed in float64 (cuDNN's
  float64 algorithms on the card), every order gives the same float32
  result within that.
  """

  @staticmethod
  def forward(ctx, x, weight, bias, stride, padding):
    ctx.save_for_backward(x, weight)
    ctx.stride, ctx.padding = stride, padding
    return F.conv2d(x, weight, bias, stride, padding)

  @staticmethod
  def backward(ctx, dy):
    x, weight = ctx.saved_tensors
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
      dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, ctx.stride,
                                      ctx.padding)
    if ctx.needs_input_grad[1]:
      dw = torch.nn.grad.conv2d_weight(
          x.to(torch.float64), weight.shape, dy.to(torch.float64),
          ctx.stride, ctx.padding).to(weight.dtype)
    if ctx.needs_input_grad[2]:
      db = dy.sum((0, 2, 3))
    return dx, dw, db, None, None


class Conv(nn.Module):
  """A square convolution with TF-style SAME or VALID padding.

  ``weight`` is OIHW (a flax HWIO kernel transposed by ``(3, 2, 0, 1)``).
  SAME pads with zeros through the convolution's own symmetric padding
  where the low and high pads agree, and through an explicit ``F.pad``
  where they differ. A 5x5 stride-1 SAME conv without bias goes through
  ``_Conv5x5Same`` (weight gradient K3), in training and in eval alike;
  with ``float64_weight_grad`` the others go through
  ``_ConvFloat64WeightGrad``. ``stop_bias_gradient`` applies the bias
  without a gradient.
  """

  def __init__(self, in_features: int, features: int, kernel: int,
               stride: int = 1, padding: str = 'SAME', bias: bool = False,
               float64_weight_grad: bool = False):
    super().__init__()
    self.kernel, self.stride, self.padding = kernel, stride, padding
    self._conv2d = (_ConvFloat64WeightGrad.apply if float64_weight_grad
                    else F.conv2d)
    self.weight = nn.Parameter(torch.empty(features, in_features, kernel,
                                           kernel))
    self.bias = nn.Parameter(torch.empty(features)) if bias else None

  def forward(self, x: torch.Tensor,
              stop_bias_gradient: bool = False) -> torch.Tensor:
    weight = self.weight.to(x.dtype)
    bias = None if self.bias is None else self.bias.to(x.dtype)
    if bias is not None and stop_bias_gradient:
      bias = bias.detach()
    if (self.kernel == 5 and self.stride == 1 and self.padding == 'SAME' and
        bias is None):
      return _Conv5x5Same.apply(x, weight)
    if self.padding == 'VALID':
      return self._conv2d(x, weight, bias, self.stride, 0)
    ph = same_padding(x.shape[2], self.kernel, self.stride)
    pw = same_padding(x.shape[3], self.kernel, self.stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
      return self._conv2d(x, weight, bias, self.stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    x = x.contiguous(memory_format=torch.channels_last)
    return self._conv2d(x, weight, bias, self.stride, 0)


class Dense(nn.Module):
  """``x @ weight.T + bias``; ``weight`` is a flax [in, out] kernel
  transposed."""

  def __init__(self, in_features: int, features: int, bias: bool = True):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(features, in_features))
    self.bias = nn.Parameter(torch.empty(features)) if bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    bias = None if self.bias is None else self.bias.to(x.dtype)
    return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
  """flax's batch norm over the channel dim (1 for NCHW, -1 for a dense
  [N, C]); see the module docstring for the train-mode statistics."""

  def __init__(self, features: int, scale: bool = True,
               epsilon: float = 0.001, momentum: float = 0.9997):
    super().__init__()
    self.epsilon = epsilon
    self.momentum = momentum
    self.scale = nn.Parameter(torch.ones(features)) if scale else None
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer('mean', torch.zeros(features))
    self.register_buffer('var', torch.ones(features))

  def batch_statistics(self, x: torch.Tensor, clip: bool = True):
    """(mean, var) of ``x`` over all but the channel dim, in float32, and
    the running statistics updated with them."""
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    xf = x.to(torch.float32)
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    if clip:
      var = torch.clamp(var, min=0.0)
    with torch.no_grad():
      m = self.momentum
      self.mean.copy_(m * self.mean + (1.0 - m) * mean)
      self.var.copy_(m * self.var + (1.0 - m) * var)
    return mean, var

  def normalize(self, x: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor) -> torch.Tensor:
    shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
    dtype = x.dtype
    mul = torch.rsqrt(var.to(dtype) + self.epsilon)
    if self.scale is not None:
      mul = mul * self.scale.to(dtype)
    return ((x - mean.to(dtype).view(shape)) * mul.view(shape) +
            self.bias.to(dtype).view(shape))

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    mean, var = (self.batch_statistics(x) if train
                 else (self.mean, self.var))
    return self.normalize(x, mean, var)


class PrePoolStatsBatchNorm(BatchNorm):
  """bn1: no scale; in training, the statistics of the pre-pool map
  (variance not clipped) normalize the pooled map. Normalize-then-relu is
  non-decreasing per channel, so it commutes with the max pool."""

  def __init__(self, features: int, epsilon: float = 0.001,
               momentum: float = 0.9997):
    super().__init__(features, scale=False, epsilon=epsilon,
                     momentum=momentum)

  def forward(self, pre_pool: torch.Tensor, pooled: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    mean, var = (self.batch_statistics(pre_pool, clip=False) if train
                 else (self.mean, self.var))
    return self.normalize(pooled, mean, var)


def _pool(x: torch.Tensor, window: int) -> torch.Tensor:
  """SAME max pool of a channels_last NCHW map through kernel K2f (and
  K2b for its gradient)."""
  pooled = pooling.max_pool(x.permute(0, 2, 3, 1), (window, window),
                            (window, window), 'SAME')
  return pooled.permute(0, 3, 1, 2)


class Grasping44Network(nn.Module):
  """The Grasping44 Q-network.

  Args mirror the JAX module's: ``num_classes``, ``num_convs`` (the three
  conv stacks), ``hid_layers``, ``batch_norm_decay``, ``batch_norm_epsilon``,
  ``grasp_param_names`` (None: one ``fcgrasp`` dense over all params),
  ``softmax`` and ``dtype`` (activations; the logit head is float32).
  ``grasp_param_size`` and ``image_size`` (the side of the square input
  image) fix the widths of fcgrasp and fc0, which flax infers at init.
  ``space_to_depth`` and ``conv_variant='nchw'`` are
  layout options of the TPU compiler and raise NotImplementedError.
  """

  def __init__(self,
               num_classes: int = 1,
               num_convs: Sequence[int] = (6, 6, 3),
               hid_layers: int = 2,
               batch_norm_decay: float = 0.9997,
               batch_norm_epsilon: float = 0.001,
               grasp_param_names: Optional[Dict[str, Tuple[int, int]]] = None,
               grasp_param_size: int = 10,
               softmax: bool = False,
               dtype: torch.dtype = torch.float32,
               space_to_depth: bool = False,
               conv_variant: str = 'nhwc',
               image_size: int = 472):
    super().__init__()
    if space_to_depth:
      raise NotImplementedError('space_to_depth is a TPU layout rewrite of '
                                'the stem conv; the port does not take it.')
    if conv_variant != 'nhwc':
      raise NotImplementedError('conv_variant={!r} is a TPU layout option; '
                                'the port computes NHWC only.'.format(
                                    conv_variant))
    self.num_classes = num_classes
    self.num_convs = tuple(num_convs)
    self.hid_layers = hid_layers
    self.softmax = softmax
    self.dtype = dtype
    eps, decay = batch_norm_epsilon, batch_norm_decay

    def conv_bn(layer, kernel, padding):
      self.add_module('conv{}'.format(layer), Conv(
          64, 64, kernel, 1, padding, float64_weight_grad=True))
      self.add_module('bn{}'.format(layer), BatchNorm(64, True, eps, decay))

    self.conv1_1 = Conv(3, 64, 6, 2, 'SAME', bias=True,
                        float64_weight_grad=True)
    self.bn1 = PrePoolStatsBatchNorm(64, eps, decay)
    layer = 2
    self._stacks = []
    for kernel, padding, count in ((5, 'SAME', self.num_convs[0]),
                                   (3, 'SAME', self.num_convs[1]),
                                   (3, 'VALID', self.num_convs[2])):
      stack = []
      for _ in range(count):
        conv_bn(layer, kernel, padding)
        stack.append(layer)
        layer += 1
      self._stacks.append(tuple(stack))

    if grasp_param_names is None:
      self._blocks = (('fcgrasp', 0, grasp_param_size),)
    else:
      # Sorted, as the JAX module creates (and sums) them.
      self._blocks = tuple((name, offset, size) for name, (offset, size)
                           in sorted(grasp_param_names.items()))
    for name, _, size in self._blocks:
      self.add_module(name, Dense(size, 256))
    self.bngrasp = BatchNorm(256, False, eps, decay)
    self.fcgrasp2 = Dense(256, 64, bias=False)
    self.bngrasp2 = BatchNorm(64, True, eps, decay)

    side = final_spatial_size(image_size, self.num_convs)
    if side < 1:
      raise ValueError('A {0}x{0} image leaves no final_conv map for '
                       'num_convs {1}.'.format(image_size, self.num_convs))
    width = 64 * side * side
    for l in range(hid_layers):
      self.add_module('fc{}'.format(l), Dense(width, 64, bias=False))
      self.add_module('bnfc{}'.format(l), BatchNorm(64, True, eps, decay))
      width = 64
    self.logit_name = ('logit' if num_classes == 1 else
                       'logit_{}'.format(num_classes))
    self.add_module(self.logit_name, Dense(width, num_classes))

  def _conv_stack(self, x: torch.Tensor, stack, train: bool) -> torch.Tensor:
    for layer in stack:
      x = getattr(self, 'conv{}'.format(layer))(x)
      x = F.relu(getattr(self, 'bn{}'.format(layer))(x, train))
    return x

  def image_tower(self, image: torch.Tensor,
                  train: bool = False) -> torch.Tensor:
    """[B, H, W, 3] NHWC image -> pool2, [B, h, w, 64] NHWC."""
    x = image.to(self.dtype)
    if not x.is_contiguous():
      x = x.contiguous()
    x = self.conv1_1(x.permute(0, 3, 1, 2), stop_bias_gradient=train)
    x = F.relu(self.bn1(x, _pool(x, 3), train))
    x = self._conv_stack(x, self._stacks[0], train)
    return _pool(x, 3).permute(0, 2, 3, 1)

  def head(self, pool2: torch.Tensor, grasp_params: torch.Tensor,
           train: bool = False) -> Dict[str, torch.Tensor]:
    """Scores grasp params against a tower output.

    ``pool2`` is [B, h, w, 64] NHWC; ``grasp_params`` is [B, d], or
    [B, A, d] to score A candidates per state. Returns the endpoints
    ``logits``, ``predictions`` (shaped [B, A] in megabatch mode),
    ``final_conv`` (NHWC) and ``fcgrasp``.
    """
    endpoints = {}
    tile_batch = grasp_params.dim() == 3
    action_batch = grasp_params.shape[1] if tile_batch else 1
    grasp_params = grasp_params.reshape(-1, grasp_params.shape[-1])
    grasp_params = grasp_params.to(self.dtype)
    fcgrasp = None
    for name, offset, size in self._blocks:
      y = getattr(self, name)(grasp_params[:, offset:offset + size])
      fcgrasp = y if fcgrasp is None else fcgrasp + y
    fcgrasp = F.relu(self.bngrasp(fcgrasp, train))
    fcgrasp = F.relu(self.bngrasp2(self.fcgrasp2(fcgrasp), train))
    endpoints['fcgrasp'] = fcgrasp

    net = pool2.to(self.dtype)
    if tile_batch:
      # Each state's block of A candidates stays contiguous.
      net = net.repeat_interleave(action_batch, dim=0)
    net = (net + fcgrasp[:, None, None, :]).permute(0, 3, 1, 2)
    net = self._conv_stack(net, self._stacks[1], train)
    net = self._conv_stack(_pool(net, 2), self._stacks[2], train)
    final_conv = net.permute(0, 2, 3, 1)
    endpoints['final_conv'] = final_conv

    # H, W, C order, as the JAX network flattens its NHWC map.
    net = final_conv.reshape(final_conv.shape[0], -1)
    for l in range(self.hid_layers):
      net = getattr(self, 'fc{}'.format(l))(net)
      net = F.relu(getattr(self, 'bnfc{}'.format(l))(net, train))
    logits = getattr(self, self.logit_name)(net.to(torch.float32))
    predictions = (torch.softmax(logits, -1) if self.softmax
                   else torch.sigmoid(logits))
    if tile_batch:
      shape = ((-1, action_batch) if self.num_classes == 1 else
               (-1, action_batch, self.num_classes))
      predictions = predictions.reshape(shape)
      logits = logits.reshape(shape)
    elif self.num_classes == 1:
      predictions = predictions.squeeze(-1)
    endpoints['logits'] = logits
    endpoints['predictions'] = predictions
    return endpoints

  def forward(self, image: Optional[torch.Tensor],
              grasp_params: Optional[torch.Tensor] = None,
              pool2: Optional[torch.Tensor] = None,
              train: bool = False) -> Dict[str, torch.Tensor]:
    """The endpoints of ``head`` plus ``pool2``.

    ``pool2``, when given, is the tower's output for this image computed
    earlier, and the tower is skipped; without ``grasp_params`` only the
    tower runs. Both halves go through ``forward`` so that
    ``torch.func.functional_call`` can run either on a given state dict.
    ``train`` normalizes with batch statistics and updates the running
    ones in the batch norm buffers it is given.
    """
    if pool2 is None:
      pool2 = self.image_tower(image, train)
    endpoints = ({} if grasp_params is None else
                 self.head(pool2, grasp_params, train))
    endpoints['pool2'] = pool2
    return endpoints


def final_spatial_size(image_size: int, num_convs: Sequence[int]) -> int:
  """Side of final_conv for a square input of ``image_size``."""
  size = -(-image_size // 2)        # conv1_1 6x6/2 SAME
  size = -(-size // 3)              # pool 3/3 SAME
  size = -(-size // 3)              # pool 3/3 SAME
  size = -(-size // 2)              # pool 2/2 SAME
  return size - 2 * num_convs[2]    # 3x3 VALID convs


def l2_regularization_loss(state: Dict[str, torch.Tensor],
                           scale: float) -> torch.Tensor:
  """``scale * sum ||W||^2 / 2`` over the conv and dense weights of a state
  dict (flax's ``kernel`` leaves); never biases or batch norm parameters."""
  total = sum(value.to(torch.float32).square().sum()
              for name, value in state.items() if name.endswith('.weight'))
  return scale * 0.5 * total
