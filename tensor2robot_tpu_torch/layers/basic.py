"""Layers that several networks of the port share: TF-style SAME padding,
flax's ``Dense``, flax's 1-D ``Conv`` over [batch, time, channels]
(``Conv1D``) and flax's batch norm.

``BatchNorm`` computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
as flax does. In eval mode mean and var are the running statistics. With
``train=True`` they are the batch's, in float32, ``mean = E[x]`` and
``var = max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), and the running
statistics are updated in place as ``momentum * ra + (1 - momentum) *
batch`` with the biased variance (so torch's own batch norm, whose
momentum is the complement and whose running variance is unbiased, is not
used). The QT-Opt critic (``research/qtopt/networks.py``) and the ResNet
(``layers/resnet.py``) both use it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['BatchNorm', 'Conv1D', 'Dense', 'same_padding']


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """TF-style SAME padding (lo, hi) of one dim; lo is total // 2."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2



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


class Conv1D(nn.Module):
  """flax's ``nn.Conv`` with one spatial dim, VALID, over [batch, time,
  channels]; ``weight`` is [out, in, k] (a flax [k, in, out] kernel
  transposed by ``(2, 1, 0)``)."""

  def __init__(self, in_features: int, features: int, kernel: int,
               dilation: int = 1, bias: bool = True):
    super().__init__()
    self.dilation = dilation
    self.weight = nn.Parameter(torch.empty(features, in_features, kernel))
    self.bias = nn.Parameter(torch.empty(features)) if bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    bias = None if self.bias is None else self.bias.to(x.dtype)
    return F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), bias,
                    dilation=self.dilation).transpose(1, 2)


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
    """(mean, var) of ``x`` over all but the channel dim, in float32 (or
    float64 for a float64 ``x``, as flax promotes), and the running
    statistics updated with them."""
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
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
