"""flax's initializers, for the port's modules to declare as their JAX
counterparts do.

``models.abstract_model.init_variables`` draws each module's ``weight``
(two or more dims) with the module's ``kernel_init`` and its ``bias`` with
its ``bias_init``; a module that declares neither gets flax's defaults,
``lecun_normal`` and ``zeros``. Each initializer fills a tensor in place
from a ``torch.Generator`` (``jax.random`` gives other numbers; the
distributions are flax's). A weight's fans are flax's, from the port's
layout ``[out, in, *kernel]``: fan in ``in * prod(kernel)``, fan out
``out * prod(kernel)`` (a dense ``[in, out]`` kernel, a conv's HWIO and a
1-D conv's ``[k, in, out]`` count the same way).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
from torch import nn

__all__ = ['Initializer', 'constant', 'declare', 'lecun_normal',
           'truncated_normal', 'variance_scaling', 'xavier_uniform', 'zeros']

Initializer = Callable[[torch.Tensor, torch.Generator], None]

# variance_scaling's truncated normal draws a unit normal truncated to
# [-2, 2] and divides by its std, so that the kept draws have the requested
# variance.
_TRUNCATED_STD = 0.87962566103423978


def _fans(weight: torch.Tensor) -> Tuple[int, int]:
  """(fan in, fan out) of a port weight ``[out, in, *kernel]``."""
  receptive = math.prod(weight.shape[2:])
  return weight.shape[1] * receptive, weight.shape[0] * receptive


def variance_scaling(scale: float, mode: str,
                     distribution: str) -> Initializer:
  """``jax.nn.initializers.variance_scaling``: variance ``scale / n`` with
  ``n`` the fan in, the fan out or their mean (``mode``), drawn from a
  ``'truncated_normal'``, a ``'normal'`` or a ``'uniform'``."""

  def init(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_in, fan_out = _fans(weight)
    n = {'fan_in': fan_in, 'fan_out': fan_out,
         'fan_avg': (fan_in + fan_out) / 2.0}[mode]
    variance = scale / max(1.0, n)
    if distribution == 'truncated_normal':
      nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
      weight.mul_(math.sqrt(variance) / _TRUNCATED_STD)
    elif distribution == 'normal':
      weight.normal_(0.0, math.sqrt(variance), generator=generator)
    elif distribution == 'uniform':
      limit = math.sqrt(3.0 * variance)
      weight.uniform_(-limit, limit, generator=generator)
    else:
      raise ValueError('Unknown distribution {!r}.'.format(distribution))

  return init


# flax's default kernel initializer.
lecun_normal = variance_scaling(1.0, 'fan_in', 'truncated_normal')
xavier_uniform = variance_scaling(1.0, 'fan_avg', 'uniform')


def truncated_normal(stddev: float) -> Initializer:
  """``jax.nn.initializers.truncated_normal(stddev)``: a unit normal
  truncated to [-2, 2], times ``stddev`` (not divided by the truncation's
  std: the draws' std is 0.88 ``stddev``)."""

  def init(weight: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(stddev)

  return init


def constant(value: float) -> Initializer:
  def init(tensor: torch.Tensor, generator: torch.Generator) -> None:
    del generator
    nn.init.constant_(tensor, value)

  return init


zeros = constant(0.0)


def declare(modules, kernel_init: Initializer = None,
            bias_init: Initializer = None) -> None:
  """Sets ``kernel_init`` and ``bias_init`` (where given) on each of
  ``modules``, as a flax module passes them to its layers."""
  for module in modules:
    if kernel_init is not None:
      module.kernel_init = kernel_init
    if bias_init is not None:
      module.bias_init = bias_init
