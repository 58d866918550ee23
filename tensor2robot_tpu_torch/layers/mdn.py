"""Mixture density networks (the JAX package's ``layers/mdn.py``).

A diagonal Gaussian mixture is a ``MixtureParams`` of tensors (logits,
means, scales) and pure functions of it: its log density, its approximate
mode and a sample. ``MDNParamsLayer`` is the linear head that predicts the
flat parameters, with flax's names (``mdn_params``, and
``mdn_stddev_inputs`` for the unconditioned scales); ``MDNDecoder`` wraps
it and returns (the mode, the mixture); ``mdn_loss`` is the mean negative
log likelihood.

Where JAX's sample draws from a ``jax.random`` key, the port's draws from a
``torch.Generator``, or takes the draws given (``component=``,
``noise=``), so that a test can feed JAX's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.basic import Dense

__all__ = ['MDNDecoder', 'MDNParamsLayer', 'MixtureParams',
           'gaussian_mixture_approximate_mode', 'get_mixture_distribution',
           'mdn_loss', 'mixture_log_prob', 'mixture_sample']

# softplus(log(e - 1)) = 1: the unconditioned scales' initial value.
STDDEV_INIT = float(np.log(np.e - 1.0))


class MixtureParams(NamedTuple):
  """alphas [..., K] logits, mus [..., K, D] means, sigmas [..., K, D]
  positive scales."""
  alphas: torch.Tensor
  mus: torch.Tensor
  sigmas: torch.Tensor


def get_mixture_distribution(params: torch.Tensor, num_alphas: int,
                             sample_size: int,
                             output_mean: Optional[torch.Tensor] = None
                             ) -> MixtureParams:
  """[..., K + 2 K D] flat params -> the mixture: the logits, the means
  (plus ``output_mean``) and the softplus of the raw scales."""
  num_mus = num_alphas * sample_size
  if params.shape[-1] != num_alphas + 2 * num_mus:
    raise ValueError('Params has unexpected trailing dim {} (want {}).'
                     .format(params.shape[-1], num_alphas + 2 * num_mus))
  batch_shape = tuple(params.shape[:-1])
  alphas = params[..., :num_alphas]
  mus = params[..., num_alphas:num_alphas + num_mus].reshape(
      batch_shape + (num_alphas, sample_size))
  raw_sigmas = params[..., num_alphas + num_mus:].reshape(
      batch_shape + (num_alphas, sample_size))
  if output_mean is not None:
    mus = mus + torch.as_tensor(output_mean, dtype=mus.dtype,
                                device=mus.device)
  return MixtureParams(alphas=alphas, mus=mus, sigmas=F.softplus(raw_sigmas))


def mixture_log_prob(gm: MixtureParams, value: torch.Tensor) -> torch.Tensor:
  """log p(value) under the mixture: [..., D] -> [...]."""
  log_alphas = F.log_softmax(gm.alphas, -1)
  diff = (value[..., None, :] - gm.mus) / gm.sigmas
  log_det = torch.log(gm.sigmas).sum(-1)
  d = gm.mus.shape[-1]
  component = (-0.5 * (diff * diff).sum(-1) - log_det -
               0.5 * d * math.log(2.0 * math.pi))
  return torch.logsumexp(log_alphas + component, -1)


def _take_component(values: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
  """values [..., K, D] at the component index [...] -> [..., D]."""
  index = index[..., None, None].expand(tuple(index.shape) +
                                        (1, values.shape[-1]))
  return values.gather(-2, index).squeeze(-2)


def gaussian_mixture_approximate_mode(gm: MixtureParams) -> torch.Tensor:
  """The mean of the most probable component (the first of equals, as
  ``jnp.argmax`` picks it)."""
  return _take_component(gm.mus, gm.alphas.argmax(-1))


def mixture_sample(gm: MixtureParams,
                   generator: Optional[torch.Generator] = None,
                   component: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
  """One sample: a component by its logits (Gumbel max), then its normal.
  ``component`` [...] and ``noise`` [..., D] replace the draws."""
  if component is None:
    u = torch.rand(gm.alphas.shape, generator=generator,
                   device=gm.alphas.device, dtype=gm.alphas.dtype)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    component = (gm.alphas - torch.log(-torch.log(u))).argmax(-1)
  mu = _take_component(gm.mus, torch.as_tensor(component).to(
      gm.mus.device).long())
  sigma = _take_component(gm.sigmas, torch.as_tensor(component).to(
      gm.mus.device).long())
  if noise is None:
    noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                        dtype=mu.dtype)
  return mu + sigma * torch.as_tensor(noise, dtype=mu.dtype).to(mu.device)


class MDNParamsLayer(nn.Module):
  """A linear head of the mixture's flat params. Without
  ``condition_sigmas`` the scales are free parameters
  (``mdn_stddev_inputs``, softplus 1 at init) broadcast over the batch."""

  def __init__(self, in_features: int, num_alphas: int, sample_size: int,
               condition_sigmas: bool = False):
    super().__init__()
    num_mus = num_alphas * sample_size
    num_outputs = num_alphas + num_mus
    if condition_sigmas:
      num_outputs += num_mus
    self.num_mus = num_mus
    self.condition_sigmas = condition_sigmas
    self.mdn_params = Dense(in_features, num_outputs)
    if not condition_sigmas:
      self.mdn_stddev_inputs = nn.Parameter(
          torch.full((num_mus,), STDDEV_INIT))

  def flax_init(self, generator: torch.Generator) -> None:
    if not self.condition_sigmas:
      nn.init.constant_(self.mdn_stddev_inputs, STDDEV_INIT)

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    dist_params = self.mdn_params(inputs)
    if not self.condition_sigmas:
      tiled = self.mdn_stddev_inputs.to(dist_params.dtype).expand(
          tuple(dist_params.shape[:-1]) + (self.num_mus,))
      dist_params = torch.cat([dist_params, tiled], -1)
    return dist_params


class MDNDecoder(nn.Module):
  """``forward(params_input) -> (the mixture's mode, the mixture)``."""

  def __init__(self, in_features: int, num_mixture_components: int = 1,
               output_size: int = 1, condition_sigmas: bool = False):
    super().__init__()
    self.num_mixture_components = num_mixture_components
    self.output_size = output_size
    self.MDNParamsLayer_0 = MDNParamsLayer(
        in_features, num_mixture_components, output_size, condition_sigmas)

  def forward(self, params_input: torch.Tensor):
    dist_params = self.MDNParamsLayer_0(params_input)
    gm = get_mixture_distribution(dist_params.to(torch.float32),
                                  self.num_mixture_components,
                                  self.output_size)
    return gaussian_mixture_approximate_mode(gm), gm


def mdn_loss(gm: MixtureParams, target: torch.Tensor) -> torch.Tensor:
  """The mean negative log likelihood over the batch and sequence dims."""
  return -mixture_log_prob(gm, target).mean()
