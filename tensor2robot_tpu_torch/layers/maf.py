"""Masked autoregressive flow (the JAX package's ``layers/maf.py``).

  * ``MADE``: the masked dense network of Germain et al. (2015), y ->
    (shift, log_scale) with output i a function of y_{<i} only; its masks
    come from the units' degrees (``_hidden_degrees``) and its parameters
    keep flax's names (``masked_dense_{i}_kernel`` [in, out] and
    ``masked_dense_{i}_bias``, ``masked_dense_out_*``);
  * ``MAFBijector``: ``made_0``, ``made_1``, ... with fixed permutations
    between them (seeded numpy, the last one dropped). ``forward`` (the
    sampling direction) is sequential: event_size passes a flow, each one
    fixing one more dimension; ``inverse_and_log_det`` (the density
    direction) is one pass a flow;
  * ``MAFDistribution``: N(mu, 1), mu a dense ``maf_mus`` of the
    conditioning features, pushed through the bijector; its sample (or the
    pushforward of mu) and, given a value, its log density.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers.basic import Dense

__all__ = ['MADE', 'MAFBijector', 'MAFDistribution']

# TFP's masked_autoregressive_default_template clips log_scale to this.
LOG_SCALE_MIN_CLIP = -5.0
LOG_SCALE_MAX_CLIP = 3.0


def _hidden_degrees(width: int, event_size: int) -> np.ndarray:
  """Hidden units' degrees, cycling over 1 .. event_size - 1 (or 1)."""
  return np.arange(width) % max(1, event_size - 1) + 1


class MADE(nn.Module):
  """``forward(y) -> (shift, log_scale)``, autoregressive in y."""

  def __init__(self, event_size: int,
               hidden_layers: Sequence[int] = (512, 512)):
    super().__init__()
    if any(width < event_size for width in hidden_layers):
      raise ValueError(
          'MAF hidden layers have to be at least as wide as event size.')
    self.event_size = event_size
    self._names, masks = [], []
    prev = np.arange(1, event_size + 1)
    for idx, width in enumerate(hidden_layers):
      degrees = _hidden_degrees(width, event_size)
      masks.append(prev[:, None] <= degrees[None, :])
      self._names.append('masked_dense_{}'.format(idx))
      prev = degrees
    masks.append(prev[:, None] < np.tile(np.arange(1, event_size + 1),
                                          2)[None, :])
    self._names.append('masked_dense_out')
    self._masks = [m.astype(np.float32) for m in masks]
    self._mask_cache = {}
    for name, mask in zip(self._names, self._masks):
      self.register_parameter(name + '_kernel',
                              nn.Parameter(torch.empty(mask.shape)))
      self.register_parameter(name + '_bias',
                              nn.Parameter(torch.zeros(mask.shape[1])))

  def flax_init(self, generator: torch.Generator) -> None:
    """flax's xavier-uniform kernels and zero biases."""
    for name in self._names:
      kernel = getattr(self, name + '_kernel')
      fan_in, fan_out = kernel.shape
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      kernel.copy_(torch.rand(kernel.shape, generator=generator) *
                   (2 * limit) - limit)
      nn.init.zeros_(getattr(self, name + '_bias'))

  def _mask(self, i: int, like: torch.Tensor) -> torch.Tensor:
    key = (i, like.device, like.dtype)
    if key not in self._mask_cache:
      self._mask_cache[key] = torch.as_tensor(self._masks[i],
                                              dtype=like.dtype,
                                              device=like.device)
    return self._mask_cache[key]

  def forward(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = y
    last = len(self._names) - 1
    for i, name in enumerate(self._names):
      kernel = getattr(self, name + '_kernel').to(h.dtype)
      h = h @ (kernel * self._mask(i, kernel)) + getattr(
          self, name + '_bias').to(h.dtype)
      if i < last:
        h = torch.relu(h)
    shift, log_scale = h.chunk(2, -1)
    return shift, log_scale.clamp(LOG_SCALE_MIN_CLIP, LOG_SCALE_MAX_CLIP)


class MAFBijector(nn.Module):
  """``made_0`` .. ``made_{n-1}`` with a fixed permutation after each but
  the last."""

  def __init__(self, event_size: int, num_flows: int = 1,
               hidden_layers: Sequence[int] = (512, 512),
               permutation_seed: int = 42):
    super().__init__()
    self.event_size = event_size
    self.num_flows = num_flows
    for i in range(num_flows):
      self.add_module('made_{}'.format(i), MADE(event_size, hidden_layers))
    rng = np.random.RandomState(permutation_seed)
    self._permutations = [rng.permutation(event_size).astype(np.int64)
                          for _ in range(num_flows - 1)]

  def _flow(self, i: int) -> MADE:
    return getattr(self, 'made_{}'.format(i))

  def forward(self, u: torch.Tensor) -> torch.Tensor:
    """The sampling direction, base u -> data y."""
    y = u
    for i in range(self.num_flows):
      flow = self._flow(i)
      # y_i depends on y_{<i}: each pass fixes one more dimension.
      out = torch.zeros_like(y)
      for _ in range(self.event_size):
        shift, log_scale = flow(out)
        out = y * torch.exp(log_scale) + shift
      y = out
      if i < len(self._permutations):
        y = y[..., self._permutations[i]]
    return y

  def inverse_and_log_det(self, y: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The density direction, data y -> base u, with the sum of log|det|
    of the inverse's Jacobian."""
    u = y
    ildj = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    for i in reversed(range(self.num_flows)):
      if i < len(self._permutations):
        u = u[..., np.argsort(self._permutations[i])]
      shift, log_scale = self._flow(i)(u)
      u = (u - shift) * torch.exp(-log_scale)
      ildj = ildj - log_scale.sum(-1)
    return u, ildj


class MAFDistribution(nn.Module):
  """``forward(params, value=None, generator=None, noise=None) ->
  (sample, log_prob or None)``, in float32 as JAX casts: the sample is the
  pushforward of mu, of mu plus a unit normal drawn from ``generator`` or
  given as ``noise``."""

  def __init__(self, in_features: int, output_size: int, num_flows: int = 1,
               hidden_layers: Sequence[int] = (512, 512),
               permutation_seed: int = 42):
    super().__init__()
    self.output_size = output_size
    self.maf_mus = Dense(in_features, output_size)
    self.bijector = MAFBijector(output_size, num_flows, hidden_layers,
                                permutation_seed)

  def forward(self, params: torch.Tensor,
              value: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None):
    mus = self.maf_mus(params.to(torch.float32))
    if noise is None and generator is not None:
      noise = torch.randn(mus.shape, generator=generator,
                          device=mus.device, dtype=mus.dtype)
    u = mus if noise is None else mus + torch.as_tensor(
        noise, dtype=mus.dtype).to(mus.device)
    sample = self.bijector(u)
    if value is None:
      return sample, None
    base_u, ildj = self.bijector.inverse_and_log_det(
        value.to(torch.float32))
    log_prob = (-0.5 * ((base_u - mus) ** 2).sum(-1) -
                0.5 * self.output_size * math.log(2.0 * math.pi) + ildj)
    return sample, log_prob
