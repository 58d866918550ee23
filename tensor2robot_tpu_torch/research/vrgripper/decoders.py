"""Action decoders of the vrgripper models: MSE, MDN, MAF and discrete
bins (the JAX package's ``research/vrgripper/decoders.py``).

Each decoder is a module with one entry point::

    decoder(params_input, labels_action=None, generator=None)
      -> {'action': ..., [other outputs], ['loss': ...]}

the loss present where labels are given, so that the decode and its loss
run in one forward. ``in_features`` is the width of ``params_input``
(flax infers it). A decoder that samples (MDN, MAF) draws from
``generator`` where one is given, as JAX's does from its ``rng``; the
action is deterministic otherwise. The submodules keep flax's names
(``pose``, ``mdn_params``, ``maf``, ``action_logits``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import maf as maf_lib
from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers.basic import Dense

__all__ = ['DiscreteDecoder', 'MAFDecoder', 'MDNActionDecoder', 'MSEDecoder',
           'get_discrete_action_loss', 'get_discrete_actions',
           'get_discrete_bins']


def _labels(labels_action) -> Optional[torch.Tensor]:
  return None if labels_action is None else torch.as_tensor(
      labels_action).to(torch.float32)


class MSEDecoder(nn.Module):
  """A linear head (``pose``) and the mean squared error."""

  def __init__(self, in_features: int, output_size: int):
    super().__init__()
    self.pose = Dense(in_features, output_size)

  def forward(self, params_input, labels_action=None, generator=None):
    del generator
    predictions = self.pose(params_input)
    out = {'action': predictions}
    labels = _labels(labels_action)
    if labels is not None:
      out['loss'] = ((predictions.to(torch.float32) - labels) ** 2).mean()
    return out


class MDNActionDecoder(nn.Module):
  """A Gaussian mixture head: the action is the mixture's approximate mode
  (a sample where ``generator`` is given); the loss the labels' mean
  negative log likelihood."""

  def __init__(self, in_features: int, output_size: int,
               num_mixture_components: int = 1,
               condition_sigmas: bool = False):
    super().__init__()
    self.output_size = output_size
    self.num_mixture_components = num_mixture_components
    self.mdn_params = mdn.MDNParamsLayer(in_features, num_mixture_components,
                                         output_size, condition_sigmas)

  def forward(self, params_input, labels_action=None, generator=None):
    dist_params = self.mdn_params(params_input)
    gm = mdn.get_mixture_distribution(dist_params.to(torch.float32),
                                      self.num_mixture_components,
                                      self.output_size)
    action = (mdn.mixture_sample(gm, generator) if generator is not None
              else mdn.gaussian_mixture_approximate_mode(gm))
    out = {'action': action, 'dist_params': dist_params}
    labels = _labels(labels_action)
    if labels is not None:
      out['loss'] = mdn.mdn_loss(gm, labels)
    return out


class MAFDecoder(nn.Module):
  """A masked-autoregressive-flow head (``maf``): the action is the flow's
  pushforward of its base mean (of a sample where ``generator`` is
  given); the loss the labels' mean negative log density."""

  def __init__(self, in_features: int, output_size: int, num_flows: int = 1,
               hidden_layers: Tuple[int, ...] = (512, 512)):
    super().__init__()
    self.maf = maf_lib.MAFDistribution(in_features, output_size, num_flows,
                                       hidden_layers)

  def forward(self, params_input, labels_action=None, generator=None):
    sample, log_prob = self.maf(params_input, value=_labels(labels_action),
                                generator=generator)
    out = {'action': sample}
    if log_prob is not None:
      out['loss'] = -log_prob.mean()
    return out


def get_discrete_bins(num_bins: int, output_min, output_max) -> np.ndarray:
  """[num_bins, action_dim] float32 bin centers."""
  output_min = np.asarray(output_min, np.float32)
  output_max = np.asarray(output_max, np.float32)
  bin_sizes = (output_max - output_min) / float(num_bins)
  return np.array([output_min + bin_sizes * (bin_i + 0.5)
                   for bin_i in range(num_bins)], dtype=np.float32)


def get_discrete_actions(logits: torch.Tensor, action_size: int,
                         num_bins: int, bin_centers) -> torch.Tensor:
  """The mode action of each dimension: [..., action_size] float32.

  A softmax over each dimension's ``num_bins`` logits in float32, then the
  first maximal bin (as ``jnp.argmax`` picks it) and its center.
  """
  leading = logits.shape[:-1]
  probabilities = torch.softmax(
      logits.reshape(-1, action_size, num_bins).to(torch.float32), -1)
  index = probabilities.argmax(-1)                       # [N, action_size]
  centers = torch.as_tensor(np.transpose(bin_centers), dtype=torch.float32,
                            device=logits.device)       # [action, bins]
  actions = centers.gather(1, index.t()).t()
  return actions.reshape(leading + (action_size,))


def get_discrete_action_loss(logits: torch.Tensor,
                             action_labels: torch.Tensor, bin_centers,
                             num_bins: int) -> torch.Tensor:
  """Cross entropy against the one-hot of each label's nearest bin.

  ``logits`` [..., action_size * num_bins], ``action_labels`` [...,
  action_size]: the first bin center of least squared distance to each
  label (as ``jnp.argmin`` picks it), its one-hot, ``log_softmax`` of each
  dimension's logits in float32, and the mean over the rows (every step
  and dimension) of minus the one-hot's log probability.
  """
  labels = action_labels.to(torch.float32)[..., None, :]   # [..., 1, A]
  centers = torch.as_tensor(np.asarray(bin_centers), dtype=torch.float32,
                            device=logits.device)          # [bins, A]
  discrete = ((labels - centers) ** 2).argmin(-2)          # [..., A]
  one_hot = F.one_hot(discrete, num_bins).reshape(-1, num_bins).to(
      torch.float32)
  log_probs = F.log_softmax(logits.reshape(-1, num_bins).to(torch.float32),
                            -1)
  return -(one_hot * log_probs).sum(-1).mean()


class DiscreteDecoder(nn.Module):
  """Per-dimension binned actions: ``action_logits`` of ``output_size``
  x ``num_bins``, the mode bin's center, the nearest-bin cross entropy."""

  def __init__(self, in_features: int, output_size: int, num_bins: int = 1,
               output_min: Sequence[float] = (),
               output_max: Sequence[float] = ()):
    super().__init__()
    self.output_size = output_size
    self.num_bins = num_bins
    self.bin_centers = get_discrete_bins(num_bins, np.asarray(output_min),
                                         np.asarray(output_max))
    self.action_logits = Dense(in_features, output_size * num_bins)

  def forward(self, params_input, labels_action=None, generator=None):
    del generator
    logits = self.action_logits(params_input)
    out = {'action': get_discrete_actions(logits, self.output_size,
                                          self.num_bins, self.bin_centers),
           'action_logits': logits}
    labels = _labels(labels_action)
    if labels is not None:
      out['loss'] = get_discrete_action_loss(logits, labels,
                                             self.bin_centers, self.num_bins)
    return out
