"""Discrete (binned) action decoding.

The counterparts of the JAX package's ``research/vrgripper/decoders.py``
``get_discrete_bins``, ``get_discrete_actions`` and
``get_discrete_action_loss``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['get_discrete_action_loss', 'get_discrete_actions',
           'get_discrete_bins']


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
