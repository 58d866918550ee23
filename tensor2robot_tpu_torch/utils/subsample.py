"""Fixed-length subsampling of variable-length sequences (the JAX
package's ``utils/subsample.py``).

``sequence_length`` frames are picked from an episode of ``length`` steps,
the first and the last always among them, evenly spaced, optionally with
random jitter inside each span. An episode no longer than
``sequence_length`` keeps every frame and repeats its last.

``get_subsample_indices_numpy`` is JAX's numpy variant, draws from a
``RandomState`` included; ``get_subsample_indices`` computes on tensors in
float32 as JAX's jnp variant does, its jitter drawn from a
``torch.Generator`` (or given as ``noise``, the uniform draws in [0, 1)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ['get_subsample_indices', 'get_subsample_indices_numpy',
           'subsample_sequence']


def get_subsample_indices_numpy(sequence_lengths: np.ndarray,
                                sequence_length: int,
                                rng: Optional[np.random.RandomState] = None,
                                randomized: bool = False) -> np.ndarray:
  """[batch] episode lengths -> [batch, sequence_length] frame indices."""
  sequence_lengths = np.asarray(sequence_lengths)
  out = np.zeros((sequence_lengths.shape[0], sequence_length), np.int64)
  rng = rng or np.random.RandomState()
  for i, length in enumerate(sequence_lengths):
    out[i] = _single_subsample_numpy(int(length), sequence_length,
                                     rng if randomized else None)
  return out


def _single_subsample_numpy(length: int, k: int,
                            rng: Optional[np.random.RandomState]
                            ) -> np.ndarray:
  if length <= k:
    return np.minimum(np.arange(k), max(length - 1, 0))
  boundaries = np.linspace(0, length - 1, k)
  if rng is None:
    return np.round(boundaries).astype(np.int64)
  # Each pick jittered within its span; the endpoints stay.
  low = np.floor(np.linspace(0, length - 1, k + 1)[:-1])
  high = np.ceil(np.linspace(0, length - 1, k + 1)[1:])
  picks = np.array([rng.randint(int(l), max(int(h), int(l) + 1))
                    for l, h in zip(low, high)], np.int64)
  picks[0] = 0
  picks[-1] = length - 1
  return np.clip(picks, 0, length - 1)


def _positions(k: int, device) -> torch.Tensor:
  """``jnp.linspace(0.0, 1.0, k)`` in float32, bit for bit."""
  if k == 1:
    return torch.zeros(1, device=device)
  step = torch.arange(k - 1, dtype=torch.float32, device=device) / float(
      k - 1)
  return torch.cat([step, torch.ones(1, device=device)])


def get_subsample_indices(sequence_lengths: torch.Tensor,
                          sequence_length: int,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
  """[batch] episode lengths -> [batch, sequence_length] int32 indices.

  Randomized where ``generator`` or ``noise`` ([batch, sequence_length]
  uniforms in [0, 1)) is given: each index moves by up to half a span, the
  first and the last stay.
  """
  lengths = torch.clamp(torch.as_tensor(sequence_lengths), min=1)
  device = lengths.device
  spans = (lengths - 1).to(torch.float32)[:, None]
  base = _positions(sequence_length, device)[None, :] * spans
  if noise is None and generator is not None:
    noise = torch.rand((lengths.shape[0], sequence_length),
                       generator=generator, device=device)
  if noise is not None:
    span = spans / float(max(sequence_length - 1, 1))
    jitter = (noise.to(torch.float32) - 0.5) * span
    jitter[:, 0] = 0.0
    jitter[:, -1] = 0.0
    base = base + jitter
  last = (lengths - 1)[:, None]
  idx = torch.minimum(torch.clamp(torch.round(base).to(torch.int32), min=0),
                      last.to(torch.int32))
  short = torch.minimum(
      torch.arange(sequence_length, dtype=torch.int32, device=device)[None],
      last.to(torch.int32))
  return torch.where((lengths <= sequence_length)[:, None], short, idx)


def subsample_sequence(tensor, indices):
  """Gathers [batch, time, ...] frames by per-batch [batch, k] indices
  (numpy in, numpy out; a tensor in, a tensor out)."""
  if isinstance(tensor, np.ndarray):
    return np.stack([tensor[i, indices[i]] for i in range(tensor.shape[0])])
  indices = torch.as_tensor(indices, device=tensor.device).long()
  return tensor[torch.arange(tensor.shape[0], device=tensor.device)[:, None],
                indices]
