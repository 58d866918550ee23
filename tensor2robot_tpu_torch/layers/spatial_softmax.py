"""Spatial-softmax keypoints (the JAX package's ``layers/spatial_softmax.
py``): the expected (x, y) location of each channel of a feature map under
the softmax of its activations over the positions.

JAX's Gumbel branch perturbs the logits with ``jax.random.gumbel``; the
port draws its Gumbel noise from a ``torch.Generator`` (``gumbel_noise``
replaces the draw, so that a test can feed JAX's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ['draw_gumbel', 'spatial_softmax']


def _position_grids(num_rows: int, num_cols: int, dtype, device):
  """x and y of each position, row-major, in [-1, 1]."""
  cols = torch.linspace(-1.0, 1.0, num_cols, dtype=dtype, device=device)
  rows = torch.linspace(-1.0, 1.0, num_rows, dtype=dtype, device=device)
  return (cols[None, :].expand(num_rows, num_cols).reshape(-1),
          rows[:, None].expand(num_rows, num_cols).reshape(-1))


def draw_gumbel(shape, generator: torch.Generator,
                dtype=torch.float32) -> torch.Tensor:
  """Standard Gumbel noise, ``-log(-log(u))`` with u uniform in (tiny, 1),
  from ``generator`` on its device."""
  tiny = torch.finfo(dtype).tiny
  u = torch.rand(shape, generator=generator, device=generator.device,
                 dtype=dtype).clamp_min(tiny)
  return -torch.log(-torch.log(u))


def spatial_softmax(features: torch.Tensor, temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    gumbel_noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(expected points [B, 2 C] laid out [x1..xC, y1..yC], softmax maps
  [B, H, W, C]) of NHWC ``features``. With ``generator`` (or
  ``gumbel_noise``, [B, C, H W]) the logits are perturbed by Gumbel noise
  first, the stochastic branch."""
  batch, num_rows, num_cols, channels = features.shape
  dtype = features.dtype
  x_pos, y_pos = _position_grids(num_rows, num_cols, dtype, features.device)
  logits = features.permute(0, 3, 1, 2).reshape(batch, channels,
                                                num_rows * num_cols)
  logits = logits / temperature
  if gumbel_noise is None and generator is not None:
    gumbel_noise = draw_gumbel(logits.shape, generator, dtype)
  if gumbel_noise is not None:
    logits = logits + torch.as_tensor(gumbel_noise, dtype=dtype).to(
        logits.device)
  attention = F.softmax(logits, dim=-1)
  expected_x = (attention * x_pos).sum(-1)
  expected_y = (attention * y_pos).sum(-1)
  softmax_maps = attention.reshape(batch, channels, num_rows,
                                   num_cols).permute(0, 2, 3, 1)
  return torch.cat([expected_x, expected_y], -1), softmax_maps
