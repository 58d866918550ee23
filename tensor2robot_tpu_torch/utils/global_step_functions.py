"""Hyperparameter schedules as functions of the global step (the JAX
package's ``utils/global_step_functions.py``): torch functions in float32,
on the host or on a step counter on the device."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ['exponential_decay', 'piecewise_linear']

# jnp.interp's threshold below which a segment has no width.
_EPSILON = float(np.spacing(np.finfo(np.float32).eps))


def piecewise_linear(boundaries: Sequence[int], values: Sequence[float]):
  """Linear interpolation between ``(boundary, value)`` knots; the first
  value before the first boundary, the last after the last."""
  if len(boundaries) != len(values):
    raise ValueError(
        'boundaries and values must have equal length; got {} vs {}.'.format(
            len(boundaries), len(values)))
  if list(boundaries) != sorted(boundaries):
    raise ValueError('boundaries must be sorted ascending.')
  xs = torch.tensor(boundaries, dtype=torch.float32)
  ys = torch.tensor(values, dtype=torch.float32)

  def schedule(global_step):
    """``jnp.interp(step, boundaries, values)``, term for term."""
    step = torch.as_tensor(global_step, dtype=torch.float32)
    xp, fp = xs.to(step.device), ys.to(step.device)
    i = torch.clamp(torch.searchsorted(xp, step, right=True), 1,
                    max(len(xp) - 1, 1))
    if len(xp) == 1:
      i = torch.zeros_like(i)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = step - xp[i - 1]
    flat = dx.abs() <= _EPSILON
    out = torch.where(flat, fp[i - 1],
                      fp[i - 1] + (delta / torch.where(
                          flat, torch.ones_like(dx), dx)) * df)
    out = torch.where(step < xp[0], fp[0], out)
    return torch.where(step > xp[-1], fp[-1], out)

  return schedule


def exponential_decay(initial_value: float = 0.0001,
                      decay_steps: int = 10000,
                      decay_rate: float = 0.9,
                      staircase: bool = True):
  """``initial_value * decay_rate ** (step / decay_steps)``, the exponent
  floored with ``staircase``."""

  def schedule(global_step):
    exponent = torch.as_tensor(global_step, dtype=torch.float32) / float(
        decay_steps)
    if staircase:
      exponent = torch.floor(exponent)
    return initial_value * torch.pow(
        torch.tensor(decay_rate, dtype=torch.float32), exponent)

  return schedule
