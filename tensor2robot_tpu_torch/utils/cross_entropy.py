"""Cross-entropy method (CEM).

The counterpart of the JAX package's ``utils/cross_entropy.py``:

  * ``normal_cem`` (its ``jax_normal_cem``), on the device: each iteration
    draws ``num_samples`` candidates from N(mean, std), scores them, keeps
    the ``num_elites`` best and refits the mean and the population std
    (``jnp.std``) to them. Leading batch dims of ``mean`` run independent
    CEMs side by side, which is how the batched serving selector runs one
    CEM per request;
  * ``cross_entropy_method``, the host-side loop of numpy samples that
    ``policies.CEMPolicy`` drives through a predictor, one call an
    iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ['cross_entropy_method', 'normal_cem']


def cross_entropy_method(sample_fn: Callable, objective_fn: Callable,
                         update_fn: Callable, initial_params: dict,
                         num_elites: int, num_iterations: int = 1,
                         threshold_to_terminate: Optional[float] = None):
  """Maximizes ``objective_fn`` by CEM; returns (samples, values, params)
  of the last iteration.

  ``sample_fn(**params)`` draws a batch of samples (an array, or a dict of
  arrays), ``objective_fn(samples)`` scores them, and
  ``update_fn(params, elite_samples)`` refits the parameters to the
  ``num_elites`` best (``np.argsort``'s last, as the JAX package takes
  them). It stops early once a value exceeds ``threshold_to_terminate``.
  """
  params = initial_params
  samples = values = None
  for _ in range(num_iterations):
    samples = sample_fn(**params)
    values = np.asarray(objective_fn(samples))
    elite_idx = np.argsort(values)[-num_elites:]
    if isinstance(samples, dict):
      elites = {k: np.asarray(v)[elite_idx] for k, v in samples.items()}
    else:
      elites = np.asarray(samples)[elite_idx]
    params = update_fn(params, elites)
    if (threshold_to_terminate is not None and
        np.max(values) > threshold_to_terminate):
      break
  return samples, values, params


def normal_cem(objective: Callable[[torch.Tensor], torch.Tensor],
               mean: torch.Tensor,
               std: torch.Tensor,
               generator: Optional[torch.Generator],
               num_samples: int = 64,
               num_elites: int = 6,
               num_iterations: int = 3,
               noise: Optional[torch.Tensor] = None):
  """Maximizes ``objective`` by CEM; returns (mean, std, best_sample).

  Args:
    objective: samples [..., num_samples, dim] -> scores [..., num_samples].
    mean, std: the initial distribution, [..., dim].
    generator: draws the standard normal noise, on ``mean``'s device.
    num_samples, num_elites, num_iterations: as in ``jax_normal_cem``.
    noise: optional standard normal draws [num_iterations, ...,
      num_samples, dim] used in place of the generator's, so that a test
      can feed both packages the same noise.

  Elites are ranked best first with ties broken by the lower sample index,
  as ``lax.top_k`` breaks them (``torch.topk`` on CUDA breaks ties in no
  fixed order, so the ranking is a stable descending sort instead).
  ``best_sample`` is the best elite of the last iteration.
  """
  shape = mean.shape[:-1] + (num_samples, mean.shape[-1])
  if noise is not None and tuple(noise.shape) != (num_iterations,) + shape:
    raise ValueError('noise must be {}; got {}.'.format(
        (num_iterations,) + tuple(shape), tuple(noise.shape)))
  best = None
  for step in range(num_iterations):
    if noise is None:
      draw = torch.randn(shape, generator=generator, dtype=mean.dtype,
                         device=mean.device)
    else:
      draw = noise[step].to(device=mean.device, dtype=mean.dtype)
    samples = mean.unsqueeze(-2) + std.unsqueeze(-2) * draw
    scores = objective(samples)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    elite_idx = order[..., :num_elites]
    elites = torch.gather(
        samples, -2, elite_idx.unsqueeze(-1).expand(
            elite_idx.shape + (samples.shape[-1],)))
    mean = elites.mean(dim=-2)
    std = elites.std(dim=-2, correction=0)
    best = elites[..., 0, :]
  return mean, std, best
