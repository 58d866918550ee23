"""Cross-entropy method (CEM) with a normal sampling distribution.

The counterpart of the JAX package's ``utils/cross_entropy.py``
``jax_normal_cem``: each iteration draws ``num_samples`` candidates from
N(mean, std), scores them, keeps the ``num_elites`` best and refits the
mean and the population std (``jnp.std``) to them. Leading batch dims of
``mean`` run independent CEMs side by side, which is how the batched
serving selector runs one CEM per request.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ['normal_cem']


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
