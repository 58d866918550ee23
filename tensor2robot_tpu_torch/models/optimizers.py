"""Optimizer pieces of the training slice (the JAX package's
``models/optimizers.py``, written out where it uses optax).

The port updates parameters functionally: an optimizer is an object with
``init(params) -> state`` and ``update(grads, state, params) -> (new_params,
new_state)`` over ``{name: tensor}`` dicts, and returns new tensors, so that
a step whose loss is not finite can keep the old ones (the trainer's
``nan_policy='skip'``). Counts are int32 device tensors, as optax keeps
them, so nothing waits for the device between steps.

  * ``create_adam_optimizer``: ``optax.adam(learning_rate, b1, b2,
    eps)``, the optimizer of the Seq2Act models (``torch.optim.Adam``
    updates in place, which ``nan_policy='skip'`` cannot undo);
  * ``create_ema``: ``optax.ema(decay, debias=True)``, the parameter
    average that serving reads (``avg_params``);
  * ``maybe_clip_gradients``: ``optax.clip_by_global_norm`` ahead of an
    optimizer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ['Adam', 'EMA', 'GlobalNormClip', 'create_adam_optimizer',
           'create_ema', 'global_norm', 'maybe_clip_gradients']

Tensors = Dict[str, torch.Tensor]


def _count_like(params: Tensors) -> torch.Tensor:
  device = next(iter(params.values())).device
  return torch.zeros((), dtype=torch.int32, device=device)


def _power(base: float, count: torch.Tensor) -> torch.Tensor:
  """``base ** count`` in float32, as optax computes it."""
  return torch.pow(torch.tensor(base, dtype=torch.float32,
                                device=count.device),
                   count.to(torch.float32))


class Adam:
  """optax's ``scale_by_adam`` then ``scale(-learning_rate)``:

    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    p -= learning_rate * (mu / (1 - b1^count)) /
         (sqrt(nu / (1 - b2^count)) + eps)

  with the bias corrections in float32. The state is ``{'count': int32,
  'mu': {name: tensor}, 'nu': {name: tensor}}``.
  """

  def __init__(self, learning_rate: float = 1e-4, beta1: float = 0.9,
               beta2: float = 0.999, epsilon: float = 1e-8):
    self.learning_rate = learning_rate
    self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

  def init(self, params: Tensors) -> dict:
    return {'count': _count_like(params),
            'mu': {k: torch.zeros_like(v) for k, v in params.items()},
            'nu': {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, grads: Tensors, state: dict,
             params: Tensors) -> Tuple[Tensors, dict]:
    b1, b2 = self.beta1, self.beta2
    mu = {k: (1 - b1) * g + b1 * state['mu'][k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state['nu'][k]
          for k, g in grads.items()}
    count = state['count'] + 1
    correction1 = 1 - _power(b1, count)
    correction2 = 1 - _power(b2, count)
    new_params = {}
    for k, p in params.items():
      step = (mu[k] / correction1.to(p.dtype)) / (
          torch.sqrt(nu[k] / correction2.to(p.dtype)) + self.epsilon)
      new_params[k] = p + step * -self.learning_rate
    return new_params, {'count': count, 'mu': mu, 'nu': nu}


def create_adam_optimizer(learning_rate: float = 1e-4, beta1: float = 0.9,
                          beta2: float = 0.999,
                          epsilon: float = 1e-8) -> Adam:
  """Adam: the port's ``optax.adam(learning_rate, b1=beta1, b2=beta2,
  eps=epsilon)``."""
  return Adam(learning_rate, beta1, beta2, epsilon)


class EMA:
  """``ema = decay * ema + (1 - decay) * p``; the served average is
  ``ema / (1 - decay ** count)`` (debiased), with count the number of
  updates. Averages what it is given: the trainer gives it the weights
  only, never the batch norm statistics."""

  def __init__(self, decay: float = 0.9999):
    self.decay = decay

  def init(self, params: Tensors) -> dict:
    return {'count': _count_like(params),
            'ema': {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, params: Tensors, state: dict) -> Tuple[Tensors, dict]:
    """Returns (the averaged params, the new state)."""
    d = self.decay
    ema = {k: (1 - d) * v + d * state['ema'][k] for k, v in params.items()}
    count = state['count'] + 1
    correction = 1 - _power(d, count)
    averaged = {k: v / correction.to(v.dtype) for k, v in ema.items()}
    return averaged, {'count': count, 'ema': ema}


def create_ema(decay: float = 0.9999) -> EMA:
  """Parameter averaging: the port's ``optax.ema(decay, debias=True)``."""
  return EMA(decay)


def global_norm(tensors: Tensors) -> torch.Tensor:
  return torch.sqrt(sum(v.to(torch.float32).square().sum()
                        for v in tensors.values()))


class GlobalNormClip:
  """Scales the gradients by ``max_norm / norm`` where their global norm
  reaches ``max_norm``, then runs the wrapped optimizer."""

  def __init__(self, optimizer, max_norm: float):
    self.optimizer = optimizer
    self.max_norm = float(max_norm)

  def init(self, params: Tensors):
    return self.optimizer.init(params)

  def update(self, grads: Tensors, state, params: Tensors):
    norm = global_norm(grads)
    keep = norm < self.max_norm
    grads = {k: torch.where(keep, g, g / norm.to(g.dtype) * self.max_norm)
             for k, g in grads.items()}
    return self.optimizer.update(grads, state, params)


def maybe_clip_gradients(optimizer, clip_norm: Optional[float] = None):
  """Global-norm clipping chained ahead of the optimizer update."""
  if clip_norm is None:
    return optimizer
  return GlobalNormClip(optimizer, clip_norm)
