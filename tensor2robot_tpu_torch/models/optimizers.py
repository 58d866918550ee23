"""Optimizers and learning rates of the port (the JAX package's
``models/optimizers.py``, written out where it uses optax).

The port updates parameters functionally: an optimizer is an object with
``init(params) -> state`` and ``update(grads, state, params) -> (new_params,
new_state)`` over ``{name: tensor}`` dicts, and returns new tensors, so that
a step whose loss is not finite can keep the old ones (the trainer's
``nan_policy='skip'``). Counts are int32 device tensors, as optax keeps
them, and a learning-rate schedule reads its count on the device, so
nothing waits for the device between steps.

  * learning rates: a float, or a schedule ``count -> float32 tensor``
    evaluated at the update count before it is incremented, as optax
    evaluates it: ``create_constant_learning_rate``,
    ``create_exponential_decay_learning_rate`` (``staircase`` either way)
    and ``piecewise_constant_learning_rate``;
  * ``create_sgd_optimizer``, ``create_momentum_optimizer`` (with
    ``use_nesterov``), ``create_rms_prop_optimizer`` and
    ``create_adam_optimizer``: optax's ``sgd``, ``sgd(momentum,
    nesterov)``, ``rmsprop`` and ``adam``. optax's rmsprop puts epsilon
    inside the square root and keeps its momentum on the scaled step;
    torch's puts epsilon outside, so it is written out here, as the rest
    are (``torch.optim`` updates in place, which ``nan_policy='skip'``
    cannot undo);
  * ``create_ema``: ``optax.ema(decay, debias=True)``, the parameter
    average that serving reads (``avg_params``);
  * ``maybe_clip_gradients``: ``optax.clip_by_global_norm`` ahead of an
    optimizer;
  * ``create_default_optimizer``: the JAX models' default optimizer,
    ``create_adam_optimizer`` as the gins bind it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ['Adam', 'ConstantSchedule', 'EMA', 'ExponentialDecay',
           'GlobalNormClip', 'Momentum', 'PiecewiseConstant', 'RMSProp',
           'SGD', 'create_adam_optimizer', 'create_constant_learning_rate',
           'create_default_optimizer', 'create_ema',
           'create_exponential_decay_learning_rate',
           'create_momentum_optimizer', 'create_rms_prop_optimizer',
           'create_sgd_optimizer', 'global_norm', 'maybe_clip_gradients',
           'piecewise_constant_learning_rate']

Tensors = Dict[str, torch.Tensor]
ScalarOrSchedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _count_like(params: Tensors) -> torch.Tensor:
  device = next(iter(params.values())).device
  return torch.zeros((), dtype=torch.int32, device=device)


def _power(base: float, count: torch.Tensor) -> torch.Tensor:
  """``base ** count`` in float32, as optax computes it."""
  return torch.pow(torch.tensor(base, dtype=torch.float32,
                                device=count.device),
                   count.to(torch.float32))


# -- learning rates -----------------------------------------------------------


class ConstantSchedule:
  """``optax.constant_schedule``: the same rate at every count."""

  def __init__(self, value: float):
    self.value = float(value)

  def __call__(self, count: torch.Tensor) -> torch.Tensor:
    return torch.tensor(self.value, dtype=torch.float32, device=count.device)


class ExponentialDecay:
  """``optax.exponential_decay(init_value, decay_steps, decay_rate,
  staircase)``: ``init * rate ** (count / steps)``, the exponent floored
  when ``staircase``, in float32 on the count's device (``init`` at counts
  up to 0; a constant ``init`` where ``decay_steps`` is not positive or the
  rate is 0, as optax makes it)."""

  def __init__(self, init_value: float, decay_steps: int, decay_rate: float,
               staircase: bool = False):
    self.init_value = float(init_value)
    self.decay_steps = int(decay_steps)
    self.decay_rate = float(decay_rate)
    self.staircase = bool(staircase)

  def __call__(self, count: torch.Tensor) -> torch.Tensor:
    init = torch.tensor(self.init_value, dtype=torch.float32,
                        device=count.device)
    if self.decay_steps <= 0 or self.decay_rate == 0:
      return init
    p = count.to(torch.float32) / float(self.decay_steps)
    if self.staircase:
      p = torch.floor(p)
    rate = torch.tensor(self.decay_rate, dtype=torch.float32,
                        device=count.device)
    return torch.where(count <= 0, init, init * torch.pow(rate, p))


class PiecewiseConstant:
  """``optax.piecewise_constant_schedule(init, {boundary: scale})``: the
  rate is multiplied by each boundary's scale once the count passes it,
  in float32 as optax multiplies."""

  def __init__(self, init_value: float, boundaries_and_scales: Dict[int,
                                                                    float]):
    if any(scale < 0 for scale in boundaries_and_scales.values()):
      raise ValueError('piecewise constant scales must be non-negative.')
    self.init_value = float(init_value)
    self.boundaries_and_scales = sorted(
        (int(k), float(v)) for k, v in boundaries_and_scales.items())

  def __call__(self, count: torch.Tensor) -> torch.Tensor:
    v = torch.tensor(self.init_value, dtype=torch.float32,
                     device=count.device)
    for threshold, scale in self.boundaries_and_scales:
      indicator = torch.clamp(torch.sign(threshold - count), min=0).to(
          torch.float32)
      v = v * indicator + (1 - indicator) * scale * v
    return v


def create_constant_learning_rate(learning_rate: float = 1e-4
                                  ) -> ConstantSchedule:
  return ConstantSchedule(learning_rate)


def create_exponential_decay_learning_rate(
    initial_learning_rate: float = 1e-4, decay_steps: int = 10000,
    decay_rate: float = 0.9, staircase: bool = True) -> ExponentialDecay:
  return ExponentialDecay(initial_learning_rate, decay_steps, decay_rate,
                          staircase)


def piecewise_constant_learning_rate(boundaries: Sequence[int],
                                     values: Sequence[float]
                                     ) -> PiecewiseConstant:
  """``values[i]`` from ``boundaries[i - 1]`` on, as the JAX function
  builds it: each value as a scale of the one before."""
  scales = {}
  previous = values[0]
  for boundary, value in zip(boundaries, values[1:]):
    scales[int(boundary)] = value / previous
    previous = value
  return PiecewiseConstant(values[0], scales)


def _step_size(learning_rate: ScalarOrSchedule, count: torch.Tensor,
               dtype: torch.dtype):
  """``-learning_rate`` at ``count``: a float stays a float; a schedule's
  float32 tensor is cast to the parameters' dtype, as optax casts it."""
  if callable(learning_rate):
    return (-learning_rate(count)).to(dtype)
  return -float(learning_rate)


# -- optimizers ---------------------------------------------------------------


class SGD:
  """``optax.sgd(learning_rate)``: ``p += -lr * g``. The state is
  ``{'count': int32}``."""

  def __init__(self, learning_rate: ScalarOrSchedule = 1e-4):
    self.learning_rate = learning_rate

  def init(self, params: Tensors) -> dict:
    return {'count': _count_like(params)}

  def update(self, grads: Tensors, state: dict,
             params: Tensors) -> Tuple[Tensors, dict]:
    count = state['count']
    new_params = {k: p + _step_size(self.learning_rate, count, p.dtype) *
                  grads[k] for k, p in params.items()}
    return new_params, {'count': count + 1}


class Momentum:
  """``optax.sgd(learning_rate, momentum, nesterov)``: ``trace = g +
  momentum * trace``; the step is ``trace`` (``g + momentum * trace``
  with Nesterov), times ``-lr``. The state is ``{'count': int32, 'trace':
  {name: tensor}}``."""

  def __init__(self, learning_rate: ScalarOrSchedule = 1e-4,
               momentum: float = 0.9, nesterov: bool = False):
    self.learning_rate = learning_rate
    self.momentum = momentum
    self.nesterov = bool(nesterov)

  def init(self, params: Tensors) -> dict:
    return {'count': _count_like(params),
            'trace': {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, grads: Tensors, state: dict,
             params: Tensors) -> Tuple[Tensors, dict]:
    m = self.momentum
    trace = {k: g + m * state['trace'][k] for k, g in grads.items()}
    steps = ({k: g + m * trace[k] for k, g in grads.items()}
             if self.nesterov else trace)
    count = state['count']
    new_params = {k: p + _step_size(self.learning_rate, count, p.dtype) *
                  steps[k] for k, p in params.items()}
    return new_params, {'count': count + 1, 'trace': trace}


class RMSProp:
  """``optax.rmsprop(learning_rate, decay, eps, momentum)``:

    nu = (1 - decay) g^2 + decay nu
    trace = -lr * g / sqrt(nu + eps) + momentum * trace;   p += trace

  epsilon inside the square root, the momentum on the scaled step (a
  momentum of 0 keeps a trace equal to the step). The state is
  ``{'count': int32, 'nu': {...}, 'trace': {...}}``."""

  def __init__(self, learning_rate: ScalarOrSchedule = 1e-4,
               decay: float = 0.9, momentum: float = 0.0,
               epsilon: float = 1e-10):
    self.learning_rate = learning_rate
    self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

  def init(self, params: Tensors) -> dict:
    return {'count': _count_like(params),
            'nu': {k: torch.zeros_like(v) for k, v in params.items()},
            'trace': {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, grads: Tensors, state: dict,
             params: Tensors) -> Tuple[Tensors, dict]:
    d, m, count = self.decay, self.momentum, state['count']
    nu = {k: (1 - d) * (g * g) + d * state['nu'][k]
          for k, g in grads.items()}
    trace, new_params = {}, {}
    for k, p in params.items():
      scaled = torch.rsqrt(nu[k] + self.epsilon) * grads[k]
      step = _step_size(self.learning_rate, count, p.dtype) * scaled
      trace[k] = step + m * state['trace'][k]
      new_params[k] = p + trace[k]
    return new_params, {'count': count + 1, 'nu': nu, 'trace': trace}


class Adam:
  """optax's ``scale_by_adam`` then ``scale_by_learning_rate``:

    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    p -= lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

  with the bias corrections in float32 and ``lr`` a float or a schedule
  read at the count before the increment. The state is ``{'count': int32,
  'mu': {name: tensor}, 'nu': {name: tensor}}``.
  """

  def __init__(self, learning_rate: ScalarOrSchedule = 1e-4,
               beta1: float = 0.9, beta2: float = 0.999,
               epsilon: float = 1e-8):
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
      new_params[k] = p + step * _step_size(self.learning_rate,
                                            state['count'], p.dtype)
    return new_params, {'count': count, 'mu': mu, 'nu': nu}


def create_adam_optimizer(learning_rate: ScalarOrSchedule = 1e-4,
                          beta1: float = 0.9, beta2: float = 0.999,
                          epsilon: float = 1e-8) -> Adam:
  """Adam: the port's ``optax.adam(learning_rate, b1=beta1, b2=beta2,
  eps=epsilon)``."""
  return Adam(learning_rate, beta1, beta2, epsilon)


def create_default_optimizer():
  """``create_adam_optimizer`` with the gin bindings of its configurable
  where the port's registry has it (``create_adam_optimizer.learning_rate
  = ...``), as a JAX model that names no optimizer trains; its defaults
  otherwise."""
  from tensor2robot_tpu_torch.config import ginlike

  try:
    return ginlike.get_configurable('create_adam_optimizer')()
  except (KeyError, ginlike.ConfigError):
    return create_adam_optimizer()


def create_sgd_optimizer(learning_rate: ScalarOrSchedule = 1e-4) -> SGD:
  """``optax.sgd(learning_rate)``."""
  return SGD(learning_rate)


def create_momentum_optimizer(learning_rate: ScalarOrSchedule = 1e-4,
                              momentum: float = 0.9,
                              use_nesterov: bool = False) -> Momentum:
  """``optax.sgd(learning_rate, momentum, nesterov=use_nesterov)``."""
  return Momentum(learning_rate, momentum, use_nesterov)


def create_rms_prop_optimizer(learning_rate: ScalarOrSchedule = 1e-4,
                              decay: float = 0.9, momentum: float = 0.0,
                              epsilon: float = 1e-10) -> RMSProp:
  """``optax.rmsprop(learning_rate, decay, momentum=momentum,
  eps=epsilon)``."""
  return RMSProp(learning_rate, decay, momentum, epsilon)


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
