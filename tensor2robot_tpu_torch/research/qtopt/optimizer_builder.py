"""The legacy QT-Opt optimizer (hparams -> optimizer), the JAX package's
``research/qtopt/optimizer_builder.py``.

  * The learning rate decays exponentially in stairs: ``learning_rate *
    decay_factor ** floor(count / decay_steps)`` with ``decay_steps =
    examples_per_epoch / batch_size * num_epochs_per_decay``, evaluated at
    the optimizer's update count before it is incremented, as optax's
    schedule is.
  * ``'momentum'`` is ``optax.sgd(schedule, momentum)``: ``trace = g +
    momentum * trace; p = p - lr * trace``; ``'rmsprop'`` is
    ``optax.rmsprop(schedule, rmsprop_decay, momentum=momentum,
    eps=rmsprop_epsilon)`` (epsilon inside the square root); any other
    name is adam with ``b1 = momentum``, ``adam_beta2`` and
    ``adam_epsilon``. All are ``models/optimizers``' written-out forms, so
    that their states convert from optax's.

Parameter averaging is not part of the optimizer: the model keeps the EMA
(``models/optimizers.create_ema``) beside it, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

from tensor2robot_tpu_torch.models import optimizers

__all__ = ['Momentum', 'StaircaseSchedule', 'build_learning_rate_schedule',
           'build_opt', 'default_hparams']

Momentum = optimizers.Momentum


def default_hparams(**overrides) -> dict:
  """The legacy QT-Opt hparams."""
  hparams = dict(
      batch_size=32,
      examples_per_epoch=3000000,
      learning_rate=1e-4,
      learning_rate_decay_factor=0.999,
      model_weights_averaging=0.9999,
      momentum=0.9,
      num_epochs_per_decay=2.0,
      optimizer='momentum',
      rmsprop_decay=0.9,
      rmsprop_epsilon=1.0,
      adam_beta2=0.999,
      adam_epsilon=1e-8,
      use_avg_model_params=True,
  )
  hparams.update(overrides)
  return hparams


class StaircaseSchedule(optimizers.ExponentialDecay):
  """``init * rate ** floor(count / steps)``, in float32 on the count's
  device."""

  def __init__(self, init_value: float, decay_steps: int, decay_rate: float):
    if decay_steps <= 0:
      raise ValueError('decay_steps must be positive, not {}.'.format(
          decay_steps))
    super().__init__(init_value, decay_steps, decay_rate, staircase=True)


def build_learning_rate_schedule(hparams: dict) -> StaircaseSchedule:
  decay_steps = int(hparams['examples_per_epoch'] / hparams['batch_size'] *
                    hparams['num_epochs_per_decay'])
  return StaircaseSchedule(hparams['learning_rate'], decay_steps,
                           hparams['learning_rate_decay_factor'])


def build_opt(hparams: Optional[dict] = None):
  """The legacy optimizer (momentum, rmsprop or the adam fallback);
  parameter averaging is not part of it."""
  if hparams is None:
    hparams = default_hparams()
  learning_rate = build_learning_rate_schedule(hparams)
  optimizer = hparams['optimizer']
  if optimizer == 'momentum':
    return optimizers.Momentum(learning_rate, hparams['momentum'])
  if optimizer == 'rmsprop':
    return optimizers.RMSProp(learning_rate, decay=hparams['rmsprop_decay'],
                              momentum=hparams['momentum'],
                              epsilon=hparams['rmsprop_epsilon'])
  return optimizers.Adam(learning_rate, beta1=hparams['momentum'],
                         beta2=hparams.get('adam_beta2', 0.999),
                         epsilon=hparams.get('adam_epsilon', 1e-8))
