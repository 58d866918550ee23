"""VariableLoggerHook: every N steps, each trainable tensor's mean and
standard deviation in the log (the JAX package's
``hooks/variable_logger_hook.py``)."""

from __future__ import annotations

import logging

from tensor2robot_tpu_torch.hooks.hook_builder import TrainHook

__all__ = ['VariableLoggerHook']


class VariableLoggerHook(TrainHook):
  """Logs each parameter's shape, mean and std every
  ``log_every_n_steps`` (and its first ``max_num_variable_values`` values
  where ``log_values``). One copy to the host a logged step."""

  def __init__(self, log_every_n_steps: int = 100, log_values: bool = False,
               max_num_variable_values: int = 16):
    self._log_every_n_steps = log_every_n_steps
    self._log_values = log_values
    self._max_num_variable_values = max_num_variable_values
    self._log = logging.getLogger(__name__).info

  def after_step(self, trainer, state, step: int, metrics) -> None:
    if step % self._log_every_n_steps != 0:
      return
    for name, value in state.params.items():
      value = value.detach().float().cpu()
      self._log('var %s: shape=%s mean=%.6f std=%.6f', name,
                tuple(value.shape), float(value.mean()),
                float(value.std(unbiased=False)))
      if self._log_values:
        self._log('var %s values: %s', name,
                  value.reshape(-1)[:self._max_num_variable_values].numpy())
