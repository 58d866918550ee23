"""RegressionModel: a continuous-output model trained by mean squared
error (the JAX package's ``models/regression_model.py``). A subclass
declares its specifications and a network whose ``inference_output`` is
held against the label under ``label_key``. Its preprocessor is the
identity unless a subclass gives one, as JAX's models default."""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    NoOpPreprocessor)

__all__ = ['RegressionModel']


class RegressionModel(AbstractT2RModel):

  label_key = 'target'
  output_key = 'inference_output'

  def __init__(self, **kwargs):
    kwargs.setdefault('preprocessor_cls', NoOpPreprocessor)
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(**kwargs)

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    predictions = inference_outputs[self.output_key]
    targets = labels[self.label_key].to(predictions.dtype).reshape(
        predictions.shape)
    loss = ((predictions - targets).to(torch.float32) ** 2).mean()
    return loss, {}

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str):
    loss, _ = self.model_train_fn(state, features, labels,
                                  inference_outputs, mode)
    return {'loss': loss, 'mean_squared_error': loss}
