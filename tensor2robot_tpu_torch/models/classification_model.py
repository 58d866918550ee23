"""ClassificationModel: a binary classifier by sigmoid log-loss (the JAX
package's ``models/classification_model.py``). A subclass declares its
specifications and a network whose ``logits`` are held against a {0, 1}
label under ``label_key``; its eval metrics are the loss, the mean squared
error of the probabilities, accuracy, precision and recall; it serves the
logits and their probabilities."""

from __future__ import annotations

from typing import Dict

import torch

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.models.critic_model import (
    sigmoid_binary_cross_entropy)
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    NoOpPreprocessor)

__all__ = ['ClassificationModel']


class ClassificationModel(AbstractT2RModel):

  label_key = 'target'
  logits_key = 'logits'

  def __init__(self, **kwargs):
    kwargs.setdefault('preprocessor_cls', NoOpPreprocessor)
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(**kwargs)

  def _logits_and_targets(self, labels, inference_outputs):
    logits = inference_outputs[self.logits_key]
    targets = labels[self.label_key].to(logits.dtype).reshape(logits.shape)
    return logits, targets

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    logits, targets = self._logits_and_targets(labels, inference_outputs)
    return sigmoid_binary_cross_entropy(logits, targets).mean(), {}

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str) -> Dict[str, torch.Tensor]:
    logits, targets = self._logits_and_targets(labels, inference_outputs)
    probabilities = torch.sigmoid(logits.to(torch.float32))
    predictions = (probabilities > 0.5).to(torch.float32)
    targets_f = targets.to(torch.float32)
    true_positives = (predictions * targets_f).sum()
    eps = 1e-8
    return {
        'loss': sigmoid_binary_cross_entropy(logits, targets).mean(),
        'mean_squared_error': ((probabilities - targets_f) ** 2).mean(),
        'accuracy': (predictions == targets_f).to(torch.float32).mean(),
        'precision': true_positives / (predictions.sum() + eps),
        'recall': true_positives / (targets_f.sum() + eps),
    }

  def create_export_outputs_fn(self, features, inference_outputs,
                               mode: str) -> Dict[str, torch.Tensor]:
    logits = inference_outputs[self.logits_key]
    return {self.logits_key: logits,
            'probabilities': torch.sigmoid(logits.to(torch.float32))}
