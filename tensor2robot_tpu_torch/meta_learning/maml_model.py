"""MAMLModel: any base model, meta-learned by gradient-based adaptation
(the JAX package's ``meta_learning/maml_model.py``).

The model's network, ``MAMLNetwork``, holds the base network's modules
under their own names (its state dict is the base network's, plus
``maml_inner_lrs.<name>`` where the inner rates are learned, as
``convert.from_flax`` maps JAX's ``{'base', 'maml_inner_lrs'}``), and its
forward is the whole adaptation: for each task, the inner loop on the
task's condition batch (``MAMLInnerLoopGradientDescent``), then the
adapted and the unadapted forwards on its inference batch. JAX vmaps that
over the tasks; the port loops over them, each task with its own copy of
the batch norm statistics, and (in TRAIN) sets the new statistics to the
mean over the tasks, as JAX does with its vmapped copies. The outer
gradient reaches the base weights through every task's adaptation
(second order unless the inner loop says first).

Predictions, as JAX's:
  full_condition_outputs/output_<i>/<k>  each inner step's outputs (k + 1)
  full_condition_output/<k>              output_0 (before adaptation)
  full_inference_output/<k>              the adapted inference outputs
  full_inference_output_unconditioned/<k>
  inner_losses/step_<i>                  the inner loss, mean over tasks
plus ``condition_output`` and ``inference_output`` from
``_select_inference_output``. The outer loss is the base model's on the
inference outputs with the task and sample dims flattened.

The adaptation differentiates in every mode: ``predict_step`` runs under
``torch.no_grad`` (not inference mode), and the inner loop enables the
gradient of its own loss there.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.meta_learning import (
    preprocessors as meta_preprocessors)
from tensor2robot_tpu_torch.meta_learning.maml_inner_loop import (
    MAMLInnerLoopGradientDescent)
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.modes import ModeKeys

__all__ = ['INNER_LRS_KEY', 'MAMLModel', 'MAMLNetwork',
           'MAMLRegressionModel']

INNER_LRS_KEY = 'maml_inner_lrs'


def _sub(struct, prefix: str) -> Dict[str, Any]:
  return {key[len(prefix):]: value for key, value in struct.items()
          if key.startswith(prefix)}


def _scalar_tree(names) -> nn.Module:
  """A module of float32 scalar parameters, one a name, nested by the
  names' dots (the learned inner rates)."""
  root = nn.Module()
  for name in names:
    module = root
    *path, leaf = name.split('.')
    for part in path:
      if not hasattr(module, part):
        module.add_module(part, nn.Module())
      module = getattr(module, part)
    module.register_parameter(leaf, nn.Parameter(torch.zeros(())))
  return root


class MAMLNetwork(nn.Module):
  """The base network's modules and tensors under their names, and the
  learned inner rates; ``forward(features, mode)`` adapts and predicts
  (module docstring)."""

  def __init__(self, base_network: nn.Module,
               inner_loop: MAMLInnerLoopGradientDescent,
               num_inner_loop_steps: int, inner_loss_fn,
               select_fn):
    super().__init__()
    object.__setattr__(self, '_base', base_network)
    for name, child in base_network.named_children():
      self.add_module(name, child)
    for name, param in base_network.named_parameters(recurse=False):
      self.register_parameter(name, param)
    for name, buffer in base_network.named_buffers(recurse=False):
      self.register_buffer(name, buffer)
    self._inner_loop = inner_loop
    self._steps = num_inner_loop_steps
    self._inner_loss_fn = inner_loss_fn
    self._select_fn = select_fn
    if inner_loop.learn_inner_lr:
      self.add_module(INNER_LRS_KEY, _scalar_tree(
          name for name, _ in base_network.named_parameters()))

  def base_tensors(self):
    """(parameters, buffers) of the base network, by its names: the
    tensors that a ``functional_call`` of this network swapped in."""
    params = {k: v for k, v in self.named_parameters()
              if not k.startswith(INNER_LRS_KEY + '.')}
    return params, dict(self.named_buffers())

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    params, buffers = self.base_tensors()
    inner_lrs = (_sub(dict(self.named_parameters()), INNER_LRS_KEY + '.')
                 if self._inner_loop.learn_inner_lr else None)
    cond_f = _sub(features, 'condition/features/')
    cond_l = _sub(features, 'condition/labels/')
    inf_f = _sub(features, 'inference/features/')
    num_tasks = next(iter(cond_f.values())).shape[0]
    base = self._base

    def forward_fn(state, task_features):
      return torch.func.functional_call(base, state, (task_features,),
                                        {'mode': mode}, strict=True)

    def loss_fn(state, task_features, task_labels, outputs):
      return self._inner_loss_fn(state, task_features, task_labels, outputs,
                                 mode)

    tasks, task_buffers = [], []
    for t in range(num_tasks):
      state = {k: v.clone() for k, v in buffers.items()}
      take = lambda struct: {k: v[t] for k, v in struct.items()}
      inputs = ([(take(cond_f), take(cond_l))] * self._steps +
                [(take(inf_f), take(cond_l))])
      tasks.append(self._inner_loop.inner_loop(
          params, state, inputs, forward_fn, loss_fn, inner_lrs))
      task_buffers.append(state)
    if mode == ModeKeys.TRAIN and buffers:
      with torch.no_grad():
        for name, value in buffers.items():
          value.copy_(torch.stack([s[name] for s in task_buffers]).mean(0))

    stack = lambda outputs, key: torch.stack([o[key] for o in outputs])
    predictions = {}
    inner_outputs = [[task[1][i] for task in tasks]
                     for i in range(len(tasks[0][1]))]
    for pos, step_outputs in enumerate(inner_outputs):
      for key in step_outputs[0]:
        predictions['full_condition_outputs/output_{}/{}'.format(
            pos, key)] = stack(step_outputs, key)
    for key in inner_outputs[0][0]:
      predictions['full_condition_output/' + key] = stack(inner_outputs[0],
                                                          key)
    conditioned = [task[0][1] for task in tasks]
    unconditioned = [task[0][0] for task in tasks]
    for key in conditioned[0]:
      predictions['full_inference_output/' + key] = stack(conditioned, key)
    for key in unconditioned[0]:
      predictions['full_inference_output_unconditioned/' + key] = stack(
          unconditioned, key)
    for pos in range(len(tasks[0][2])):
      predictions['inner_losses/step_{}'.format(pos)] = torch.stack(
          [task[2][pos] for task in tasks]).mean()
    predictions = self._select_fn(predictions)
    for key in ('condition_output', 'inference_output'):
      if key not in predictions:
        raise ValueError('_select_inference_output must assign {}.'.format(
            key))
    return predictions


class MAMLModel(AbstractT2RModel):
  """The base class of MAML meta models; a subclass picks the inference
  output (``_select_inference_output``)."""

  def __init__(self, base_model: AbstractT2RModel, preprocessor_cls=None,
               num_inner_loop_steps: int = 1,
               var_scope: Optional[str] = None,
               inner_loop: Optional[MAMLInnerLoopGradientDescent] = None,
               **kwargs):
    kwargs.setdefault('device', base_model.device)
    kwargs.setdefault('compute_dtype', base_model.compute_dtype)
    kwargs.setdefault('create_optimizer_fn',
                      optimizers.create_default_optimizer)
    super().__init__(**kwargs)
    if self.device != base_model.device:
      raise ValueError('The MAML model runs on {} and its base model on {}.'
                       .format(self.device, base_model.device))
    self._base_model = base_model
    self._maml_preprocessor_cls = preprocessor_cls
    self._num_inner_loop_steps = max(int(num_inner_loop_steps), 1)
    self._var_scope = var_scope
    self._inner_loop = inner_loop or MAMLInnerLoopGradientDescent(
        var_scope=var_scope)

  @property
  def base_model(self) -> AbstractT2RModel:
    return self._base_model

  @property
  def inner_loop(self) -> MAMLInnerLoopGradientDescent:
    return self._inner_loop

  @property
  def preprocessor(self):
    if self._preprocessor is None:
      cls = (self._maml_preprocessor_cls or
             meta_preprocessors.MAMLPreprocessorV2)
      self._preprocessor = cls(self._base_model.preprocessor)
    return self._preprocessor

  def get_feature_specification(self, mode: str):
    return meta_preprocessors.create_maml_feature_spec(
        self._base_model.get_feature_specification(mode),
        self._base_model.get_label_specification(mode))

  def get_label_specification(self, mode: str):
    return meta_preprocessors.create_maml_label_spec(
        self._base_model.get_label_specification(mode))

  def _inner_loss_fn(self):
    """A base model's dedicated inner objective, else its train loss."""
    return (getattr(self._base_model, 'inner_loop_loss_fn', None) or
            self._base_model.model_train_fn)

  def create_network(self) -> nn.Module:
    return MAMLNetwork(self._base_model.create_network(), self._inner_loop,
                       self._num_inner_loop_steps, self._inner_loss_fn(),
                       self._select_inference_output)

  def init_variables(self, generator: torch.Generator):
    """The base model's initial weights (its own initializers) and, with
    learned inner rates, each at the inner loop's learning rate."""
    variables = self._base_model.init_variables(generator)
    params = dict(variables['params'])
    if self._inner_loop.learn_inner_lr:
      names = {n for n, _ in self._base_model.network.named_parameters()}
      params.update({INNER_LRS_KEY + '.' + n: lr for n, lr in
                     self._inner_loop.create_inner_lr_params(
                         {n: params[n] for n in names}).items()})
    out = {'params': params}
    if self.use_avg_model_params:
      out['avg_params'] = {k: v.clone() for k, v in params.items()}
    return out

  @abc.abstractmethod
  def _select_inference_output(self, predictions):
    """Assigns ``condition_output`` and ``inference_output``."""

  def predict_step(self, variables, features):
    """The serving forward, under ``no_grad``: the adaptation takes the
    gradient of its inner loss, which inference mode would forbid."""
    with torch.no_grad():
      outputs = torch.func.functional_call(
          self.network, self.select_params(variables), (features,),
          {'mode': ModeKeys.PREDICT}, strict=True)
      return self.create_export_outputs_fn(features, outputs,
                                           ModeKeys.PREDICT)

  def _base_state(self, state):
    return {k: v for k, v in state.items()
            if not k.startswith(INNER_LRS_KEY + '.')}

  def _flat_inference(self, features, labels, inference_outputs):
    return (meta_data.flatten_batch_examples(
                _sub(features, 'inference/features/')),
            meta_data.flatten_batch_examples(dict(labels or {})),
            meta_data.flatten_batch_examples(
                _sub(inference_outputs, 'full_inference_output/')))

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """The base loss on the flattened adapted inference outputs, and the
    inner losses as ``inner_losses_step_<i>``."""
    inf_features, flat_labels, inf_outputs = self._flat_inference(
        features, labels, inference_outputs)
    loss, train_outputs = self._base_model.model_train_fn(
        self._base_state(state), inf_features, flat_labels, inf_outputs,
        mode)
    outputs = dict(train_outputs or {})
    for key, value in inference_outputs.items():
      if key.startswith('inner_losses/'):
        outputs[key.replace('/', '_')] = value
    return loss, outputs

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str):
    """The base model's eval metrics on the flattened inference
    outputs."""
    inf_features, flat_labels, inf_outputs = self._flat_inference(
        features, labels, inference_outputs)
    return self._base_model.model_eval_fn(self._base_state(state),
                                          inf_features, flat_labels,
                                          inf_outputs, mode)


class MAMLRegressionModel(MAMLModel):
  """MAML over a regression-style base model: the condition and inference
  outputs are the base model's ``inference_output``."""

  output_key = 'inference_output'

  def _select_inference_output(self, predictions):
    predictions['condition_output'] = predictions[
        'full_condition_output/' + self.output_key]
    predictions['inference_output'] = predictions[
        'full_inference_output/' + self.output_key]
    return predictions
