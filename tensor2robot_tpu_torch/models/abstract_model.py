"""AbstractT2RModel: network, random init, the predict step and the train
step.

The counterpart of the JAX package's ``models/abstract_model.py``. A model
holds configuration and one network module on its device; the weights live
outside it, in a ``variables`` dict that the server can swap atomically:

  ``{'params': {name: tensor}, 'avg_params': {name: tensor}}``

Each entry is a full state dict of the network (parameters and the batch
norm statistics, which flax keeps apart under ``batch_stats``);
``avg_params`` is the EMA of the weights and is present when the model
averages them. ``convert.from_flax`` builds this dict from a JAX state.
The network runs on these tensors through ``torch.func.functional_call``.

Training keeps everything that changes in a ``TrainState``: the step, the
parameters, the batch norm buffers (flax's ``batch_stats``), the optimizer
state, and the EMA of the parameters with its state. ``train_step`` is the
JAX package's: the loss and its gradient through autograd, the optimizer
update (after an optional global-norm clip), then the EMA of the new
weights. ``TrainState.variables()`` is the serving dict above.

With a ``process_group`` (the ranks of ring attention, each holding its
shard of every episode), ``train_step`` sums the gradients over the group
in one flat all-reduce before the clip and the optimizer, so that every
rank applies the same update to the same weights. ``frame_shard`` names a
rank's share of every episode (the trainer draws only that), and
``shard_batch`` cuts it out of a batch of whole episodes.

As in the JAX package, activations are bfloat16 only where
``device_type == 'tpu'`` (``train_seq2act_bc.gin`` binds it); the port
computes float32 on the GPU unless that or ``compute_dtype`` asks for
bfloat16. Parameters, gradients and optimizer state stay float32 either
way: a network casts its weights to its compute dtype where it uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.layers import initializers
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.parallel import collectives

__all__ = ['AbstractT2RModel', 'TrainState', 'Variables']

StateDict = Dict[str, torch.Tensor]
Variables = Dict[str, StateDict]

def _init_module(module: nn.Module, generator: torch.Generator) -> None:
  """flax's initializers, as the module declares them
  (``layers/initializers.py``): a kernel (a ``weight`` of two or more dims)
  from its ``kernel_init``, lecun normal by default; a ``bias`` from its
  ``bias_init``, zeros by default; norm scales 1; every other parameter 0;
  batch norm buffers mean 0, var 1. A module with other initializers for
  its own tensors applies them in ``flax_init``."""
  for name, param in module.named_parameters(recurse=False):
    if name == 'weight' and param.dim() >= 2:
      getattr(module, 'kernel_init', initializers.lecun_normal)(param,
                                                                generator)
    elif name == 'bias':
      getattr(module, 'bias_init', initializers.zeros)(param, generator)
    elif name == 'scale':
      nn.init.ones_(param)
    else:
      nn.init.zeros_(param)
  for name, buffer in module.named_buffers(recurse=False):
    (nn.init.ones_ if name == 'var' else nn.init.zeros_)(buffer)
  if hasattr(module, 'flax_init'):
    module.flax_init(generator)


@dataclasses.dataclass
class TrainState:
  """All state that training changes; tensors on the model's device.

  ``params`` are the trainable tensors and ``model_state`` the batch norm
  buffers, both keyed by the network's state-dict names. ``opt_state`` is
  the optimizer's (``{'count', 'trace'}`` for momentum); ``avg_params`` and
  ``ema_state`` are the EMA of ``params`` and its ``{'count', 'ema'}``,
  present when the model averages. ``step`` counts train steps, skipped
  ones included.
  """

  step: int
  params: StateDict
  model_state: StateDict
  opt_state: Any
  avg_params: Optional[StateDict] = None
  ema_state: Optional[Any] = None

  def variables(self) -> Variables:
    """The serving dict: ``params`` and, when present, ``avg_params``, each
    with the batch norm buffers (the EMA averages the weights only)."""
    variables = {'params': {**self.params, **self.model_state}}
    if self.avg_params is not None:
      variables['avg_params'] = {**self.avg_params, **self.model_state}
    return variables


def _scalars(outputs) -> Dict[str, torch.Tensor]:
  return {key: value.detach() for key, value in (outputs or {}).items()
          if isinstance(value, torch.Tensor) and value.dim() == 0}


class AbstractT2RModel:
  """Base model: one network on one device, its inference function and its
  train step."""

  def __init__(self,
               preprocessor_cls: Optional[Callable[..., object]] = None,
               device='cuda',
               device_type: str = 'gpu',
               use_avg_model_params: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               create_optimizer_fn: Optional[Callable[[], Any]] = None,
               avg_model_params_decay: float = 0.9999,
               gradient_clip_norm: Optional[float] = None,
               process_group=None,
               warm_start_fn: Optional[Callable[[StateDict],
                                                StateDict]] = None):
    """Args:
      preprocessor_cls: factory of the model's preprocessor, called with
        the model's feature and label specification functions.
      device: where the network runs (``'cpu'`` only when asked for).
      device_type: 'cpu' | 'gpu' | 'tpu'; picks the default compute dtype.
      use_avg_model_params: keep an EMA of the weights and serve and
        evaluate it (``avg_params``).
      compute_dtype: activations dtype of networks that honor it.
      create_optimizer_fn: zero-arg factory of the optimizer (an object
        with ``init`` and ``update``, see ``models/optimizers.py``).
      avg_model_params_decay: the EMA's decay.
      gradient_clip_norm: optional global-norm clip ahead of the optimizer.
      process_group: the ``torch.distributed`` group whose ranks each hold a
        shard of the batch; gradients are summed over it.
      warm_start_fn: ``params -> params``, applied to the fresh trainable
        weights of ``create_train_state`` (e.g.
        ``trainer.checkpointing.create_warm_start_fn``).
    """
    self.device = torch.device(device)
    self.process_group = process_group
    self._preprocessor_cls = preprocessor_cls
    self._preprocessor = None
    self.use_avg_model_params = use_avg_model_params
    self._create_optimizer_fn = create_optimizer_fn
    self.avg_model_params_decay = avg_model_params_decay
    self.gradient_clip_norm = gradient_clip_norm
    self._warm_start_fn = warm_start_fn
    if compute_dtype is None:
      compute_dtype = (torch.bfloat16 if device_type == 'tpu'
                       else torch.float32)
    self.compute_dtype = compute_dtype
    self._network: Optional[nn.Module] = None

  @property
  def warm_start_fn(self):
    return self._warm_start_fn

  @property
  def preprocessor(self):
    if self._preprocessor is None:
      if self._preprocessor_cls is None:
        raise NotImplementedError('{} has no preprocessor.'.format(
            type(self).__name__))
      self._preprocessor = self._preprocessor_cls(
          self.get_feature_specification, self.get_label_specification)
    return self._preprocessor

  def set_preprocessor(self, preprocessor) -> None:
    """Installs a (wrapped) preprocessor, e.g. the split decode's
    ``DeviceDecodePreprocessor``."""
    self._preprocessor = preprocessor

  def get_feature_specification(self, mode: str) -> Dict[str, tuple]:
    """The network's features, ``{key: (shape, dtype)}`` without the batch
    dim, as the preprocessor hands them on."""
    raise NotImplementedError('{} declares no feature specification.'.format(
        type(self).__name__))

  def get_label_specification(self, mode: str) -> Dict[str, tuple]:
    raise NotImplementedError('{} declares no label specification.'.format(
        type(self).__name__))

  def create_network(self) -> nn.Module:
    raise NotImplementedError(
        '{} must implement create_network().'.format(type(self).__name__))

  @property
  def network(self) -> nn.Module:
    """The model's network on its device, in eval mode. Its own tensors
    are placeholders: every call supplies the weights."""
    if self._network is None:
      self._network = self.create_network().to(self.device).eval()
    return self._network

  def to_device(self, state: StateDict) -> StateDict:
    """Moves a state dict to the model's device; conv kernels go to
    channels_last, the layout the network computes in."""
    out = {}
    for name, value in state.items():
      value = value.to(self.device)
      if value.dim() == 4:
        value = value.contiguous(memory_format=torch.channels_last)
      out[name] = value
    return out

  def init_variables(self, generator: torch.Generator) -> Variables:
    """Random weights drawn on the CPU from ``generator``, then moved to
    the model's device. ``avg_params`` starts equal to ``params``."""
    network = self.create_network()
    with torch.no_grad():
      for module in network.modules():
        _init_module(module, generator)
    params = self.to_device(dict(network.state_dict()))
    variables = {'params': params}
    if self.use_avg_model_params:
      variables['avg_params'] = {k: v.clone() for k, v in params.items()}
    return variables

  def select_params(self, variables: Variables) -> StateDict:
    """The weights that serve: ``avg_params`` when the model averages and
    they are present, else ``params``."""
    avg_params = variables.get('avg_params')
    if self.use_avg_model_params and avg_params is not None:
      return avg_params
    return variables['params']

  def inference_network_fn(self, variables: Variables, features,
                           mode: str = ModeKeys.PREDICT):
    """The eval or predict forward of the network on ``variables``; the
    train forward is ``loss_fn``'s."""
    if mode == ModeKeys.TRAIN:
      raise ValueError('The train forward updates batch norm buffers; it '
                       'runs in loss_fn.')
    return torch.func.functional_call(
        self.network, self.select_params(variables), (features,),
        {'mode': mode}, strict=True)

  def create_export_outputs_fn(self, features, inference_outputs,
                               mode: str) -> Dict[str, torch.Tensor]:
    """The serving outputs from the network's outputs (the outputs
    themselves unless a model says otherwise)."""
    del features, mode
    return dict(inference_outputs)

  def predict_step(self, variables: Variables,
                   features) -> Dict[str, torch.Tensor]:
    """The serving forward: the PREDICT network on the served weights,
    then ``create_export_outputs_fn``. ``features`` are preprocessed."""
    with torch.inference_mode():
      outputs = self.inference_network_fn(variables, features,
                                          ModeKeys.PREDICT)
      return self.create_export_outputs_fn(features, outputs,
                                           ModeKeys.PREDICT)

  # -- loss ------------------------------------------------------------------

  def model_train_fn(self, state: StateDict, features, labels,
                     inference_outputs, mode: str):
    """(loss, scalar outputs) from the network's outputs; ``state`` is the
    state dict the network ran on."""
    raise NotImplementedError('{} must implement model_train_fn.'.format(
        type(self).__name__))

  def model_eval_fn(self, state: StateDict, features, labels,
                    inference_outputs, mode: str) -> Dict[str, torch.Tensor]:
    """The train loss as the eval metric."""
    loss, _ = self.model_train_fn(state, features, labels, inference_outputs,
                                  mode)
    return {'loss': loss}

  # -- training --------------------------------------------------------------

  def create_optimizer(self):
    if self._create_optimizer_fn is None:
      raise NotImplementedError('{} has no optimizer.'.format(
          type(self).__name__))
    return optimizers.maybe_clip_gradients(self._create_optimizer_fn(),
                                           self.gradient_clip_norm)

  def create_train_state(self, generator: torch.Generator) -> TrainState:
    """Random weights from ``generator`` (``init_variables``), merged with
    a warm start's where the model has ``warm_start_fn``, a fresh
    optimizer state and, when the model averages, an EMA that starts from
    the weights."""
    state = self.init_variables(generator)['params']
    names = {name for name, _ in self.network.named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    model_state = {k: v for k, v in state.items() if k not in names}
    if self._warm_start_fn is not None:
      params = self._warm_start_fn(params)
    avg_params = ema_state = None
    if self.use_avg_model_params:
      ema = optimizers.create_ema(self.avg_model_params_decay)
      ema_state = ema.init(params)
      avg_params = {k: v.clone() for k, v in params.items()}
    return TrainState(step=0, params=params, model_state=model_state,
                      opt_state=self.create_optimizer().init(params),
                      avg_params=avg_params, ema_state=ema_state)

  @property
  def draws_in_training(self) -> bool:
    """Whether the TRAIN network draws from the step's generator (the
    trainer then hands one to ``train_step``)."""
    return False

  def network_kwargs(self, mode: str,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Any]:
    """The keyword arguments of the network's forward in ``mode``: the
    mode, and whatever a model draws from the step's ``generator`` (JAX's
    step key), such as dropout's masks."""
    del generator
    return {'mode': mode}

  def network_inputs(self, features, labels) -> Tuple[Any, ...]:
    """The positional arguments of the network's TRAIN and EVAL forwards:
    the features; a model whose network computes its loss in the forward
    (the vrgripper meta models' decoders) takes the labels too."""
    del labels
    return (features,)

  def loss_fn(self, params: StateDict, model_state: StateDict, features,
              labels, mode: str = ModeKeys.TRAIN,
              generator: Optional[torch.Generator] = None):
    """(loss, (train_outputs, outputs, new_model_state)).

    The network runs on ``params`` and copies of ``model_state``; in TRAIN
    mode it updates the copies (the batch norm running statistics), which
    come back as ``new_model_state``. ``model_state`` is left as it was.
    ``generator`` feeds the network's random draws (``network_kwargs``).
    """
    new_model_state = {k: v.clone() for k, v in model_state.items()}
    state = {**params, **new_model_state}
    outputs = torch.func.functional_call(
        self.network, state, self.network_inputs(features, labels),
        self.network_kwargs(mode, generator), strict=True)
    loss, train_outputs = self.model_train_fn(state, features, labels,
                                              outputs, mode)
    return loss, (train_outputs, outputs, new_model_state)

  def frame_shard(self):
    """The frames of every episode that this rank holds (a
    ``data.input_generators.FrameShard``), for a model whose inputs are
    episodes of frames shared out over ``process_group``; None: the whole
    batch."""
    return None

  def shard_batch(self, arrays):
    """This rank's share (``frame_shard``) of a batch of whole episodes."""
    shard = self.frame_shard()
    if arrays is None or shard is None:
      return arrays
    return shard.cut(arrays)

  def gradients(self, state: TrainState, features, labels,
                generator: Optional[torch.Generator] = None):
    """(loss, scalar train outputs, new_model_state, grads) of one TRAIN
    forward and backward, all detached; with a ``process_group``, the
    gradients summed over it."""
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    with torch.enable_grad():
      loss, (train_outputs, _, new_model_state) = self.loss_fn(
          params, state.model_state, features, labels, ModeKeys.TRAIN,
          generator)
      grads = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
    # A parameter the loss does not reach (the stem bias in training) has
    # gradient 0, as jax.grad gives it.
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(params, grads)}
    if collectives.world_size(self.process_group) > 1:
      flat = collectives.all_reduce_sum(
          torch.cat([g.reshape(-1) for g in grads.values()]),
          self.process_group)
      grads = dict(zip(grads, (part.view_as(g) for part, g in zip(
          flat.split([g.numel() for g in grads.values()]),
          grads.values()))))
    return loss.detach(), _scalars(train_outputs), new_model_state, grads

  def train_step(self, state: TrainState, features, labels,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step: loss and gradients, optimizer, EMA. Returns the new state
    (new tensors; ``state`` is left as it was) and the scalar metrics
    (``loss`` and the model's train outputs), on the device.
    ``generator``: the step's draws in the network (dropout)."""
    loss, train_outputs, new_model_state, grads = self.gradients(
        state, features, labels, generator)
    params = {k: v.detach() for k, v in state.params.items()}
    new_params, opt_state = self.create_optimizer().update(
        grads, state.opt_state, params)
    avg_params, ema_state = state.avg_params, state.ema_state
    if self.use_avg_model_params:
      avg_params, ema_state = optimizers.create_ema(
          self.avg_model_params_decay).update(new_params, state.ema_state)
    metrics = {'loss': loss, **train_outputs}
    return TrainState(step=state.step + 1, params=new_params,
                      model_state=new_model_state, opt_state=opt_state,
                      avg_params=avg_params, ema_state=ema_state), metrics

  def eval_step(self, state: TrainState, features,
                labels) -> Dict[str, torch.Tensor]:
    """Eval metrics of one preprocessed batch, on the served weights."""
    variables = self.select_params(state.variables())
    with torch.no_grad():
      outputs = torch.func.functional_call(
          self.network, variables, self.network_inputs(features, labels),
          {'mode': ModeKeys.EVAL}, strict=True)
      return self.model_eval_fn(variables, features, labels, outputs,
                                ModeKeys.EVAL)
