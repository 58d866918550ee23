"""AbstractT2RModel, inference half: network, random init, predict forward.

The counterpart of the JAX package's ``models/abstract_model.py`` for
serving. A model holds configuration and one network module on its device;
the weights live outside it, in a ``variables`` dict that the server can
swap atomically:

  ``{'params': {name: tensor}, 'avg_params': {name: tensor}}``

Each entry is a full state dict of the network (parameters and the batch
norm statistics, which flax keeps apart under ``batch_stats``);
``avg_params`` is the EMA of the weights and is present when the model
averages them. ``convert.from_flax`` builds this dict from a JAX state.
The network runs on these tensors through ``torch.func.functional_call``.

As in the JAX package, activations are bfloat16 only where
``device_type == 'tpu'``; the port serves float32 on the GPU unless
``compute_dtype`` asks for bfloat16.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.modes import ModeKeys

__all__ = ['AbstractT2RModel', 'Variables']

StateDict = Dict[str, torch.Tensor]
Variables = Dict[str, StateDict]

# jax.nn.initializers.truncated_normal divides by the std of a unit normal
# truncated to [-2, 2], so that the kept draws have the requested std.
_TRUNCATED_STD = 0.87962566103423978


def _init_module(module: nn.Module, generator: torch.Generator) -> None:
  """flax's initializers: truncated normal (std 0.01) kernels, zero
  biases; batch norm scale 1, bias 0, mean 0, var 1."""
  for name, param in module.named_parameters(recurse=False):
    if name == 'weight':
      nn.init.trunc_normal_(param, 0.0, 1.0, -2.0, 2.0, generator=generator)
      param.mul_(0.01 / _TRUNCATED_STD)
    elif name == 'scale':
      nn.init.ones_(param)
    else:
      nn.init.zeros_(param)
  for name, buffer in module.named_buffers(recurse=False):
    (nn.init.ones_ if name == 'var' else nn.init.zeros_)(buffer)


class AbstractT2RModel:
  """Base model: one network on one device, and its inference function."""

  def __init__(self,
               preprocessor_cls: Optional[Callable[[], object]] = None,
               device='cuda',
               device_type: str = 'gpu',
               use_avg_model_params: bool = False,
               compute_dtype: Optional[torch.dtype] = None):
    """Args:
      preprocessor_cls: zero-arg factory of the model's preprocessor.
      device: where the network runs (``'cpu'`` only when asked for).
      device_type: 'cpu' | 'gpu' | 'tpu'; picks the default compute dtype.
      use_avg_model_params: serve ``avg_params`` when present.
      compute_dtype: activations dtype of networks that honor it.
    """
    self.device = torch.device(device)
    self._preprocessor_cls = preprocessor_cls
    self._preprocessor = None
    self.use_avg_model_params = use_avg_model_params
    if compute_dtype is None:
      compute_dtype = (torch.bfloat16 if device_type == 'tpu'
                       else torch.float32)
    self.compute_dtype = compute_dtype
    self._network: Optional[nn.Module] = None

  @property
  def preprocessor(self):
    if self._preprocessor is None:
      if self._preprocessor_cls is None:
        raise NotImplementedError('{} has no preprocessor.'.format(
            type(self).__name__))
      self._preprocessor = self._preprocessor_cls()
    return self._preprocessor

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
    """The predict-mode forward of the network on ``variables``."""
    if mode == ModeKeys.TRAIN:
      raise NotImplementedError('Training comes with the training slice.')
    return torch.func.functional_call(
        self.network, self.select_params(variables), (features,),
        {'mode': mode}, strict=True)
