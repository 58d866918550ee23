"""The MAML inner loop: gradient-descent adaptation of a state dict (the
JAX package's ``meta_learning/maml_inner_loop.py``).

Each adaptation step takes the gradient of the base model's loss on the
condition batch with ``torch.autograd.grad`` and steps the adapted tensors
``value - lr * grad``. For second-order MAML the gradient keeps its graph
(``create_graph``), so that the outer gradient flows through it; first
order detaches the update (JAX's ``stop_gradient``: the outer gradient
then reaches neither the inner gradient nor a learned learning rate).

``var_scope`` names the adapted tensors by a prefix of JAX's '/'-joined
flax path (``state_features/conv2``, as the gins write it); a port name
maps to that path by its dots and a ``weight`` leaf read as flax's
``kernel``. The others are not adapted (the outer loop still trains them).
Learned per-tensor learning rates (``learn_inner_lr``) are given as a dict
of scalars by name, trained by the outer step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ['MAMLInnerLoopGradientDescent', 'flax_path']

Tensors = Dict[str, torch.Tensor]


def flax_path(name: str) -> str:
  """A port state-dict name as JAX's '/'-joined flax path:
  ``pose_net.Dense_0.weight`` -> ``pose_net/Dense_0/kernel``."""
  parts = name.split('.')
  if parts[-1] == 'weight':
    parts[-1] = 'kernel'
  return '/'.join(parts)


class MAMLInnerLoopGradientDescent:
  """The inner loop's SGD (JAX's ``MAMLInnerLoopGradientDescent``)."""

  def __init__(self, learning_rate: float = 0.001,
               use_second_order: bool = True,
               var_scope: Optional[str] = None,
               learn_inner_lr: bool = False):
    """Args:
      learning_rate: the inner step size (the learned rates' initial value
        with ``learn_inner_lr``).
      use_second_order: differentiate through the inner gradients; False
        detaches the update (first-order MAML).
      var_scope: a flax path prefix; only matching tensors adapt.
      learn_inner_lr: one learned inner rate a parameter tensor.
    """
    self._learning_rate = learning_rate
    self._use_second_order = use_second_order
    self._var_scope = var_scope
    self._learn_inner_lr = learn_inner_lr

  @property
  def learn_inner_lr(self) -> bool:
    return self._learn_inner_lr

  def adapts(self, name: str) -> bool:
    """Whether the parameter ``name`` adapts in the inner loop."""
    return (self._var_scope is None or
            flax_path(name).startswith(self._var_scope))

  def create_inner_lr_params(self, params: Tensors) -> Tensors:
    """A learned rate a parameter, at ``learning_rate``."""
    return {name: torch.tensor(self._learning_rate, dtype=torch.float32,
                               device=value.device)
            for name, value in params.items()}

  def adapt(self, params: Tensors, grads: Sequence[Optional[torch.Tensor]],
            inner_lrs: Optional[Tensors] = None) -> Tensors:
    """One SGD step over ``params`` (``grads`` in their order)."""
    out = {}
    for (name, value), grad in zip(params.items(), grads):
      if not self.adapts(name) or grad is None:
        out[name] = value
        continue
      lr = self._learning_rate if inner_lrs is None else inner_lrs[name]
      update = lr * grad
      if not self._use_second_order:
        update = update.detach()
      out[name] = value - update
    return out

  def inner_loop(self, params: Tensors, model_state: Tensors,
                 inputs_list: Sequence[Tuple[Any, Any]],
                 forward_fn: Callable, loss_fn: Callable,
                 inner_lrs: Optional[Tensors] = None):
    """k adaptation steps, then the conditioned and unconditioned passes.

    Args:
      params: the base network's parameters (their adapted copies are
        derived; their gradients flow to the outer step).
      model_state: its buffers (batch norm statistics), updated in place
        by every TRAIN forward, as JAX threads ``new_state`` through them.
      inputs_list: ((cond features, cond labels),) * k + ((val features,
        val labels),): a gradient step an entry but the last.
      forward_fn: ``(state, features) -> outputs`` of the base network.
      loss_fn: ``(state, features, labels, outputs) -> (loss, _)``.
      inner_lrs: learned rates by parameter name, or None.

    Returns:
      ([unconditioned, conditioned], inner_outputs (k + 1), inner_losses
      (k + 1)): as JAX's, the last inner entry a monitoring forward on the
      last condition batch after adaptation (no step).
    """
    current = dict(params)

    def loss_of(p, features, labels):
      state = {**p, **model_state}
      outputs = forward_fn(state, features)
      loss, _ = loss_fn(state, features, labels, outputs)
      return loss, outputs

    inner_outputs: List[Any] = []
    inner_losses: List[torch.Tensor] = []
    create_graph = self._use_second_order and torch.is_grad_enabled()
    for features, labels in inputs_list[:-1]:
      with torch.enable_grad():
        leaves = {k: v if v.requires_grad else v.detach().requires_grad_()
                  for k, v in current.items()}
        loss, outputs = loss_of(leaves, features, labels)
        names = [k for k in leaves if self.adapts(k)]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], create_graph=create_graph,
            allow_unused=True))) if names else {}
      if not torch.is_grad_enabled():
        # Eval and predict: nothing differentiates the adaptation.
        grads = {k: None if g is None else g.detach()
                 for k, g in grads.items()}
        loss, outputs = loss.detach(), {k: v.detach()
                                        for k, v in outputs.items()}
      inner_outputs.append(outputs)
      inner_losses.append(loss)
      current = self.adapt(current, [grads.get(k) for k in current],
                           inner_lrs)

    final_features, final_labels = inputs_list[-2]
    final_loss, final_outputs = loss_of(current, final_features,
                                        final_labels)
    inner_outputs.append(final_outputs)
    inner_losses.append(final_loss)
    val_features, _ = inputs_list[-1]
    conditioned = forward_fn({**current, **model_state}, val_features)
    # The unconditioned diagnostic pass updates no statistics.
    unconditioned = forward_fn(
        {**params, **{k: v.clone() for k, v in model_state.items()}},
        val_features)
    return [unconditioned, conditioned], inner_outputs, inner_losses
