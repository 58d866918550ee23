"""CriticModel: Q(state, action) (the JAX package's
``models/critic_model.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel

__all__ = ['CriticModel', 'sigmoid_binary_cross_entropy']


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
  """optax's elementwise form: ``-y log sigmoid(z) - (1 - y) log
  sigmoid(-z)``."""
  return (-labels * F.logsigmoid(logits) -
          (1.0 - labels) * F.logsigmoid(-logits))


class CriticModel(AbstractT2RModel):
  """A network producing ``outputs['q_predicted']`` for state + action.

  The feature specification is the state's keys under ``state/`` and the
  action's under ``action/``. ``action_batch_size`` is the number of
  candidate actions a predict call scores against each state, where the
  network wants its state rows repeated to match (None: the network takes
  B states and B*K action rows itself, as Grasping44's megabatch does).
  """

  q_key = 'q_predicted'
  reward_key = 'reward'

  def __init__(self, action_batch_size: Optional[int] = None, **kwargs):
    super().__init__(**kwargs)
    self._action_batch_size = action_batch_size

  def tile_state_for_action_batch(self, features):
    """State rows [B, ...] repeated to [B*action_batch_size, ...], each
    state's copies next to each other (row b*K + j is state b with its j-th
    action); the features as they are where ``action_batch_size`` is
    None."""
    if self._action_batch_size is None:
      return features
    return {key: (value.repeat_interleave(self._action_batch_size, dim=0)
                  if key.startswith('state/') else value)
            for key, value in features.items()}

  def get_state_specification(self) -> Dict[str, tuple]:
    raise NotImplementedError

  def get_action_specification(self) -> Dict[str, tuple]:
    raise NotImplementedError

  def get_feature_specification(self, mode: str) -> Dict[str, tuple]:
    del mode
    spec = {'state/' + k: v for k, v in self.get_state_specification().items()}
    spec.update({'action/' + k: v
                 for k, v in self.get_action_specification().items()})
    return spec

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """Mean sigmoid cross entropy of the logit against the reward in
    [0, 1]."""
    q_predicted = inference_outputs[self.q_key]
    targets = labels[self.reward_key].to(q_predicted.dtype).reshape(
        q_predicted.shape)
    loss = sigmoid_binary_cross_entropy(self.logit_of(inference_outputs),
                                        targets).mean()
    return loss, {}

  def logit_of(self, inference_outputs) -> torch.Tensor:
    """The network's logits, or the logit of its clipped q."""
    if 'q_logits' in inference_outputs:
      return inference_outputs['q_logits']
    q = inference_outputs[self.q_key].clamp(1e-6, 1 - 1e-6)
    return torch.log(q) - torch.log1p(-q)
