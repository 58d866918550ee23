"""CriticModel: Q(state, action), inference half (the JAX package's
``models/critic_model.py``)."""

from __future__ import annotations

from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel

__all__ = ['CriticModel']


class CriticModel(AbstractT2RModel):
  """A network producing ``outputs['q_predicted']`` for state + action."""

  q_key = 'q_predicted'
  reward_key = 'reward'
