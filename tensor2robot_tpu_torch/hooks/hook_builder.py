"""The hook protocol and the builder interface (the JAX package's
``hooks/hook_builder.py``).

Hooks are plain objects the trainer calls around its step loop:

  begin(trainer)                               once, before the first step
  after_step(trainer, state, step, metrics)    after every step (metrics on
                                               the device)
  end(trainer, state)                          once, after the last step
"""

from __future__ import annotations

from typing import Any, List, Optional

__all__ = ['HookBuilder', 'TrainHook']


class TrainHook:
  """A hook that does nothing; subclasses override what they need."""

  def begin(self, trainer) -> None:
    pass

  def after_step(self, trainer, state, step: int,
                 metrics: Optional[Any]) -> None:
    pass

  def end(self, trainer, state) -> None:
    pass


class HookBuilder:
  """Makes hooks bound to a model and a trainer."""

  def create_hooks(self, t2r_model, trainer) -> List[TrainHook]:
    raise NotImplementedError
