"""Policies that select robot actions through a predictor.

The counterparts of the JAX package's ``policies/policies.py`` ``Policy``,
``RegressionPolicy`` and ``SequentialRegressionPolicy``. Every concrete
policy's own ``SelectAction`` is timed into the histogram
``policy/select_action_ms``, labelled with the policy's class, as in the JAX
package: at robot control rates its tail is what the robot feels. (The CEM
policies of that module are served here by ``serving.PolicyServer``.)
"""

from __future__ import annotations

import abc
import functools
import time

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    get_registry,
)

__all__ = ['POLICY_LATENCY_HISTOGRAM', 'Policy', 'RegressionPolicy',
           'SequentialRegressionPolicy']

POLICY_LATENCY_HISTOGRAM = 'policy/select_action_ms'


def _instrument_select_action(fn):

  @functools.wraps(fn)
  def wrapper(self, state, context, timestep):
    start = time.perf_counter()
    action = fn(self, state, context, timestep)
    get_registry().histogram_family(
        POLICY_LATENCY_HISTOGRAM, ('policy',),
        bounds=DEFAULT_LATENCY_BUCKETS_MS).series(
            type(self).__name__).record((time.perf_counter() - start) * 1e3)
    return action

  wrapper._t2r_instrumented = True  # noqa: SLF001 — idempotence marker
  return wrapper


class Policy(abc.ABC):
  """A policy backed by an optional predictor."""

  def __init_subclass__(cls, **kwargs):
    super().__init_subclass__(**kwargs)
    fn = cls.__dict__.get('SelectAction')
    if fn is not None and callable(fn) and not getattr(
        fn, '_t2r_instrumented', False):
      cls.SelectAction = _instrument_select_action(fn)

  def __init__(self, predictor=None):
    self._predictor = predictor

  @abc.abstractmethod
  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    """The action for the observed ``state``; ``timestep`` counts the
    episode's steps from 0. Leaves ``state`` and ``context`` as they are."""

  def reset(self) -> None:
    """Called at episode boundaries."""

  def init_randomly(self) -> None:
    if self._predictor is not None:
      self._predictor.init_randomly()

  def restore(self):
    """The predictor's success bool (True when there is nothing to
    restore)."""
    if self._predictor is not None:
      return self._predictor.restore()
    return True

  @property
  def model_path(self) -> str:
    if self._predictor is not None:
      return self._predictor.model_path
    return 'No model path defined.'

  @property
  def global_step(self) -> int:
    if self._predictor is not None:
      return self._predictor.global_step
    return 0

  def sample_action(self, obs, explore_prob):
    """The ``(action, debug)`` adapter of environment runners."""
    del explore_prob
    return self.SelectAction(obs, None, None), None


class RegressionPolicy(Policy):
  """The model's ``inference_output`` for the packed state."""

  def __init__(self, t2r_model, **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._t2r_model = t2r_model

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    np_inputs = self._t2r_model.pack_features(state, context, timestep)
    return self._predictor.predict(np_inputs)['inference_output'][0]


class SequentialRegressionPolicy(RegressionPolicy):
  """Feeds each call's packed input back as the next call's context (the
  rolling episode window of ``Seq2ActBCModel.pack_features``)."""

  def __init__(self, t2r_model, **parent_kwargs):
    super().__init__(t2r_model, **parent_kwargs)
    self._sequence_context = None

  def reset(self) -> None:
    self._sequence_context = None

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    np_inputs = self._t2r_model.pack_features(
        state, self._sequence_context, timestep)
    self._sequence_context = np_inputs
    return self._predictor.predict(np_inputs)['inference_output'][0]
