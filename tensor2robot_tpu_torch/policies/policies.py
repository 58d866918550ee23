"""Policies that select robot actions through a predictor.

The counterparts of the JAX package's ``policies/policies.py`` ``Policy``,
``CEMPolicy``, ``RegressionPolicy`` and ``SequentialRegressionPolicy``.
Every concrete policy's own ``SelectAction`` is timed into the histogram
``policy/select_action_ms``, labelled with the policy's class, as in the JAX
package: at robot control rates its tail is what the robot feels. (The
device-side CEM of that module's ``DeviceCEMPolicy`` is served here by
``serving.PolicyServer`` over the model's batched selector.)
"""

from __future__ import annotations

import abc
import functools
import time
from typing import Callable, Optional

import numpy as np

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    get_registry,
)
from tensor2robot_tpu_torch.utils import cross_entropy

__all__ = ['CEMPolicy', 'POLICY_LATENCY_HISTOGRAM', 'Policy',
           'RegressionPolicy', 'SequentialRegressionPolicy']

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


class CEMPolicy(Policy):
  """The CEM argmax of a critic's Q, through a predictor.

  Each of ``cem_iters`` iterations draws ``cem_samples`` actions of
  ``action_size`` from N(mean, std) with numpy's global generator (as the
  JAX policy does, so one ``np.random.seed`` gives both the same draws),
  packs them with the state (``pack_fn``, by default the model's
  ``pack_features``), scores them in one ``predict`` and refits the mean
  and the sample std (``ddof=1``) to the ``num_elites`` best. The action is
  the best sample of the last iteration.
  """

  def __init__(self, t2r_model, action_size: int = 2, cem_iters: int = 3,
               cem_samples: int = 64, num_elites: int = 10,
               pack_fn: Optional[Callable] = None, **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._cem_iters = cem_iters
    self._cem_samples = cem_samples
    self._action_size = action_size
    self._num_elites = num_elites
    self.sample_fn = self._default_sample_fn
    self.pack_fn = pack_fn if pack_fn is not None else self._default_pack_fn
    self._t2r_model = t2r_model

  def _default_sample_fn(self, mean, stddev):
    return mean + stddev * np.random.standard_normal(
        (self._cem_samples, self._action_size))

  def get_cem_action(self, objective_fn):
    """The CEM argmax of ``objective_fn`` and a debug dict."""

    def update_fn(params, elite_samples):
      del params
      return {'mean': np.mean(elite_samples, axis=0),
              'stddev': np.std(elite_samples, axis=0, ddof=1)}

    samples, values, final_params = cross_entropy.cross_entropy_method(
        self.sample_fn, objective_fn, update_fn,
        {'mean': np.zeros(self._action_size),
         'stddev': np.ones(self._action_size)},
        num_elites=self._num_elites, num_iterations=self._cem_iters)
    idx = int(np.argmax(values))
    return samples[idx], {'q_predicted': values[idx],
                          'final_params': final_params, 'best_idx': idx}

  @staticmethod
  def _default_pack_fn(t2r_model, state, context, timestep, samples):
    return t2r_model.pack_features(state, context, timestep, samples)

  def _select_action_with_debug(self, state, context, timestep):

    def objective_fn(samples):
      return self._predictor.predict(self.pack_fn(
          self._t2r_model, state, context, timestep, samples))['q_predicted']

    return self.get_cem_action(objective_fn)

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    return self._select_action_with_debug(state, context, timestep)[0]

  def sample_action(self, obs, explore_prob):
    """The ``(action, debug)`` adapter, ``debug['q']`` the elite's Q."""
    del explore_prob
    action, debug = self._select_action_with_debug(obs, None, None)
    return action, {'q': debug['q_predicted']}
