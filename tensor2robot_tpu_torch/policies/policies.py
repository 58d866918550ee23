"""Policies that select robot actions through a predictor.

The counterparts of the JAX package's ``policies/policies.py``: ``Policy``,
``CEMPolicy`` (the CEM loop on the host, a predict an iteration),
``DeviceCEMPolicy`` (the whole CEM on the critic's device, one call an
action), ``LSTMCEMPolicy``, ``RegressionPolicy``,
``SequentialRegressionPolicy``, the exploring regression policies
``OUExploreRegressionPolicy`` and ``ScheduledExplorationRegressionPolicy``,
and ``PerEpisodeSwitchPolicy``. Every concrete policy's own
``SelectAction`` is timed into the histogram ``policy/select_action_ms``,
labelled with the policy's class, as in the JAX package: at robot control
rates its tail is what the robot feels.

Where the JAX policies draw from numpy's global generator, ``CEMPolicy``
does too (one ``np.random.seed`` gives both packages the same draws); the
others draw from a generator of their own: a ``RandomState(seed)``, whose
draws are those of the global generator after ``np.random.seed(seed)``,
or, for ``DeviceCEMPolicy``, the device generator that its seed stream
seeds for each action.
"""

from __future__ import annotations

import abc
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    get_registry,
)
from tensor2robot_tpu_torch.utils import cross_entropy

__all__ = ['CEMPolicy', 'DeviceCEMPolicy', 'LSTMCEMPolicy',
           'OUExploreRegressionPolicy', 'POLICY_LATENCY_HISTOGRAM',
           'PerEpisodeSwitchPolicy', 'Policy', 'RegressionPolicy',
           'ScheduledExplorationRegressionPolicy',
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


class DeviceCEMPolicy(Policy):
  """The CEM argmax with the whole loop on the critic's device: one call of
  the model's ``make_on_device_select_action`` an action, on the
  predictor's loaded variables.

  Each action's device generator is seeded from the policy's own seed
  stream (a CPU generator seeded with ``seed``), as the JAX policy splits
  its key an action.
  """

  def __init__(self,
               t2r_model,
               cem_iters: int = 3,
               cem_samples: int = 64,
               num_elites: int = 10,
               seed: int = 0,
               **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._t2r_model = t2r_model
    self._seeds = torch.Generator().manual_seed(int(seed))
    self._select = t2r_model.make_on_device_select_action(
        cem_samples=cem_samples, cem_iters=cem_iters, num_elites=num_elites)

  def _select_action(self, state):
    seed = int(torch.randint(0, 1 << 62, (), generator=self._seeds))
    return self._select(self._predictor.variables, dict(state), seed)

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    del context, timestep
    action, _ = self._select_action(state)
    return action.cpu().numpy()

  def sample_action(self, obs, explore_prob):
    """The ``(action, debug)`` adapter, ``debug['q']`` the action's Q."""
    del explore_prob
    action, q = self._select_action(obs)
    return action.cpu().numpy(), {'q': float(q)}


class LSTMCEMPolicy(CEMPolicy):
  """``CEMPolicy`` that carries the critic's LSTM hidden state across an
  episode's steps: the predictor returns a hidden state for every
  candidate, and the chosen one's is the next step's.

  The samples are drawn from the policy's own ``RandomState(seed)``.
  """

  def __init__(self, hidden_state_size: int, seed: Optional[int] = None,
               **kwargs):
    self._hidden_state_size = hidden_state_size
    super().__init__(**kwargs)
    self._rng = np.random.RandomState(seed)
    self.sample_fn = self._own_sample_fn
    self.reset()

  def _own_sample_fn(self, mean, stddev):
    return mean + stddev * self._rng.standard_normal(
        (self._cem_samples, self._action_size))

  def reset(self) -> None:
    self._hidden_state = np.zeros((self._hidden_state_size,), np.float32)

  def _select_action_with_debug(self, state, context, timestep):
    del context  # the hidden state takes the context's place in pack_fn

    def objective_fn(samples):
      np_inputs = self.pack_fn(self._t2r_model, state, self._hidden_state,
                               timestep, samples)
      predictions = self._predictor.predict(np_inputs)
      self._hidden_state_batch = predictions['lstm_hidden_state']
      return predictions['q_predicted']

    action, debug = self.get_cem_action(objective_fn)
    self._hidden_state = self._hidden_state_batch[debug['best_idx']]
    return action, debug


class OUExploreRegressionPolicy(Policy):
  """The regressed action plus Ornstein-Uhlenbeck noise
  (``dx = theta (mu - x) + sigma N(0, 1)``, reset each episode), drawn
  from the policy's own ``RandomState(seed)``."""

  def __init__(self,
               t2r_model,
               action_size: int = 2,
               theta: float = 0.2,
               sigma: float = 0.15,
               use_noise: bool = True,
               seed: Optional[int] = None,
               **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._t2r_model = t2r_model
    self.theta, self.sigma, self.mu = theta, sigma, 0.0
    self._action_size = action_size
    self._x_t = np.zeros(action_size)
    self._use_noise = use_noise
    self._rng = np.random.RandomState(seed)

  def ou_step(self):
    dx_t = (self.theta * (self.mu - self._x_t) +
            self.sigma * self._rng.randn(*self._x_t.shape))
    self._x_t = self._x_t + dx_t
    return self._x_t

  def reset(self) -> None:
    self._x_t = np.zeros(self._action_size)

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    np_inputs = self._t2r_model.pack_features(state, context, timestep)
    action = self._predictor.predict(np_inputs)['inference_output'][0]
    noise = self.ou_step() if self._use_noise else 0
    return action + noise


class ScheduledExplorationRegressionPolicy(Policy):
  """The regressed action plus Gaussian noise whose stddev falls linearly
  with the predictor's global step (``max(stddev_0 + step * slope, 0)``),
  drawn from the policy's own ``RandomState(seed)``."""

  def __init__(self,
               t2r_model,
               action_size: int = 2,
               stddev_0: float = 0.2,
               slope: float = 0.0,
               seed: Optional[int] = None,
               **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._t2r_model = t2r_model
    self._action_size = action_size
    self._stddev_0 = stddev_0
    self._slope = slope
    self._rng = np.random.RandomState(seed)

  def get_noise(self):
    stddev = max(self._stddev_0 + self.global_step * self._slope, 0)
    return stddev * self._rng.randn(self._action_size)

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    np_inputs = self._t2r_model.pack_features(state, context, timestep)
    action = self._predictor.predict(np_inputs)['inference_output'][0]
    return action + self.get_noise()


class PerEpisodeSwitchPolicy(Policy):
  """Picks the explore or the greedy sub-policy once an episode, the
  explore one with ``explore_prob``, drawn from the policy's own
  ``RandomState(seed)``."""

  def __init__(self, explore_policy_class, greedy_policy_class,
               explore_prob: float, seed: Optional[int] = None,
               **parent_kwargs):
    super().__init__(**parent_kwargs)
    self._explore_policy = explore_policy_class()
    self._greedy_policy = greedy_policy_class()
    self._explore_prob = explore_prob
    self._active_policy = None
    self._rng = np.random.RandomState(seed)

  def reset(self) -> None:
    self._explore_policy.reset()
    self._greedy_policy.reset()
    if self._rng.random_sample() < self._explore_prob:
      self._active_policy = self._explore_policy
    else:
      self._active_policy = self._greedy_policy

  def init_randomly(self) -> None:
    self._explore_policy.init_randomly()
    self._greedy_policy.init_randomly()

  def restore(self):
    explore_ok = self._explore_policy.restore()
    greedy_ok = self._greedy_policy.restore()
    return (explore_ok is not False) and (greedy_ok is not False)

  @property
  def global_step(self) -> int:
    """The greedy policy's step."""
    return self._greedy_policy.global_step

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    if self._active_policy is None:
      self.reset()
    return self._active_policy.SelectAction(state, context, timestep)
