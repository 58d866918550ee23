"""Meta-learning policies (the JAX package's ``meta_learning/
meta_policies.py``): a policy that keeps a task's conditioning episodes
(``adapt``), folds them into the meta layout at every action
(``pack_features`` of a MAML model) and forgets them with ``reset_task``.
"""

from __future__ import annotations

import abc

import numpy as np

from tensor2robot_tpu_torch.policies import policies

__all__ = ['MAMLCEMPolicy', 'MAMLRegressionPolicy', 'MetaLearningPolicy',
           'ScheduledExplorationMAMLRegressionPolicy']


def _single_action(action) -> np.ndarray:
  """[task, samples, (T,) action] -> one action."""
  action = np.asarray(action)
  if action.ndim == 4:
    return action[0, 0, 0]
  if action.ndim == 3:
    return action[0, 0]
  raise ValueError('Invalid action rank {}.'.format(action.ndim))


class MetaLearningPolicy(policies.Policy, abc.ABC):
  """A policy that adapts to each task from its collected episodes."""

  def reset_task(self) -> None:
    self._prev_episode_data = None

  def adapt(self, episode_data) -> None:
    """Keeps the conditioning episodes for the actions that follow."""
    self._prev_episode_data = episode_data


class MAMLRegressionPolicy(MetaLearningPolicy, policies.RegressionPolicy):
  """The adapted ``inference_output`` of a MAML regression model."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.reset_task()

  def sample_action(self, obs, explore_prob):
    del explore_prob
    # Replay writers read the is_demo flag when forming meta examples.
    return self.SelectAction(obs, None, None), {'is_demo': False}

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    features = self._t2r_model.pack_features(state, self._prev_episode_data,
                                             timestep)
    return _single_action(
        self._predictor.predict(features)['inference_output'])


class MAMLCEMPolicy(MetaLearningPolicy, policies.CEMPolicy):
  """CEM over an adapted critic; before any adaptation the values are
  zeroed, and CEM keeps its prior."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.reset_task()

  def _select_action_with_debug(self, state, context, timestep):
    key = ('inference_output' if self._prev_episode_data
           else 'condition_output')

    def objective_fn(samples):
      cem_state = np.tile(np.expand_dims(state, 0),
                          [np.shape(samples)[0]] + [1] * np.ndim(state))
      inputs = self.pack_fn(self._t2r_model, cem_state,
                            self._prev_episode_data, timestep, samples)
      q_values = np.asarray(self._predictor.predict(inputs)[key])
      if not self._prev_episode_data:
        q_values = q_values * 0
      return q_values.reshape(np.shape(samples)[0], -1)[:, 0]

    return self.get_cem_action(objective_fn)


class ScheduledExplorationMAMLRegressionPolicy(
    MetaLearningPolicy, policies.ScheduledExplorationRegressionPolicy):
  """``MAMLRegressionPolicy`` plus the scheduled Gaussian noise."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self.reset_task()

  def sample_action(self, obs, explore_prob):
    del explore_prob
    return self.SelectAction(obs, None, None), {'is_demo': False}

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    del context
    features = self._t2r_model.pack_features(state, self._prev_episode_data,
                                             timestep)
    action = _single_action(
        self._predictor.predict(features)['inference_output'])
    return action + self.get_noise()
