"""The port's DeviceCEMPolicy, LSTMCEMPolicy and exploring policies against
the JAX package's, on the CPU.

The exploring policies draw from a ``RandomState(seed)`` of their own in
the port and from numpy's global generator in JAX: after
``np.random.seed(seed)`` the two give the same draws, so the actions must
be equal. DeviceCEMPolicy's CEM noise comes from a torch generator in the
port and from ``jax.random`` in JAX: the port's policy is given JAX's noise
for the comparison, and its flagship critic (num_convs (1, 1, 1), weights
at fan-in scale, logits shrunk out of the sigmoid's saturation) runs
float32 on both sides, so its action and q are held within 1e-5, as the
batched selector's are (``test_torch_qtopt.py``).
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.policies import policies
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor)
from tensor2robot_tpu_torch.research.qtopt import grasping_sim
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.rl import run_env as run_env_lib

_CRITIC = 'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom'
SAMPLES, ITERS, ELITES = 8, 2, 3


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture('policies.policies',
                               'research.qtopt.t2r_models')


def _draw(tree, rng):
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      out[key] = _draw(value, rng)
      continue
    shape = np.shape(value)
    if key == 'kernel':
      draw = rng.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[:-1])))
    elif key == 'var':
      draw = rng.uniform(0.5, 1.5, shape)
    elif key == 'scale':
      draw = 1.0 + 0.1 * rng.randn(*shape)
    else:
      draw = 0.1 * rng.randn(*shape)
    out[key] = draw.astype(np.float32)
  return out


def _jax_noise(key):
  return np.stack([np.asarray(jax.random.normal(k, (SAMPLES, 8)))
                   for k in jax.random.split(key, ITERS)])


def _observation(seed):
  env = grasping_sim.SimGraspingEnv(seed=seed)
  return env.reset()


def test_device_cem_policy_matches_jax(ref):
  jax_model = getattr(ref.t2r_models, _CRITIC)(
      device_type='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  init = {'state/image': np.zeros((1, 472, 472, 3), np.float32)}
  for key, size in grasping_sim.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    init['action/' + key] = np.zeros((1, size), np.float32)
  shapes = jax.tree_util.tree_map(np.asarray, jax_model.create_network().init(
      jax.random.PRNGKey(0), init, mode='predict', train=False))
  rng = np.random.RandomState(3)
  variables = {'params': _draw(shapes['params'], rng),
               'batch_stats': _draw(shapes['batch_stats'], rng)}
  variables['params']['grasping44']['logit']['kernel'] *= 0.1
  jax_policy = ref.policies.DeviceCEMPolicy(
      jax_model, cem_iters=ITERS, cem_samples=SAMPLES, num_elites=ELITES,
      seed=4, predictor=types.SimpleNamespace(variables=variables))

  model = getattr(t2r_models, _CRITIC)(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  port_variables = {k: model.to_device(v)
                    for k, v in convert.from_flax(variables).items()}
  policy = policies.DeviceCEMPolicy(
      model, cem_iters=ITERS, cem_samples=SAMPLES, num_elites=ELITES, seed=4,
      predictor=types.SimpleNamespace(variables=port_variables))
  select = policy._select
  keys = jax.random.PRNGKey(4)
  for seed in (1, 2):
    obs = _observation(seed)
    keys, step_key = jax.random.split(keys)
    noise = _jax_noise(step_key)
    policy._select = lambda v, s, _, noise=noise: select(v, s, 0, noise=noise)
    got, got_debug = policy.sample_action(obs, 0.0)
    want, want_debug = jax_policy.sample_action(obs, 0.0)
    assert got.shape == (8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got_debug['q'] - want_debug['q']) <= 1e-5
  # SelectAction gives the action alone.
  obs = _observation(5)
  keys, step_key = jax.random.split(keys)
  noise = _jax_noise(step_key)
  policy._select = lambda v, s, _, noise=noise: select(v, s, 0, noise=noise)
  np.testing.assert_allclose(policy.SelectAction(obs, None, 0),
                             jax_policy.SelectAction(obs, None, 0), atol=1e-5)


def test_device_cem_policy_draws_from_its_seed_stream(tmp_path):
  """Each action's CEM is the model's selector at the next seed of the
  policy's own stream: the same seed, the same actions; another, others.
  Through run_env it reports each step's Q."""
  model = getattr(t2r_models, _CRITIC)(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})

  def make(seed):
    predictor = CheckpointPredictor(model)
    policy = policies.DeviceCEMPolicy(model, cem_iters=ITERS,
                                      cem_samples=SAMPLES,
                                      num_elites=ELITES, seed=seed,
                                      predictor=predictor)
    policy.init_randomly()
    return policy, predictor

  policy, predictor = make(0)
  obs = _observation(1)
  seeds = torch.Generator().manual_seed(0)
  expected = int(torch.randint(0, 1 << 62, (), generator=seeds))
  action, debug = policy.sample_action(obs, 0.0)
  want_action, want_q = model.make_on_device_select_action(
      SAMPLES, ITERS, ELITES)(predictor.variables, obs, expected)
  np.testing.assert_array_equal(action, want_action.numpy())
  assert debug['q'] == float(want_q)
  second, _ = policy.sample_action(obs, 0.0)
  again, _ = make(0)[0].sample_action(obs, 0.0)
  other, _ = make(1)[0].sample_action(obs, 0.0)
  np.testing.assert_array_equal(again, action)
  assert not np.array_equal(second, action)
  assert not np.array_equal(other, action)

  rewards = run_env_lib.run_env(
      grasping_sim.SimGraspingEnv(seed=2), policy=make(0)[0],
      num_episodes=2, root_dir=str(tmp_path), tag='eval')
  assert len(rewards) == 2
  with open(os.path.join(str(tmp_path), 'live_eval_0',
                         'metrics-eval.jsonl')) as f:
    values = json.loads(f.read())['values']
  assert 'Q/0' in values and 0.0 < values['Q/0'] < 1.0


class _Model:
  """pack_features of a regression model: the state as is."""

  @staticmethod
  def pack_features(state, context, timestep):
    del context, timestep
    return {'state': np.asarray(state)}


class _Regression:
  global_step = 40

  def predict(self, features):
    return {'inference_output': np.asarray([features['state'] * 0.5])}


@pytest.mark.parametrize('name,kwargs', [
    ('OUExploreRegressionPolicy', {'action_size': 3, 'theta': 0.3,
                                   'sigma': 0.2}),
    ('ScheduledExplorationRegressionPolicy', {'action_size': 3,
                                              'stddev_0': 0.3,
                                              'slope': -0.002}),
])
def test_exploring_regression_policies_match_jax(ref, name, kwargs):
  states = np.random.RandomState(0).randn(6, 3).astype(np.float32)

  def actions(policy):
    out = []
    for episode in range(2):
      policy.reset()
      out.extend(policy.SelectAction(s, None, t)
                 for t, s in enumerate(states[3 * episode:3 * episode + 3]))
    return np.stack(out)

  np.random.seed(11)
  want = actions(getattr(ref.policies, name)(
      _Model(), predictor=_Regression(), **kwargs))
  got = actions(getattr(policies, name)(
      _Model(), predictor=_Regression(), seed=11, **kwargs))
  np.testing.assert_array_equal(got, want)
  assert not np.allclose(got, np.stack([s * 0.5 for s in states]))


class _Switchable(policies.Policy):

  def __init__(self, tag):
    super().__init__()
    self.tag = tag
    self.resets = 0

  def reset(self):
    self.resets += 1

  def SelectAction(self, state, context, timestep):  # pylint: disable=invalid-name
    return self.tag


def test_per_episode_switch_policy_matches_jax(ref):
  def choices(module, **seed):
    policy = module.PerEpisodeSwitchPolicy(
        lambda: _Switchable('explore'), lambda: _Switchable('greedy'),
        explore_prob=0.3, **seed)
    out = []
    for _ in range(40):
      policy.reset()
      out.append(policy.SelectAction(None, None, 0))
    return out, policy

  np.random.seed(7)
  want, _ = choices(ref.policies)
  got, policy = choices(policies, seed=7)
  assert got == want and {'explore', 'greedy'} == set(got)
  assert policy.global_step == 0 and policy.restore()


class _LSTMPredictor:
  """q of each candidate, and a hidden state a candidate."""

  def predict(self, features):
    actions = features['actions']
    hidden = features['hidden']
    q = -((actions - np.asarray([0.3, -0.6])) ** 2).sum(-1) + hidden.sum()
    return {'q_predicted': q,
            'lstm_hidden_state': actions[:, :1] + hidden[None, :1]}


def _lstm_pack(t2r_model, state, hidden, timestep, samples):
  del t2r_model, state, timestep
  return {'actions': np.asarray(samples, np.float32),
          'hidden': np.asarray(hidden, np.float32)}


def test_lstm_cem_policy_matches_jax(ref):
  def run(module, **seed):
    policy = module.LSTMCEMPolicy(
        hidden_state_size=1, t2r_model=None, action_size=2, cem_iters=3,
        cem_samples=16, num_elites=4, pack_fn=_lstm_pack,
        predictor=_LSTMPredictor(), **seed)
    out = [policy.SelectAction(None, None, t) for t in range(3)]
    return np.stack(out), policy._hidden_state

  np.random.seed(3)
  want, want_hidden = run(ref.policies)
  got, got_hidden = run(policies, seed=3)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got_hidden, want_hidden)
  assert float(np.abs(got_hidden).max()) > 0
