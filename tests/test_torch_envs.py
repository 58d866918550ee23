"""The port's VecGraspingEnv against the JAX package's and against the numpy
SimGraspingEnv, on the CPU.

Scenarios are numpy draws on both sides and must be equal. The port draws
its sensor noise and reset heights from a torch generator where JAX draws
from per-slot keys, so the step comparisons pin the state
(``state_for_heights``) and set the noise scale to 0; frames are then
bit-equal. The numpy env computes the gripper's row in float64 and the vector
envs in float32, so the numpy comparison skips heights within a margin of a
row boundary (as the JAX package's own test does).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import envs as port_envs
from tensor2robot_tpu_torch.envs import (ScenarioConfig, VecGraspingEnv,
                                         sample_scenarios)
from tensor2robot_tpu_torch.research.qtopt import grasping_sim

_FLOOR_MARGIN = 0.05


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture('envs.grasping')


def _configs(module):
  return {'fixed': module.ScenarioConfig(noise_scale_range=(0.0, 0.0)),
          'randomized': module.ScenarioConfig(
              num_buckets=6, threshold_range=(0.35, 0.65),
              descent_scale_range=(0.25, 0.45), camera_shift_px=2,
              noise_scale_range=(0.0, 0.0))}


def _pair(ref, n, height, width, config='randomized', seed=3):
  port = VecGraspingEnv(n, height, width, seed=seed, device='cpu',
                        scenario_config=_configs(port_envs)[config])
  jax_env = ref.grasping.VecGraspingEnv(
      n, height, width, seed=seed,
      scenario_config=_configs(ref.grasping)[config])
  return port, jax_env


def _pixel_safe(heights, height):
  # The band the scene is drawn in: 432 rows of the 512x640 camera frame.
  band_h = 432 if height == 512 else height
  block = max(6, band_h // 14)
  span = band_h - 4 * block
  keep = []
  for h in heights:
    frac = min(max(float(h) / grasping_sim.H_MAX, 0.0), 1.0) * span
    if _FLOOR_MARGIN < frac % 1.0 < 1.0 - _FLOOR_MARGIN:
      keep.append(float(np.float32(h)))
  return np.asarray(keep, np.float32)


@pytest.mark.parametrize('name', ['default', 'randomized', 'buckets_3'])
@pytest.mark.parametrize('seed', [0, 5])
def test_scenarios_equal_jax(ref, name, seed):
  make = {'default': lambda m: m.ScenarioConfig(),
          'randomized': lambda m: m.ScenarioConfig.randomized(),
          'buckets_3': lambda m: m.ScenarioConfig.randomized(
              num_buckets=3, camera_shift_px=4)}[name]
  got = sample_scenarios(make(port_envs), 64, seed)
  want = ref.grasping.sample_scenarios(make(ref.grasping), 64, seed)
  assert got._fields == want._fields
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('height,width', [(32, 40), (512, 640)])
def test_render_is_bit_equal_to_jax_and_numpy(ref, height, width):
  heights = np.linspace(0.02, 1.55, 16).astype(np.float32)
  port, jax_env = _pair(ref, 16, height, width)
  got = port.render(heights).numpy()
  np.testing.assert_array_equal(got, np.asarray(jax_env.render(heights)))
  # Against the numpy env: the fixed scenario (no shift) at safe heights.
  safe = _pixel_safe(np.linspace(0.02, 1.55, 40), height)
  assert len(safe) >= 20
  fixed = VecGraspingEnv(len(safe), height, width, device='cpu',
                         scenario_config=ScenarioConfig(
                             noise_scale_range=(0.0, 0.0)))
  frames = fixed.render(safe).numpy()
  numpy_env = grasping_sim.SimGraspingEnv(height=height, width=width,
                                          noise_scale=0.0)
  for i, h in enumerate(safe):
    np.testing.assert_array_equal(frames[i], numpy_env._render(float(h)))


def _actions(kind, n, rng):
  action = np.zeros((n, 8), np.float32)
  if kind == 'close':
    action[:, grasping_sim.CLOSE_INDEX] = 1.0
  elif kind == 'descend':
    action[:, grasping_sim.WV_Z_INDEX] = 1.0
  elif kind == 'ascend':
    action[:, grasping_sim.WV_Z_INDEX] = -1.7
  else:
    action = rng.uniform(-1.5, 1.5, (n, 8)).astype(np.float32)
    action[:, grasping_sim.CLOSE_INDEX] = (rng.rand(n) < 0.4)
  return action


@pytest.mark.parametrize('kind', ['close', 'descend', 'ascend', 'mixed'])
@pytest.mark.parametrize('t0', [0, 2])
def test_steps_equal_jax(ref, kind, t0):
  n = 16
  rng = np.random.RandomState(11)
  heights = rng.uniform(0.05, 1.5, n).astype(np.float32)
  port, jax_env = _pair(ref, n, 48, 64)
  # Keep away from each slot's threshold (float32 on both sides anyway).
  thresholds = port.scenarios.threshold
  heights = np.where(np.abs(heights - thresholds) < 1e-3, heights + 0.01,
                     heights).astype(np.float32)
  action = _actions(kind, n, rng)
  state = port.state_for_heights(heights)
  state = state._replace(t=torch.full((n,), t0, dtype=torch.int32))
  jax_state = jax_env.state_for_heights(heights, jax.random.PRNGKey(0))
  jax_state = jax_state._replace(t=jax.numpy.full((n,), t0,
                                                  jax.numpy.int32))
  got = port.step(state, action)
  want = jax_env.step(jax_state, action)
  done = np.array(want.done)
  np.testing.assert_array_equal(got.done.numpy(), done)
  for key in ('terminal', 'timeout'):
    np.testing.assert_array_equal(got.info[key].numpy(),
                                  np.asarray(want.info[key]))
  np.testing.assert_array_equal(got.reward.numpy(), np.asarray(want.reward))
  np.testing.assert_array_equal(got.state.t.numpy(),
                                np.asarray(want.state.t))
  # h: equal where the episode goes on; a fresh draw in range elsewhere.
  h, want_h = got.state.h.numpy(), np.asarray(want.state.h)
  np.testing.assert_array_equal(h[~done], want_h[~done])
  lo, hi = port.scenario_config.reset_h_range
  assert ((h[done] >= lo) & (h[done] <= hi)).all()
  for key in ('image', 'gripper_closed', 'height_to_bottom'):
    np.testing.assert_array_equal(got.info['next_obs'][key].numpy(),
                                  np.asarray(want.info['next_obs'][key]))
  np.testing.assert_array_equal(got.obs['height_to_bottom'].numpy(), h)
  # The acted-on observation: the fresh episode's wherever done.
  np.testing.assert_array_equal(got.obs['image'][~done].numpy(),
                                got.info['next_obs']['image'][~done].numpy())
  np.testing.assert_array_equal(got.obs['image'][done].numpy(),
                                port.render(h).numpy()[done])
  if kind == 'mixed' and t0 == 0:
    assert done.any() and (~done).any()


def test_steps_match_the_numpy_env_slot_by_slot():
  n = 12
  rng = np.random.RandomState(2)
  heights = rng.uniform(0.12, 1.05, n).astype(np.float32)
  heights = heights[np.abs(heights - grasping_sim.THRESHOLD) > 1e-3]
  n = len(heights)
  env = VecGraspingEnv(n, 64, 80, episode_length=1, device='cpu',
                       scenario_config=ScenarioConfig(
                           noise_scale_range=(0.0, 0.0)))
  action = _actions('mixed', n, rng)
  result = env.step(env.state_for_heights(heights), action)
  numpy_env = grasping_sim.SimGraspingEnv(height=64, width=80,
                                          episode_length=1, noise_scale=0.0)
  for i, h in enumerate(heights):
    numpy_env._h, numpy_env._t = float(h), 0
    next_obs, reward, done, info = numpy_env.step(action[i])
    assert float(result.reward[i]) == reward
    assert bool(result.done[i]) == done
    assert bool(result.info['terminal'][i]) == info['terminal']
    np.testing.assert_allclose(
        float(result.info['next_obs']['height_to_bottom'][i]),
        next_obs['height_to_bottom'], rtol=1e-6)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_optimal_value_equals_jax_across_a_sweep(ref, seed):
  n = 32
  port, jax_env = _pair(ref, n, 32, 40, seed=seed)
  heights = np.random.RandomState(seed).uniform(0.0, 1.6, n).astype(
      np.float32)
  np.testing.assert_array_equal(port.steps_to_grasp(heights).numpy(),
                                np.asarray(jax_env.steps_to_grasp(heights)))
  np.testing.assert_allclose(port.optimal_value(heights).numpy(),
                             np.asarray(jax_env.optimal_value(heights)),
                             rtol=1e-6)
  np.testing.assert_array_equal(port.optimal_value(
      port.scenarios.threshold).numpy(), np.ones(n, np.float32))


def test_reset_is_seeded_per_call_and_noise_is_per_slot():
  env = VecGraspingEnv(4, 32, 40, device='cpu', scenario_config=(
      ScenarioConfig(noise_scale_range=(4.0, 4.0))))
  state, obs = env.reset(seed=7)
  again_state, again = env.reset(seed=7)
  np.testing.assert_array_equal(obs['image'].numpy(), again['image'].numpy())
  np.testing.assert_array_equal(state.h.numpy(), again_state.h.numpy())
  assert not np.array_equal(obs['image'][0].numpy(), obs['image'][1].numpy())
  lo, hi = env.scenario_config.reset_h_range
  assert ((state.h >= lo) & (state.h <= hi)).all()
  assert state.t.dtype == torch.int32 and int(state.t.sum()) == 0
  _, other = env.reset(seed=8)
  assert not np.array_equal(obs['image'].numpy(), other['image'].numpy())


def test_env_runs_on_the_card_unless_asked():
  assert inspect.signature(VecGraspingEnv).parameters[
      'device'].default == 'cuda'
  with pytest.raises(ValueError, match='num_envs'):
    VecGraspingEnv(0, device='cpu')
