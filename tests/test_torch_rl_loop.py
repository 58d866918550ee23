"""The port's actor-learner loop (``rl/loop.py``) against the JAX package's,
on the CPU.

The port's acting step draws its CEM noise, its exploration and its env's
noise from torch generators; the comparison with JAX's ``make_act_step``
hands the port JAX's own draws (the CEM noise of each slot's key, the
uniform actions and the coins) and pins the env (``state_for_heights``, a
noise scale of 0). Both run the sim critic in float32 from the same weights
(JAX's initial weights, converted), so the actions and q are held within
1e-5 and the transition's arrays are equal, but for the moved height, which
is within one float32 rounding (XLA fuses its multiply and subtract).

The loop's own runs are JAX's tests (``tests/test_rl_loop.py``) on the port
with JAX's thresholds: a short run swaps, a second run starts fresh, a
dropped swap is retried, a learner crash fails fast, and the learning run's
greedy success ends at least 0.6 and 0.25 above the first window's. JAX's
``observability.doctor`` reads the port's run directory. Every run has a
``max_seconds`` bound and the loop joins its learner with a timeout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch import observability as obs
from tensor2robot_tpu_torch.envs import ScenarioConfig, VecGraspingEnv
from tensor2robot_tpu_torch.observability import read_telemetry
from tensor2robot_tpu_torch.observability.rl_metrics import RL_RECORD_SCHEMA
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.replay import wire as replay_wire
from tensor2robot_tpu_torch.replay.client import LocalReplayClient
from tensor2robot_tpu_torch.replay.service import ReplayConfig, ReplayService
from tensor2robot_tpu_torch.research.qtopt import grasping_sim
from tensor2robot_tpu_torch.rl import loop as loop_lib
from tensor2robot_tpu_torch.rl.offpolicy import split_offpolicy_batch

HEIGHT, WIDTH = 32, 40
SAMPLES, ITERS, ELITES = 8, 2, 3
JOIN_TIMEOUT_S = 60.0


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture(
      'rl.loop', 'envs.grasping', 'research.qtopt.grasping_sim',
      'models.optimizers', 'specs.struct', 'trainer',
      'observability.doctor')


@pytest.fixture(autouse=True)
def clean_state():
  previous = obs.set_registry(obs.TelemetryRegistry())
  fault_injection.set_injector(None)
  yield
  fault_injection.set_injector(None)
  obs.set_registry(previous)


@pytest.fixture
def one_thread():
  """One intra-op thread: under parallel test workers each process's pool
  fights the others' for the cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _tiny_config(**overrides):
  kwargs = dict(cem_samples=SAMPLES, cem_iters=ITERS, num_elites=ELITES,
                batch_size=8, num_candidates=8, publish_every_steps=10,
                swap_poll_steps=2, min_resident_examples=16,
                report_interval_s=2.0, seed=0)
  kwargs.update(overrides)
  return loop_lib.RLLoopConfig(**kwargs)


def _tiny_loop(tmp_path, config=None, **kwargs):
  kwargs.setdefault('num_envs', 8)
  return loop_lib.build_grasping_loop(
      str(tmp_path / 'run'), height=HEIGHT, width=WIDTH,
      config=config or _tiny_config(), device='cpu', **kwargs)


def _run(loop, **targets):
  try:
    return loop.run(join_timeout_s=JOIN_TIMEOUT_S, **targets)
  finally:
    loop.close()


@pytest.mark.parametrize('terminal', [False, True])
def test_transition_record_equals_jax(ref, terminal):
  rng = np.random.RandomState(int(terminal))
  kwargs = dict(
      obs_image=rng.randint(0, 255, (HEIGHT, WIDTH, 3)).astype(np.uint8),
      obs_height=0.7, action=rng.uniform(-1, 1, 8).astype(np.float32),
      reward=float(terminal), terminal=terminal,
      next_image=rng.randint(0, 255, (HEIGHT, WIDTH, 3)).astype(np.uint8),
      next_height=0.35)
  got = loop_lib.build_transition_record(**kwargs)
  want = ref.loop.build_transition_record(**kwargs)
  assert sorted(got) == sorted(want)
  for key, value in want.items():
    assert got[key].dtype == value.dtype, key
    assert got[key].shape == value.shape, key
    np.testing.assert_array_equal(got[key], value)
  assert replay_wire.encode_example(got) == replay_wire.encode_example(want)
  assert float(got['features/done'][0]) == float(terminal)


def test_transitions_round_trip_the_replay_into_learner_keys():
  rng = np.random.RandomState(0)
  records = [loop_lib.build_transition_record(
      obs_image=rng.randint(0, 255, (HEIGHT, WIDTH, 3)).astype(np.uint8),
      obs_height=0.25 + i, action=rng.uniform(-1, 1, 8), reward=i % 2,
      terminal=bool(i % 2),
      next_image=rng.randint(0, 255, (HEIGHT, WIDTH, 3)).astype(np.uint8),
      next_height=rng.uniform(0, 1.6)) for i in range(12)]
  service = ReplayService(ReplayConfig(num_shards=2, batch_size=12, seed=0))
  client = LocalReplayClient(service)
  for record in records:
    client.append(replay_wire.encode_example(record))
  batch = client.sample(batch_size=12)
  by_tag = {float(r['features/action/height_to_bottom'][0]): r
            for r in records}
  for row in range(12):
    tag = float(batch.features['action/height_to_bottom'][row][0])
    for key, value in by_tag[tag].items():
      side, _, rest = key.partition('/')
      stored = (batch.features if side == 'features'
                else batch.labels)[rest][row]
      assert stored.dtype == value.dtype
      np.testing.assert_array_equal(stored, value)
  train, nxt, done = split_offpolicy_batch(batch.features)
  assert set(nxt) == {'state/image', 'action/gripper_closed',
                      'action/height_to_bottom'}
  assert 'state/image' in train and tuple(done.shape) == (12, 1)


def _jax_sim_variables(ref, model_dir):
  model = ref.grasping_sim.make_sim_critic_model(
      HEIGHT, WIDTH,
      create_optimizer_fn=lambda: ref.optimizers.create_adam_optimizer(3e-3))
  # A batch of 8 shards over the test process's 8 CPU devices.
  features = {'state/image': np.zeros((8, HEIGHT, WIDTH, 3), np.uint8)}
  for key, size in grasping_sim.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    features['action/' + key] = np.zeros((8, size), np.float32)
  struct = ref.struct.SpecStruct
  trainer = ref.trainer.Trainer(model, model_dir, async_checkpoints=False,
                                save_checkpoints_steps=10**9,
                                log_every_n_steps=10**9)
  state = trainer.init_state(struct(**features),
                             struct(reward=np.zeros((8, 1), np.float32)))
  trainer.close()
  return model, {'params': state.params}


def _jax_draws(rng, num_envs, explore_prob, close_prob=0.4):
  """The draws of JAX's acting step from key ``rng``, in the port's
  ``draws`` layout."""
  r_select, r_explore, r_uniform, r_close = jax.random.split(rng, 4)
  noise = np.stack([
      np.stack([np.asarray(jax.random.normal(k, (SAMPLES, 8)))
                for k in jax.random.split(key, ITERS)])
      for key in jax.random.split(r_select, num_envs)], axis=1)
  uniform = jax.random.uniform(r_uniform, (num_envs, 8), jnp.float32,
                               minval=-1.0, maxval=1.0)
  close = jax.random.bernoulli(r_close, close_prob, (num_envs,))
  explore = jax.random.bernoulli(r_explore, explore_prob, (num_envs,))
  return {'cem_noise': torch.from_numpy(noise),
          'uniform': torch.from_numpy(np.array(uniform)),
          'close': torch.from_numpy(np.array(close)),
          'explore': torch.from_numpy(np.array(explore))}


@pytest.mark.parametrize('explore_prob', [0.0, 0.5])
def test_act_step_equals_jax(ref, tmp_path, explore_prob):
  num_envs = 8
  jax_model, jax_variables = _jax_sim_variables(ref, str(tmp_path / 'jax'))
  model = grasping_sim.make_sim_critic_model(HEIGHT, WIDTH, device='cpu')
  variables = {name: model.to_device(tree) for name, tree in
               convert.from_flax(jax.tree_util.tree_map(
                   np.asarray, jax_variables)).items()}
  config = dict(num_buckets=4, threshold_range=(0.35, 0.65),
                descent_scale_range=(0.25, 0.45), camera_shift_px=2,
                noise_scale_range=(0.0, 0.0))
  env = VecGraspingEnv(num_envs, HEIGHT, WIDTH, device='cpu', seed=1,
                       scenario_config=ScenarioConfig(**config))
  jax_env = ref.grasping.VecGraspingEnv(
      num_envs, HEIGHT, WIDTH, seed=1,
      scenario_config=ref.grasping.ScenarioConfig(**config))
  act = loop_lib.make_act_step(model, env, SAMPLES, ITERS, ELITES,
                               explore_prob=explore_prob)
  jax_act = ref.loop.make_act_step(jax_model, jax_env, SAMPLES, ITERS,
                                   ELITES, explore_prob=explore_prob)
  heights = np.random.RandomState(5).uniform(0.1, 1.4, num_envs).astype(
      np.float32)
  state = env.state_for_heights(heights)
  jax_state = jax_env.state_for_heights(heights, jax.random.PRNGKey(0))
  frames = env.render(heights)
  obs_in = {'image': frames, 'gripper_closed': torch.zeros(num_envs),
            'height_to_bottom': torch.from_numpy(heights)}
  jax_obs = {'image': jnp.asarray(frames.numpy()),
             'gripper_closed': jnp.zeros((num_envs,), jnp.float32),
             'height_to_bottom': jnp.asarray(heights)}
  rng = jax.random.PRNGKey(17)
  _, _, got = act(variables, state, obs_in,
                  draws=_jax_draws(rng, num_envs, explore_prob))
  _, _, want = jax_act(jax_variables, jax_state, jax_obs, rng)
  np.testing.assert_allclose(got['action'].numpy(),
                             np.asarray(want['action']), atol=1e-5)
  np.testing.assert_allclose(got['q'].numpy(), np.asarray(want['q']),
                             atol=1e-5)
  for key in ('obs_image', 'obs_height', 'reward', 'done', 'terminal',
              'next_image'):
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                  err_msg=key)
  # The moved height within one float32 rounding: XLA fuses the descent's
  # multiply and subtract into one FMA, PyTorch rounds twice.
  np.testing.assert_allclose(got['next_height'].numpy(),
                             np.asarray(want['next_height']), rtol=1.2e-7,
                             atol=0)
  if explore_prob:
    explored = _jax_draws(rng, num_envs, explore_prob)['explore'].numpy()
    assert explored.any() and (~explored).any()


def test_artifact_workload_raises_and_names_the_reason(tmp_path):
  with pytest.raises(NotImplementedError, match='compile cache'):
    _tiny_loop(tmp_path, config=_tiny_config(artifact_workload='act'))


def test_second_run_starts_fresh_and_still_swaps(tmp_path, one_thread):
  loop = _tiny_loop(tmp_path, config=_tiny_config(
      publish_every_steps=5, swap_poll_steps=1))
  try:
    first = loop.run(max_seconds=60, max_learner_steps=25,
                     join_timeout_s=JOIN_TIMEOUT_S)
    second = loop.run(max_seconds=60, max_learner_steps=25,
                      join_timeout_s=JOIN_TIMEOUT_S)
  finally:
    loop.close()
  assert first['episodes'] > 0 and second['episodes'] > 0
  assert first['swaps'] >= 1 and first['actor_version'] > 1
  assert second['learner_steps'] == 25
  assert second['actor_steps'] < first['actor_steps'] + second['episodes']
  assert second['episodes'] < first['episodes'] + second['episodes']
  assert second['swaps'] >= 1
  assert second['actor_version'] > 1
  assert second['act_jit_cache'] == 1.0


def test_dropped_swap_is_retried_and_converges(tmp_path, one_thread):
  injector = fault_injection.FaultInjector().fail('learner.swap', times=1)
  fault_injection.set_injector(injector)
  summary = _run(_tiny_loop(tmp_path, config=_tiny_config(
      publish_every_steps=5, swap_poll_steps=1)),
                 max_seconds=60, max_learner_steps=40)
  assert injector.fired_count('learner.swap') == 1
  assert summary['dropped_swaps'] == 1
  assert summary['swaps'] >= 1
  assert summary['actor_version'] > 1


def test_learner_crash_fails_fast(tmp_path, one_thread):
  import time

  loop = _tiny_loop(tmp_path)
  calls = [0]
  real_step = loop.learner.train_step

  def dying_step(state, host_batch):
    calls[0] += 1
    if calls[0] > 3:
      raise RuntimeError('injected learner death')
    return real_step(state, host_batch)

  loop.learner.train_step = dying_step
  start = time.perf_counter()
  with pytest.raises(RuntimeError, match='injected learner death'):
    _run(loop, max_seconds=120)
  assert time.perf_counter() - start < 60.0


def test_loop_learns_and_jax_doctor_reads_it(ref, tmp_path, one_thread):
  """JAX's acceptance run on the port: the CEM actor over randomized
  scenarios, transitions through the replay service, the Bellman learner
  hot-swapping the actor; greedy success ends well above the first
  window's, and JAX's doctor reads the run as healthy."""
  loop = _tiny_loop(tmp_path)
  try:
    summary = loop.run(max_seconds=120, max_learner_steps=350,
                       join_timeout_s=JOIN_TIMEOUT_S)
    final_success = loop.measure_success(episodes=32)
  finally:
    loop.close()
  assert summary['learner_steps'] > 0
  assert summary['episodes'] > 100
  assert summary['transitions'] > 100
  assert summary['swaps'] >= 1
  assert summary['actor_version'] > 1
  assert summary['dropped_swaps'] == 0
  assert summary['act_jit_cache'] == 1.0
  baseline = summary['windows'][0]['success_rate_cumulative']
  assert final_success >= baseline + 0.25, (final_success, baseline)
  assert final_success >= 0.6
  assert summary['windows'][-1]['success_rate_cumulative'] > baseline
  assert len(summary['buckets']) >= 3
  assert 'scenario_success_spread' in summary

  run_dir = str(tmp_path / 'run')
  records = read_telemetry(os.path.join(run_dir, 'telemetry.jsonl'))
  kinds = [r.get('kind') for r in records]
  assert kinds[0] == 'rl_start' and kinds[-1] == 'rl_stop'
  windows = [r for r in records if r.get('kind') == 'rl']
  assert windows
  for window in windows:
    assert window['schema'] == RL_RECORD_SCHEMA
    assert window['num_envs'] == 8
  findings = ref.doctor.diagnose(run_dir)
  assert not any(f['severity'] == ref.doctor.CRITICAL for f in findings)
  assert any('rl loop@' in f['message'] for f in findings)


def test_selfcheck_entry_point(capsys, one_thread):
  from tensor2robot_tpu_torch.rl import run_rl_loop

  assert run_rl_loop.main(['--selfcheck', '--device', 'cpu']) == 0
  summary = json.loads(capsys.readouterr().out)
  assert summary['episodes'] > 0 and summary['learner_steps'] > 0
  assert run_rl_loop.main.__module__ == 'tensor2robot_tpu_torch.rl.run_rl_loop'
