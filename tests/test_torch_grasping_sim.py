"""The port's synthetic grasping MDP, its replay records, its collect job
and its test-scale critic against the JAX package, on the CPU.

The environment and the random policy are numpy in both packages: the
same seed must give the same pixels, rewards, terminals, dones and actions
bit for bit, and the same episode the same record bytes (PIL's JPEG on
both sides). The sim critic's forward runs float32 on both sides from the
same (converted) weights: XLA and PyTorch sum its products in other
orders, a few ulps a layer over five layers, so its logits are held within
1e-5.
"""

import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data.parser import ExampleParser
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.qtopt import grasping_sim
from tensor2robot_tpu_torch.rl import run_collect_eval

GIN = os.path.join('tensor2robot_tpu_torch', 'research', 'qtopt', 'configs',
                   'run_collect_grasping_sim.gin')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture('research.qtopt.grasping_sim',
                               'rl.collect_eval', 'rl.run_env',
                               'data.writer')


def _run_episodes(module, seed, episodes, **env_kwargs):
  """(obs, action, reward, next_obs, done, info) steps of the random
  policy in the env of ``module``."""
  env = module.SimGraspingEnv(seed=seed, **env_kwargs)
  policy = module.SimGraspingRandomPolicy(seed=seed)
  steps = []
  for _ in range(episodes):
    obs, done = env.reset(), False
    while not done:
      action, _ = policy.sample_action(obs, 0.0)
      next_obs, reward, done, info = env.step(action)
      steps.append((obs, action, reward, next_obs, done, info))
      obs = next_obs
  return steps


@pytest.mark.parametrize('seed,shape,episodes', [
    (0, (512, 640), 4), (3, (48, 64), 12), (5, (64, 80), 12)])
def test_env_and_random_policy_are_bit_equal(ref, seed, shape, episodes):
  got = _run_episodes(grasping_sim, seed, episodes, height=shape[0],
                      width=shape[1])
  want = _run_episodes(ref.grasping_sim, seed, episodes, height=shape[0],
                       width=shape[1])
  assert len(got) == len(want) > episodes
  for g, w in zip(got, want):
    for g_obs, w_obs in ((g[0], w[0]), (g[3], w[3])):
      assert g_obs['image'].dtype == np.uint8
      np.testing.assert_array_equal(g_obs['image'], w_obs['image'])
      assert g_obs['gripper_closed'] == w_obs['gripper_closed']
      assert g_obs['height_to_bottom'] == w_obs['height_to_bottom']
    np.testing.assert_array_equal(g[1], w[1])
    assert g[1].dtype == w[1].dtype == np.float32
    assert (g[2], g[4], g[5]) == (w[2], w[4], w[5])
  # Both kinds of episode end occur: terminals and timeouts.
  assert {s[5]['terminal'] for s in got if s[4]} == {True, False}


def test_values_and_background_are_equal(ref):
  for h in np.linspace(0.0, grasping_sim.H_MAX, 41):
    assert (grasping_sim.steps_to_grasp(h) ==
            ref.grasping_sim.steps_to_grasp(h))
    assert (grasping_sim.optimal_value(h) ==
            ref.grasping_sim.optimal_value(h))
    assert (grasping_sim.optimal_value(h, gamma=0.5, threshold=0.3) ==
            ref.grasping_sim.optimal_value(h, gamma=0.5, threshold=0.3))
  np.testing.assert_array_equal(grasping_sim.gradient_background(512, 640),
                                ref.grasping_sim.gradient_background(512, 640))
  for name in ('WV_Z_INDEX', 'CLOSE_INDEX', 'OPEN_INDEX', 'TERMINATE_INDEX',
               'THRESHOLD', 'DESCENT_SCALE', 'H_MAX', 'GAMMA'):
    assert getattr(grasping_sim, name) == getattr(ref.grasping_sim, name)


def test_transition_records_are_the_same_bytes(ref):
  steps = _run_episodes(grasping_sim, 1, 3)
  got = grasping_sim.episode_to_transitions_grasping(steps)
  want = ref.grasping_sim.episode_to_transitions_grasping(steps)
  assert len(got) == len(steps) and got == want
  # A timeout carries done 0, a terminal done 1.
  from tensor2robot_tpu_torch.data import wire
  dones = [float(wire.parse_example(r)['done'][1][0]) for r in got]
  assert dones == [1.0 if s[5]['terminal'] else 0.0 for s in steps]


@pytest.mark.parametrize('shape,per_type', [((48, 64), 6), ((512, 640), 2)])
def test_ranking_pairs_are_equal(ref, shape, per_type):
  got = grasping_sim.build_ranking_pairs(
      grasping_sim.SimGraspingEnv(height=shape[0], width=shape[1], seed=9),
      per_type=per_type)
  want = ref.grasping_sim.build_ranking_pairs(
      ref.grasping_sim.SimGraspingEnv(height=shape[0], width=shape[1],
                                      seed=9), per_type=per_type)
  assert len(got) == len(want) == 3
  for g_pair, w_pair in zip(got, want):
    for g_arm, w_arm in zip(g_pair, w_pair):
      assert sorted(g_arm) == sorted(w_arm)
      for key in w_arm:
        assert g_arm[key].dtype == w_arm[key].dtype, key
        np.testing.assert_array_equal(g_arm[key], w_arm[key])


def test_extra_feature_specs_are_jax_specs(ref):
  model = grasping_sim.make_sim_critic_model(48, 64, device='cpu')
  image = model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)['state/image']
  jax_model = ref.grasping_sim.make_sim_critic_model(48, 64)
  jax_image = jax_model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)['state/image']
  assert (image.shape, image.dtype, image.name, image.data_format) == (
      tuple(jax_image.shape), jax_image.dtype, jax_image.name,
      jax_image.data_format)
  got = grasping_sim.offpolicy_extra_feature_specs(image)
  want = ref.grasping_sim.offpolicy_extra_feature_specs(jax_image)
  assert sorted(got) == sorted(want)
  for key in want:
    assert (got[key].shape, got[key].dtype, got[key].name,
            got[key].data_format) == (
                tuple(want[key].shape), want[key].dtype, want[key].name,
                want[key].data_format), key
  # The critic's own specification is the JAX sim critic's.
  for mode in (ModeKeys.TRAIN, ModeKeys.PREDICT):
    spec = model.get_feature_specification(mode)
    jax_spec = jax_model.get_feature_specification(mode)
    assert sorted(spec) == sorted(jax_spec)
    for key in jax_spec:
      assert (spec[key].shape, spec[key].name) == (
          tuple(jax_spec[key].shape), jax_spec[key].name), key


def test_candidate_actions():
  fn = grasping_sim.make_candidate_actions_fn(4)
  heights = torch.tensor([[0.25], [1.5], [0.75]])
  next_features = {'action/gripper_closed': torch.tensor([[0.], [1.], [0.]]),
                   'action/height_to_bottom': heights}
  out = fn(torch.Generator().manual_seed(3), 3, next_features)
  again = fn(torch.Generator().manual_seed(3), 3, next_features)
  widths = dict(grasping_sim.ACTION_DIM_LAYOUT, gripper_closed=1,
                height_to_bottom=1)
  assert sorted(out) == sorted('action/' + k for k in widths)
  for key, value in out.items():
    assert tuple(value.shape) == (12, widths[key.split('/')[1]]), key
    assert value.dtype == torch.float32
    assert torch.equal(value, again[key])
  for key in ('action/world_vector', 'action/vertical_rotation'):
    assert float(out[key].min()) >= -1.0 and float(out[key].max()) < 1.0
  for key in ('action/close_gripper', 'action/open_gripper'):
    assert set(out[key].flatten().tolist()) <= {0.0, 1.0}
  assert float(out['action/terminate_episode'].abs().max()) == 0.0
  # State-major: rows b*K .. b*K + K - 1 are state b's.
  assert torch.equal(out['action/height_to_bottom'],
                     heights.repeat_interleave(4, dim=0))
  assert torch.equal(out['action/gripper_closed'][4:8],
                     torch.ones((4, 1)))


def _flax_sim_variables(ref, features, seed):
  net = ref.grasping_sim._build_sim_qnet()()
  variables = net.init(jax.random.PRNGKey(seed), features)
  return net, jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize('rows', [4, 12])
def test_sim_qnet_matches_flax(ref, rows):
  """4 states with one action each, and the megabatch: 4 states x 3."""
  rng = np.random.RandomState(rows)
  features = {'state/image': rng.uniform(0, 1, (4, 48, 64, 3))
                             .astype(np.float32)}
  for key, width in grasping_sim.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    features['action/' + key] = rng.uniform(
        -1, 1, (rows, width)).astype(np.float32)
  net, variables = _flax_sim_variables(ref, features, rows)
  want = net.apply(variables, features)
  model = grasping_sim.make_sim_critic_model(48, 64, device='cpu')
  port = convert.from_flax(variables)['params']
  assert ({k: tuple(v.shape) for k, v in port.items()} ==
          {k: tuple(v.shape) for k, v in model.network.state_dict().items()})
  with torch.no_grad():
    got = torch.func.functional_call(
        model.network, port,
        ({k: torch.from_numpy(v) for k, v in features.items()},))
  assert tuple(got['q_logits'].shape) == (rows,)
  np.testing.assert_allclose(got['q_logits'].numpy(),
                             np.asarray(want['q_logits']), atol=1e-5)
  np.testing.assert_allclose(got['q_predicted'].numpy(),
                             np.asarray(want['q_predicted']), atol=1e-5)
  assert np.ptp(np.asarray(want['q_logits'])) > 1e-2


def test_sim_critic_init_has_flax_defaults():
  """lecun normal kernels (std sqrt(1 / fan_in)), zero biases."""
  model = grasping_sim.make_sim_critic_model(48, 64, device='cpu')
  params = model.init_variables(torch.Generator().manual_seed(0))['params']
  weight = params['Dense_0.weight']
  assert abs(float(weight.std()) * np.sqrt(weight.shape[1]) - 1.0) < 0.02
  assert float(weight.abs().max()) <= 2.0 / np.sqrt(weight.shape[1]) / (
      0.87962566103423978) + 1e-6
  assert all(float(v.abs().max()) == 0.0 for k, v in params.items()
             if k.endswith('bias'))


def _records(path_pattern):
  return [record for path in sorted(glob.glob(path_pattern))
          for record in tfrecord.read_all_records(path)]


def test_run_collect_eval_writes_the_jax_collectors_records(ref, tmp_path,
                                                            capsys):
  """The port's entry point from its gin, against the JAX collector on the
  same env and policy seeds: the same records, parsed to the same
  arrays."""
  port_dir, jax_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
  cwd = os.getcwd()
  os.chdir(REPO)
  try:
    assert run_collect_eval.main([
        '--device', 'cpu', '--gin_configs', GIN,
        '--gin_bindings', "collect_eval_loop.root_dir = {!r}".format(
            port_dir),
        '--gin_bindings', 'collect_eval_loop.num_collect = 8',
        '--gin_bindings', 'collect/SimGraspingEnv.height = 48',
        '--gin_bindings', 'collect/SimGraspingEnv.width = 64']) == 0
  finally:
    os.chdir(cwd)
  line = capsys.readouterr().out.strip().splitlines()[-1]
  assert '"collect": {"files": 1' in line

  env = ref.grasping_sim.SimGraspingEnv(height=48, width=64, seed=0)
  ref.collect_eval.collect_eval_loop(
      collect_env=env, eval_env=None,
      policy_class=lambda: ref.grasping_sim.SimGraspingRandomPolicy(seed=0),
      num_collect=8, num_eval=0,
      run_agent_fn=functools.partial(
          ref.run_env.run_env,
          episode_to_transitions_fn=(
              ref.grasping_sim.episode_to_transitions_grasping),
          replay_writer=ref.writer.TFRecordReplayWriter(), close_env=False),
      root_dir=jax_dir, init_with_random_variables=True)

  got = _records(os.path.join(port_dir, 'policy_collect', '*'))
  want = _records(os.path.join(jax_dir, 'policy_collect', '*'))
  assert len(got) == len(want) >= 8
  assert got == want
  model = grasping_sim.make_sim_critic_model(48, 64, device='cpu')
  spec = dict(model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN))
  spec.update(grasping_sim.offpolicy_extra_feature_specs(spec['state/image']))
  parser = ExampleParser(spec, model.get_label_specification(ModeKeys.TRAIN))
  got_features, got_labels = parser.parse_batch(got)
  want_features, want_labels = parser.parse_batch(want)
  for key in spec:
    np.testing.assert_array_equal(got_features[key], want_features[key])
  np.testing.assert_array_equal(got_labels['reward'], want_labels['reward'])
  assert got_features['next/state/image'].shape == (len(got), 48, 64, 3)
  # The episode metrics file, as JAX's run_env writes it.
  with open(os.path.join(port_dir, 'live_eval_0', 'metrics-collect.jsonl')
            ) as f, open(os.path.join(jax_dir, 'live_eval_0',
                                      'metrics-collect.jsonl')) as g:
    assert f.read() == g.read()


def test_the_default_episode_runner_collects(ref, tmp_path):
  """Without run_agent_fn the port's loop runs run_env itself (keeping the
  env open across versions, closing it at the end) and writes the episode
  metrics; JAX's raises, its rl package having rebound the name run_env
  to the function."""
  from tensor2robot_tpu_torch.rl import collect_eval

  closed = []
  env = grasping_sim.SimGraspingEnv(height=48, width=64, seed=0)
  env.close = lambda: closed.append(True)
  collect_eval.collect_eval_loop(
      collect_env=env, eval_env=None,
      policy_class=lambda: grasping_sim.SimGraspingRandomPolicy(seed=0),
      num_collect=3, num_eval=0, root_dir=str(tmp_path),
      init_with_random_variables=True)
  assert closed == [True]
  assert os.path.exists(os.path.join(str(tmp_path), 'live_eval_0',
                                     'metrics-collect.jsonl'))
  with pytest.raises(AttributeError):
    ref.collect_eval.collect_eval_loop(
        collect_env=ref.grasping_sim.SimGraspingEnv(height=48, width=64),
        eval_env=None,
        policy_class=lambda: ref.grasping_sim.SimGraspingRandomPolicy(),
        num_collect=1, num_eval=0, root_dir=str(tmp_path / 'jax'),
        init_with_random_variables=True)
