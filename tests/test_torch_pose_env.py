"""The port's pose toy task (``research/pose_env``) against the JAX
package's, on the CPU, through the import shim of ``_torch_jax_qtopt``
(the JAX pose env's package reaches the qtopt modules).

  * the numpy renderer and env, bit for bit;
  * ``PoseEnvRegressionModel``, ``PoseEnvContinuousMCModel`` and
    ``PoseEnvRegressionModelMAML`` (2 tasks, one inner step, second order)
    against JAX's on the same uint8 frames and JAX's weights carried
    across: the preprocessed features bit-equal, then outputs, loss and
    every gradient;
  * the four gins through the port's entry points: the collect gin writes
    records, the records gin trains from them, the random-batch gin and
    the MAML gin train;
  * ``run_meta_env``: demo, adaptation and trial episodes of
    ``MAMLRegressionPolicy``.

Tolerances. float32 on both sides (JAX's network casts its image to
float32): outputs and losses within 1e-5 of each one's magnitude,
gradients within 1e-4 of each tensor's largest (the spatial softmax's
exponentials in other summation orders). MAML's outer gradients within
1e-3 of each tensor's largest: the head's gradient is the residual of the
adapted output against its target, over the reward-weighted samples; the
outputs agree within 1e-5 of their size, and a residual of a few hundredths
(the MAML test's second pose dim, 0.035 against 0.19 for the first)
carries that as a few 1e-4 of the tensor.
"""

import contextlib
import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.meta_learning import MAMLRegressionPolicy
from tensor2robot_tpu_torch.meta_learning import run_meta_env
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor)
from tensor2robot_tpu_torch.research import pose_env
from tensor2robot_tpu_torch.rl import run_collect_eval
from tensor2robot_tpu_torch.trainer import train_eval

RTOL = 1e-5
GRAD_RTOL = 1e-4
# MAML's outer gradients: see the module docstring.
MAML_GRAD_RTOL = 1e-3
CONFIGS = 'tensor2robot_tpu_torch/research/pose_env/configs/'


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture(
      'research.pose_env', 'research.pose_env.pose_env',
      'research.pose_env.pose_env_models',
      'research.pose_env.pose_env_maml_models', 'meta_learning',
      'specs.struct')


def close(got, want, rtol=RTOL, what=''):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  assert float(np.abs(got - want).max()) <= rtol * scale + 1e-6, (
      what, float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize('hidden_drift', [False, True])
def test_renderer_and_env_bit_equal(ref, hidden_drift):
  """Frames, targets, rewards and debug of 3 tasks of 3 episodes each."""
  ours = pose_env.PoseToyEnv(seed=5, hidden_drift=hidden_drift)
  theirs = ref.pose_env.PoseToyEnv(seed=5, hidden_drift=hidden_drift)
  rng = np.random.RandomState(0)
  for _ in range(3):
    ours.reset_task()
    theirs.reset_task()
    for _ in range(3):
      np.testing.assert_array_equal(ours.reset(), theirs.reset())
      action = rng.uniform(-1, 1, 2)
      got, want = ours.step(action), theirs.step(action)
      np.testing.assert_array_equal(got[0], want[0])
      assert got[1:3] == want[1:3]
      np.testing.assert_array_equal(got[3]['target_pose'],
                                    want[3]['target_pose'])
  frame = ours.reset()
  assert frame.dtype == np.uint8 and frame.shape == (64, 64, 3)
  assert (frame[..., 0].astype(int) - frame[..., 2].astype(int) > 100).any()


def _frames(count, seed=1):
  env = pose_env.PoseToyEnv(seed=seed)
  frames, targets = [], []
  for _ in range(count):
    frames.append(env.reset())
    targets.append(env._target_pose[:2].astype(np.float32))
  return np.stack(frames), np.stack(targets)


def _jax_params(model, features, labels, struct):
  variables = model.init_variables(
      jax.random.PRNGKey(0), struct(**{k: jnp.asarray(v) for k, v in
                                       features.items()}),
      struct(**{k: jnp.asarray(v) for k, v in labels.items()}), 'train')
  return jax.tree_util.tree_map(np.asarray, variables)


def _port_state(model, variables):
  state = convert.from_flax(variables)['params']
  names = {name for name, _ in model.network.named_parameters()}
  params = {k: v for k, v in state.items() if k in names}
  return TrainState(step=0, params=params,
                    model_state={k: v for k, v in state.items()
                                 if k not in names},
                    opt_state=model.create_optimizer().init(params))


def _compare_step(ref, jax_model, model, raw_features, raw_labels):
  """JAX's jitted preprocessing and value-and-grad of the TRAIN loss
  against the port's on the same raw batch and JAX's initial weights."""
  struct = ref.struct.SpecStruct
  pre = jax.jit(lambda f, l: jax_model.preprocessor.preprocess(
      f, l, 'train'))
  jax_features, jax_labels = pre(struct(**raw_features),
                                 struct(**raw_labels))
  variables = _jax_params(jax_model, jax_features, jax_labels, struct)
  params = variables.pop('params')
  (want_loss, (_, want_outputs, _)), want_grads = jax.jit(
      jax.value_and_grad(jax_model.loss_fn, has_aux=True),
      static_argnums=(4,))(params, variables, jax_features, jax_labels,
                           'train', None)
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in raw_features.items()},
      {k: torch.from_numpy(v) for k, v in raw_labels.items()},
      ModeKeys.TRAIN)
  for key in jax_features:
    np.testing.assert_array_equal(features[key].numpy(),
                                  np.asarray(jax_features[key]))
  state = _port_state(model, {'params': params, **variables})
  params_in = {k: v.clone().requires_grad_() for k, v in state.params.items()}
  loss, (_, outputs, _) = model.loss_fn(params_in, state.model_state,
                                        features, labels, ModeKeys.TRAIN)
  grads = dict(zip(params_in, torch.autograd.grad(
      loss, list(params_in.values()), allow_unused=True)))
  close(loss, want_loss, what='loss')
  return outputs, dict(want_outputs), grads, jax.tree_util.tree_map(
      np.asarray, want_grads)


def test_regression_model_against_jax(ref):
  frames, targets = _frames(4)
  rewards = np.array([[1.0], [0.0], [1.0], [0.5]], np.float32)
  outputs, want_outputs, grads, want_grads = _compare_step(
      ref, ref.pose_env_models.PoseEnvRegressionModel(),
      pose_env.PoseEnvRegressionModel(device='cpu'), {'state': frames},
      {'target_pose': targets, 'reward': rewards})
  for key in ('inference_output', 'state_features'):
    close(outputs[key], want_outputs[key], what=key)
  for name, value in convert.from_flax(
      {'params': want_grads})['params'].items():
    close(grads[name], value.numpy(), GRAD_RTOL, name)


def test_continuous_mc_model_against_jax(ref):
  frames, targets = _frames(3, seed=2)
  rewards = np.array([-0.1, -0.5, -0.3], np.float32)
  outputs, want_outputs, grads, want_grads = _compare_step(
      ref, ref.pose_env_models.PoseEnvContinuousMCModel(),
      pose_env.PoseEnvContinuousMCModel(device='cpu'),
      {'state/image': frames, 'action/pose': targets}, {'reward': rewards})
  close(outputs['q_predicted'], want_outputs['q_predicted'])
  for name, value in convert.from_flax(
      {'params': want_grads})['params'].items():
    close(grads[name], value.numpy(), GRAD_RTOL, name)


def test_maml_model_against_jax(ref):
  """2 tasks, one condition and one inference frame each, one inner step
  at the gin's rate, second order: the preprocessed meta batch, every
  prediction, the loss and every outer gradient."""
  frames, targets = _frames(4, seed=3)
  rewards = np.array([1.0, 0.5, 1.0, 0.0], np.float32).reshape(2, 2, 1)
  frames, targets = frames.reshape(2, 2, 64, 64, 3), targets.reshape(2, 2, 2)
  raw_features = {'condition/features/state': frames[:, :1],
                  'condition/labels/target_pose': targets[:, :1],
                  'condition/labels/reward': rewards[:, :1],
                  'inference/features/state': frames[:, 1:]}
  raw_labels = {'target_pose': targets[:, 1:], 'reward': rewards[:, 1:]}
  jax_inner = ref.meta_learning.MAMLInnerLoopGradientDescent
  outputs, want_outputs, grads, want_grads = _compare_step(
      ref, ref.pose_env_maml_models.PoseEnvRegressionModelMAML(
          inner_loop=jax_inner(learning_rate=0.001)),
      pose_env.PoseEnvRegressionModelMAML(
          base_model=pose_env.PoseEnvRegressionModel(device='cpu')),
      raw_features, raw_labels)
  assert set(outputs) == set(want_outputs)
  for key in want_outputs:
    close(outputs[key], want_outputs[key], what=key)
  for name, value in convert.from_flax(
      {'params': want_grads})['params'].items():
    close(grads[name], value.numpy(), MAML_GRAD_RTOL, name)


def _main(module, argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert module.main(argv) == 0
  return json.loads(out.getvalue().strip().splitlines()[-1])


def test_gins_collect_then_train(tmp_path):
  """The collect gin writes records (4 episodes) that the records gin
  trains from; the random-batch gin and the MAML gin (8 tasks) train 2
  steps each; every loss finite."""
  collect = _main(run_collect_eval, [
      '--device', 'cpu', '--gin_configs',
      CONFIGS + 'run_collect_pose_env.gin', '--gin_bindings',
      "collect_eval_loop.root_dir = '{}'".format(tmp_path / 'collect')])
  assert collect['written']['collect']['records'] == 4
  records = glob.glob(str(tmp_path / 'collect' / 'policy_collect' / '*'))
  assert len(records) == 1
  runs = {
      'train_pose_env_from_records.gin': [
          'TRAIN_DATA = "{}"'.format(records[0]), 'TRAIN_BATCH_SIZE = 4'],
      'train_pose_env.gin': ['train_eval_model.max_train_steps = 2'],
      'run_train_reg_maml.gin': ['train_eval_model.eval_throttle_steps = 2',
                                 'train_eval_model.eval_steps = 1'],
  }
  for gin, bindings in runs.items():
    argv = ['--device', 'cpu', '--model_dir', str(tmp_path / gin),
            '--gin_configs', CONFIGS + gin]
    for binding in bindings + ['train_eval_model.max_train_steps = 2',
                               'train_eval_model.log_every_n_steps = 1']:
      argv += ['--gin_bindings', binding]
    line = _main(train_eval, argv)
    assert line['step'] == 2, gin
    assert np.isfinite(line['metrics']['loss']), gin
  assert line['model'] == 'PoseEnvRegressionModelMAML'
  assert {'inner_losses_step_0', 'inner_losses_step_1'} <= set(
      line['metrics'])


class _DemoPolicy:
  """The env's true target pose once: a perfect demo."""

  def __init__(self, env):
    self._env = env
    self._steps = 0

  def sample_action(self, obs, explore_prob):
    if self._steps >= 1:
      return None, None
    self._steps += 1
    return self._env._target_pose[:2].astype(np.float32), None


def test_run_meta_env_episode(tmp_path):
  """Demo, adaptation and trials on the hidden-drift env with a
  ``MAMLRegressionPolicy`` over a predictor of random weights: each
  trial's action is the MAML model's adapted output on that episode's
  frame and the demo; the metrics written."""
  model = pose_env.PoseEnvRegressionModelMAML(
      base_model=pose_env.PoseEnvRegressionModel(device='cpu'))
  predictor = CheckpointPredictor(model)
  predictor.init_randomly()
  policy = MAMLRegressionPolicy(t2r_model=model, predictor=predictor)
  env = pose_env.PoseToyEnv(seed=7, hidden_drift=True)
  actions = []
  sample = policy.sample_action
  policy.sample_action = lambda obs, p: actions.append(
      (obs, policy._prev_episode_data)) or sample(obs, p)
  rewards = run_meta_env(
      env, policy=policy, demo_policy_cls=_DemoPolicy,
      root_dir=str(tmp_path), num_tasks=2, num_adaptations_per_task=2,
      num_episodes_per_adaptation=1, num_demos=1, write_summary=True)
  assert sorted(rewards) == [0, 1]
  assert len(rewards[0][1]) == 1
  assert os.path.exists(str(tmp_path / 'live_eval_0' /
                            'metrics-collect.jsonl'))
  obs, demos = actions[-1]
  assert demos and len(demos) == 2   # the demo and the first trial
  features, _ = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in model.pack_features(
          obs, demos, 0).items()}, None, ModeKeys.PREDICT)
  want = model.predict_step(predictor.variables, features)
  got = policy.SelectAction(obs, None, None)
  np.testing.assert_array_equal(got, want['inference_output'][0, 0].numpy())


# -- the layers under the pose models: spatial softmax, vision towers ------

@pytest.fixture(scope='module')
def layers():
  import importlib
  return (importlib.import_module('tensor2robot_tpu.layers.spatial_softmax'),
          importlib.import_module('tensor2robot_tpu.layers.vision_layers'))


def _flax_apply(module, variables, *args, train=False, **kwargs):
  if train:
    out, new = module.apply(variables, *args, train=True,
                            mutable=['batch_stats'], **kwargs)
    return out, new['batch_stats']
  return module.apply(variables, *args, **kwargs), None


@pytest.mark.parametrize('gumbel', [False, True])
def test_spatial_softmax(layers, gumbel):
  """The keypoints and softmax maps at temperature 0.5; the Gumbel branch
  on JAX's own noise."""
  from tensor2robot_tpu_torch.layers import spatial_softmax
  jax_softmax, _ = layers
  x = np.random.RandomState(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
  key = jax.random.PRNGKey(3) if gumbel else None
  want = jax_softmax.spatial_softmax(jnp.asarray(x), 0.5, key)
  noise = (np.array(jax.random.gumbel(key, (2, 3, 35), jnp.float32))
           if gumbel else None)
  got = spatial_softmax.spatial_softmax(torch.from_numpy(x), 0.5,
                                        gumbel_noise=noise)
  for g, w in zip(got, want):
    close(g, w)
  drawn = spatial_softmax.draw_gumbel((4000,),
                                      torch.Generator().manual_seed(0))
  assert abs(float(drawn.mean()) - 0.5772) < 0.05   # Euler's constant


@pytest.mark.parametrize('batch_norm,train', [(False, False), (True, False),
                                              (True, True)])
def test_images_to_features_net(layers, batch_norm, train):
  """ImagesToFeaturesNet with FiLM, layer norm (JAX's default) or batch
  norm in EVAL and TRAIN: keypoints, maps and the new statistics."""
  from tensor2robot_tpu_torch.layers import vision_layers
  _, jax_vision = layers
  rng = np.random.RandomState(1)
  images = rng.uniform(size=(2, 48, 48, 3)).astype(np.float32)
  film = (rng.normal(size=(2, 320)) * 0.2).astype(np.float32)
  net = jax_vision.ImagesToFeaturesNet(use_batch_norm=batch_norm)
  variables = jax.tree_util.tree_map(np.asarray, dict(net.init(
      jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(film))))
  (want, want_maps), new = _flax_apply(net, variables, jnp.asarray(images),
                                       jnp.asarray(film), train=train)
  port = vision_layers.ImagesToFeaturesNet(use_batch_norm=batch_norm)
  state = convert.from_flax(variables)['params']
  got, got_maps = torch.func.functional_call(
      port, state, (torch.from_numpy(images), torch.from_numpy(film)),
      {'train': train})
  close(got, want)
  close(got_maps['softmax'], want_maps['softmax'])
  for path, value in jax.tree_util.tree_flatten_with_path(new or {})[0]:
    close(state['.'.join(p.key for p in path)], value)


@pytest.mark.parametrize('train', [False, True])
def test_images_to_features_high_res_net(layers, train):
  """The multi-resolution tower (batch norms, 2x2 VALID max pools, taps
  resized nearest) at 320x320, the least size in steps of 32 where its
  five blocks' taps (77, 36, 16, 6, 1) all fit."""
  from tensor2robot_tpu_torch.layers import vision_layers
  _, jax_vision = layers
  images = np.random.RandomState(2).uniform(
      size=(1, 320, 320, 3)).astype(np.float32)
  net = jax_vision.ImagesToFeaturesHighResNet()
  variables = jax.tree_util.tree_map(np.asarray, dict(net.init(
      jax.random.PRNGKey(1), jnp.asarray(images))))
  (want, want_maps), new = _flax_apply(net, variables, jnp.asarray(images),
                                       train=train)
  port = vision_layers.ImagesToFeaturesHighResNet()
  state = convert.from_flax(variables)['params']
  got, got_maps = torch.func.functional_call(
      port, state, (torch.from_numpy(images),), {'train': train})
  close(got, want)
  close(got_maps['softmax'], want_maps['softmax'])
  for path, value in jax.tree_util.tree_flatten_with_path(new or {})[0]:
    close(state['.'.join(p.key for p in path)], value)


def test_film_and_pose_heads(layers):
  """FilmParams, split_film_params and ImageFeaturesToPoseNet with an aux
  input and an aux output, and without a final layer."""
  from tensor2robot_tpu_torch.layers import vision_layers
  _, jax_vision = layers
  rng = np.random.RandomState(3)
  points = rng.normal(size=(3, 8)).astype(np.float32)
  aux = rng.normal(size=(3, 2)).astype(np.float32)
  film = jax_vision.FilmParams()
  film_vars = film.init(jax.random.PRNGKey(0), jnp.asarray(points))
  want_film = film.apply(film_vars, jnp.asarray(points))
  got_film = torch.func.functional_call(
      vision_layers.FilmParams(8), convert.from_flax(
          jax.tree_util.tree_map(np.asarray, dict(film_vars)))['params'],
      (torch.from_numpy(points),))
  close(got_film, want_film)
  for g, w in zip(vision_layers.split_film_params(got_film, 5),
                  jax_vision.split_film_params(want_film, 5)):
    for gi, wi in zip(g, w):
      close(gi, wi)
  for kwargs in ({'num_outputs': 4, 'aux_output_dim': 3},
                 {'num_outputs': None}):
    head = jax_vision.ImageFeaturesToPoseNet(**kwargs)
    head_vars = jax.tree_util.tree_map(np.asarray, dict(head.init(
        jax.random.PRNGKey(1), jnp.asarray(points), jnp.asarray(aux))))
    head_vars['params']['bias_transform'] = rng.normal(size=10).astype(
        np.float32)
    want = head.apply(head_vars, jnp.asarray(points), jnp.asarray(aux))
    got = torch.func.functional_call(
        vision_layers.ImageFeaturesToPoseNet(10, **kwargs),
        convert.from_flax(head_vars)['params'],
        (torch.from_numpy(points), torch.from_numpy(aux)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
      close(g, w)
