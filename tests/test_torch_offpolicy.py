"""The port's off-policy QT-Opt (Bellman backups against the lagged
filesystem target) against the JAX package, on the CPU.

Candidate actions are injected on both sides (the port draws its own from
a torch generator, JAX from ``jax.random``), as the JAX package's own test
fixes them.

Tolerances. Both sides run float32 and sum in other orders (XLA against
PyTorch's CPU kernels): the Bellman targets, which are ``r + gamma (1 -
done) max q`` with q a sigmoid in [0, 1], are held within 1e-5, on the sim
critic and on a narrow flagship critic at fan-in scale (whose logits stay
within 1e-4, ``test_torch_qtopt.py``). One whole step on the sim critic
(Adam at 3e-3 from JAX's own initial weights): the loss within 1e-5
relative; the gradients (Adam's first moment) within 1e-5 of each tensor's
largest; each updated weight within what that gradient tolerance can move
Adam's first step, lr g / (|g| + eps) (its slope in g bounds it; a weight
whose gradient is far above eps hardly moves with it, one whose gradient
is near eps moves by up to the learning rate), plus the float32 roundings
of the step and of the subtraction.

The learning tests are JAX's (``tests/test_offpolicy.py``) on the port,
with its thresholds: the lagged target reaches ranking accuracy 0.9, the
depth-2 family 0.8 and the one-step-out arm's Q 0.6 within 240 steps with
at least 2 target refreshes; a target frozen at the initial weights leaves
that arm's Q at most 0.55.
"""

import functools
import glob
import os
import types

import jax
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data import native_loader
from tensor2robot_tpu_torch.data.parser import ExampleParser
from tensor2robot_tpu_torch.data.pipeline import BatchedExampleStream
from tensor2robot_tpu_torch.data.pipeline import RecordDataset
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.export import export_generators
from tensor2robot_tpu_torch.models import critic_model
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import device_decode
from tensor2robot_tpu_torch.research.qtopt import grasping_sim
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.rl import collect_eval
from tensor2robot_tpu_torch.rl import offpolicy
from tensor2robot_tpu_torch.rl import run_env as run_env_lib
from tensor2robot_tpu_torch.trainer.train_eval import Trainer

HEIGHT, WIDTH = 48, 64
BATCH = 8
TARGET_ATOL = 1e-5
GRAD_RTOL = 1e-5
_CRITIC = 'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom'


@pytest.fixture
def one_thread():
  """One intra-op thread for the learning tests' thousands of small ops:
  under parallel test workers each process's thread pool fights the
  others' for the cores (the learning test ran some 30 times slower so)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture(
      'research.qtopt.grasping_sim', 'research.qtopt.t2r_models',
      'rl.offpolicy', 'models.critic_model', 'models.optimizers',
      'specs.struct', 'trainer')


def _random_batch(batch=BATCH, seed=0, height=HEIGHT, width=WIDTH):
  """A host batch of the critic's keys, next/ and done (JAX's test's)."""
  rng = np.random.RandomState(seed)
  features = {'state/image': rng.randint(0, 255, (batch, height, width, 3),
                                         dtype=np.uint8)}
  for key, size in grasping_sim.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    features['action/' + key] = rng.rand(batch, size).astype(np.float32)
  labels = {'reward': (rng.rand(batch, 1) > 0.5).astype(np.float32)}
  features['next/state/image'] = rng.randint(
      0, 255, (batch, height, width, 3), dtype=np.uint8)
  features['next/action/gripper_closed'] = np.zeros((batch, 1), np.float32)
  features['next/action/height_to_bottom'] = rng.rand(
      batch, 1).astype(np.float32)
  features['done'] = (rng.rand(batch, 1) > 0.5).astype(np.float32)
  return features, labels


def _candidate_arrays(batch, k, seed):
  """K candidate actions a state, drawn with numpy: [B*K, size] arrays of
  the 8 CEM dims (the gripper keys come from the next state)."""
  rng = np.random.RandomState(seed)
  out = {}
  for key, size in grasping_sim.ACTION_DIM_LAYOUT:
    out['action/' + key] = rng.uniform(-1, 1, (batch * k, size)).astype(
        np.float32)
  out['action/close_gripper'] = (out['action/close_gripper'] > 0).astype(
      np.float32)
  return out


def _port_candidates(arrays, k):
  def candidates(generator, batch, next_features):
    del generator
    out = {key: torch.from_numpy(value) for key, value in arrays.items()}
    for key in ('action/gripper_closed', 'action/height_to_bottom'):
      out[key] = torch.as_tensor(next_features[key]).reshape(
          batch, 1).repeat_interleave(k, dim=0)
    return out
  return candidates


def _jax_candidates(arrays, k):
  import jax.numpy as jnp

  def candidates(rng, batch, next_features):
    del rng
    out = {key: jnp.asarray(value) for key, value in arrays.items()}
    for key in ('action/gripper_closed', 'action/height_to_bottom'):
      out[key] = jnp.repeat(
          jnp.asarray(next_features[key]).reshape(batch, 1), k, axis=0)
    return out
  return candidates


def _port_sim(tmp_path, name='port', **trainer_kwargs):
  model = grasping_sim.make_sim_critic_model(
      HEIGHT, WIDTH, device='cpu',
      create_optimizer_fn=lambda: optimizers.create_adam_optimizer(3e-3))
  trainer = Trainer(model, str(tmp_path / name), save_checkpoints_steps=10**9,
                    log_every_n_steps=10**9, write_metrics=False,
                    **trainer_kwargs)
  return model, trainer


def _jax_sim(ref, tmp_path, features, labels):
  model = ref.grasping_sim.make_sim_critic_model(
      HEIGHT, WIDTH,
      create_optimizer_fn=lambda: ref.optimizers.create_adam_optimizer(3e-3))
  trainer = ref.trainer.Trainer(model, str(tmp_path / 'jax'),
                                async_checkpoints=False,
                                save_checkpoints_steps=10**9,
                                log_every_n_steps=10**9)
  struct = ref.struct.SpecStruct
  state = trainer.init_state(
      struct(**ref.offpolicy.strip_offpolicy_features(features)),
      struct(**labels))
  return model, trainer, state


def _port_state(jax_state):
  return convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, jax_state))


def test_split_helpers_match_jax(ref):
  features, _ = _random_batch(seed=4)
  got = offpolicy.split_offpolicy_batch(features)
  want = ref.offpolicy.split_offpolicy_batch(features)
  for g, w in zip(got[:2], want[:2]):
    assert sorted(g) == sorted(w)
    for key in w:
      np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
  assert got[2].dtype == torch.float32
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
  assert (sorted(offpolicy.strip_offpolicy_features(features)) ==
          sorted(ref.offpolicy.strip_offpolicy_features(features)))
  with pytest.raises(ValueError, match="'done'"):
    offpolicy.split_offpolicy_batch(
        offpolicy.strip_offpolicy_features(features))


def test_bellman_targets_on_the_sim_critic_match_jax(ref, tmp_path):
  features, labels = _random_batch(seed=1)
  jax_model, jax_trainer, jax_state = _jax_sim(ref, tmp_path, features,
                                               labels)
  k, gamma = 4, 0.7
  arrays = _candidate_arrays(BATCH, k, seed=2)
  jax_bqt = ref.offpolicy.BellmanQTOptTrainer(
      jax_model, jax_trainer, _jax_candidates(arrays, k), num_candidates=k,
      gamma=gamma, target_update_steps=10**9)
  jax_bqt.seed_target(jax_state)
  _, jax_next, jax_done = ref.offpolicy.split_offpolicy_batch(features)
  want = np.asarray(jax_bqt.bellman_targets(
      jax_bqt.target_variables, jax_next, labels['reward'], jax_done,
      jax.random.PRNGKey(0)))
  jax_trainer.close()

  model, trainer = _port_sim(tmp_path)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, _port_candidates(arrays, k), num_candidates=k,
      gamma=gamma, target_update_steps=10**9)
  bqt.seed_target(_port_state(jax_state))
  _, next_features, done = offpolicy.split_offpolicy_batch(
      {key: torch.from_numpy(v) for key, v in features.items()})
  got = bqt.bellman_targets(bqt.target_variables, next_features,
                            torch.from_numpy(labels['reward']), done,
                            bqt.candidate_generator(0))
  np.testing.assert_allclose(got.numpy(), want, atol=TARGET_ATOL)
  # Not a constant: the max over candidates varies with the state.
  bootstrapped = labels['reward'].ravel() + features['done'].ravel() == 0
  assert np.ptp(want[bootstrapped]) > 1e-3

  # The oracle: each candidate scored on its own through the target.
  qs = []
  for j in range(k):
    feats = {'state/image': next_features['state/image']}
    for key, value in arrays.items():
      feats[key] = torch.from_numpy(value[j::k])
    for key in ('action/gripper_closed', 'action/height_to_bottom'):
      feats[key] = next_features[key]
    feats, _ = model.preprocessor.preprocess(feats, None, ModeKeys.PREDICT)
    with torch.no_grad():
      qs.append(bqt.target_outputs(bqt.target_variables, feats)[
          'q_predicted'])
  oracle = (torch.from_numpy(labels['reward']).ravel() + gamma *
            (1 - done.ravel()) * torch.stack(qs).max(0).values)
  np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-6)


def _draw(tree, rng):
  """Values at fan-in scale for a flax params or batch_stats tree (the
  initializer's std 0.01 would score every candidate about 0.5)."""
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


def _flagship_next_batch(batch, seed):
  rng = np.random.RandomState(seed)
  features = {
      'next/state/image': rng.randint(0, 256, (batch, 512, 640, 3)).astype(
          np.uint8),
      'next/action/gripper_closed': rng.randint(0, 2, (batch, 1)).astype(
          np.float32),
      'next/action/height_to_bottom': rng.uniform(0, 1.6, (batch, 1)).astype(
          np.float32),
      'done': np.asarray([[0.], [1.], [0.]][:batch], np.float32)}
  labels = {'reward': np.asarray([[0.], [1.], [1.]][:batch], np.float32)}
  return features, labels


def _flagship_weights(ref, seed):
  jax_model = getattr(ref.t2r_models, _CRITIC)(
      device_type='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  rng = np.random.RandomState(0)
  init = {'state/image': rng.uniform(0, 1, (1, 472, 472, 3)).astype(
      np.float32)}
  for key, size in grasping_sim.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    init['action/' + key] = np.zeros((1, size), np.float32)
  shapes = jax.tree_util.tree_map(np.asarray, jax_model.create_network().init(
      jax.random.PRNGKey(0), init, mode='predict', train=False))
  draws = np.random.RandomState(seed)
  variables = {'params': _draw(shapes['params'], draws),
               'batch_stats': _draw(shapes['batch_stats'], draws)}
  # Logits out of the sigmoid's saturation: the max over candidates is
  # decided by the scores, not by rounding.
  variables['params']['grasping44']['logit']['kernel'] *= 0.1
  return jax_model, variables


def _port_flagship(tmp_path, **kwargs):
  model = getattr(t2r_models, _CRITIC)(
      device='cpu', use_avg_model_params=False,
      network_kwargs={'num_convs': (1, 1, 1)},
      optimizer_override=lambda: optimizers.create_adam_optimizer(3e-3),
      **kwargs)
  trainer = Trainer(model, str(tmp_path / 'flagship'),
                    save_checkpoints_steps=10**9, log_every_n_steps=10**9,
                    write_metrics=False)
  return model, trainer


def test_bellman_targets_on_a_narrow_flagship_match_jax(ref, tmp_path):
  """The Grasping44 critic (num_convs (1, 1, 1)) at the camera's 512x640,
  its PREDICT crop and a TRAIN-mode target over 3 states x 3 candidates."""
  k, gamma = 3, grasping_sim.GAMMA
  features, labels = _flagship_next_batch(3, seed=5)
  arrays = _candidate_arrays(3, k, seed=6)
  jax_model, variables = _flagship_weights(ref, seed=7)
  jax_bqt = ref.offpolicy.BellmanQTOptTrainer(
      jax_model, types.SimpleNamespace(model_dir=str(tmp_path / 'jax'),
                                       mesh=None),
      _jax_candidates(arrays, k), num_candidates=k, gamma=gamma)
  _, jax_next, jax_done = ref.offpolicy.split_offpolicy_batch(features)
  want = np.asarray(jax_bqt.bellman_targets(
      variables, jax_next, labels['reward'], jax_done,
      jax.random.PRNGKey(0)))

  model, trainer = _port_flagship(tmp_path)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, _port_candidates(arrays, k), num_candidates=k,
      gamma=gamma)
  target = {'params': model.to_device(convert.from_flax(variables)['params'])}
  before = {k_: v.clone() for k_, v in target['params'].items()}
  _, next_features, done = offpolicy.split_offpolicy_batch(
      {key: torch.from_numpy(v) for key, v in features.items()})
  got = bqt.bellman_targets(target, next_features,
                            torch.from_numpy(labels['reward']), done,
                            bqt.candidate_generator(0))
  np.testing.assert_allclose(got.numpy(), want, atol=TARGET_ATOL)
  assert float(got[1]) == 1.0   # done: the reward alone
  # The TRAIN-mode forward left the target's running statistics (and every
  # other tensor) as they were.
  for name, value in target['params'].items():
    assert torch.equal(value, before[name]), name
  # It normalized with the batch's statistics, not the running ones.
  bqt._target_forward_mode = ModeKeys.PREDICT
  predict = bqt.bellman_targets(target, next_features,
                                torch.from_numpy(labels['reward']), done,
                                bqt.candidate_generator(0))
  assert float((predict - got).abs().max()) > 1e-4


def test_done_transitions_use_reward_only(tmp_path):
  features, labels = _random_batch(seed=2)
  features['done'] = np.ones((BATCH, 1), np.float32)
  model, trainer = _port_sim(tmp_path)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, grasping_sim.make_candidate_actions_fn(4),
      num_candidates=4, gamma=0.9, target_update_steps=10**9)
  bqt.seed_target(trainer.init_state())
  (device_features, device_labels) = bqt.put_batch(
      {'features': features, 'labels': labels})
  _, next_features, done = offpolicy.split_offpolicy_batch(device_features)
  y = bqt.bellman_targets(bqt.target_variables, next_features,
                          device_labels['reward'], done,
                          bqt.candidate_generator(3))
  np.testing.assert_array_equal(y.numpy(), labels['reward'].ravel())


def test_one_bellman_step_matches_jax(ref, tmp_path):
  """y, the loss and every updated weight of one whole step (the target
  seeded from the same initial weights, the same 2 fixed candidates)."""
  features, labels = _random_batch(seed=3)
  jax_model, jax_trainer, jax_state = _jax_sim(ref, tmp_path, features,
                                               labels)
  fixed = np.stack([grasping_sim._action_vector(wv_z=1.0, close=0.0),
                    grasping_sim._action_vector(wv_z=0.0, close=1.0)])
  arrays, offset = {}, 0
  for key, size in grasping_sim.ACTION_DIM_LAYOUT:
    arrays['action/' + key] = np.tile(fixed[:, offset:offset + size],
                                      (BATCH, 1))
    offset += size
  initial = _port_state(jax_state)
  jax_bqt = ref.offpolicy.BellmanQTOptTrainer(
      jax_model, jax_trainer, _jax_candidates(arrays, 2), num_candidates=2,
      gamma=grasping_sim.GAMMA, target_update_steps=10**9)
  jax_bqt.seed_target(jax_state)
  _, jax_next, jax_done = ref.offpolicy.split_offpolicy_batch(features)
  want_y = np.asarray(jax_bqt.bellman_targets(
      jax_bqt.target_variables, jax_next, labels['reward'], jax_done,
      jax.random.PRNGKey(0)))
  jax_state, jax_metrics = jax_bqt.train_step(
      jax_state, {'features': features, 'labels': labels},
      jax.random.PRNGKey(1))
  want = _port_state(jax_state)
  jax_trainer.close()

  model, trainer = _port_sim(tmp_path)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, _port_candidates(arrays, 2), num_candidates=2,
      gamma=grasping_sim.GAMMA, target_update_steps=10**9)
  bqt.seed_target(initial)
  device_features, device_labels = bqt.put_batch(
      {'features': features, 'labels': labels})
  state, metrics, y = bqt.step(initial, device_features, device_labels)
  np.testing.assert_allclose(y.numpy(), want_y, atol=TARGET_ATOL)
  np.testing.assert_allclose(float(metrics['bellman_target_mean']),
                             float(jax_metrics['bellman_target_mean']),
                             atol=TARGET_ATOL)
  loss, want_loss = float(metrics['loss']), float(jax_metrics['loss'])
  assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
  assert state.step == want.step == 1
  lr, eps, moved = 3e-3, 1e-8, 0
  for name, value in want.params.items():
    # Adam's first moment after one step is 0.1 of the gradient: the
    # gradients within GRAD_RTOL of each tensor's largest (float32 sums in
    # another order).
    grad = want.opt_state['mu'][name].numpy() / 0.1
    got_grad = state.opt_state['mu'][name].numpy() / 0.1
    tolerance = GRAD_RTOL * float(np.abs(grad).max())
    assert np.abs(got_grad - grad).max() <= tolerance, name
    # The weights: Adam's first step is lr g / (|g| + eps), whose slope in g
    # is at most lr eps / (|g| - tolerance + eps) ** 2 over the gradients
    # that tolerance allows, and which never moves a weight by more than
    # lr; plus the float32 roundings of the step (a few spacings of lr) and
    # of the subtraction (one spacing of the weight).
    slack = np.maximum(np.abs(grad) - tolerance, 0.0) + eps
    bound = (np.minimum(2 * lr, lr * eps * tolerance / slack ** 2) +
             4 * np.spacing(np.float32(lr)) +
             np.spacing(np.abs(value.numpy())))
    error = np.abs(state.params[name].numpy() - value.numpy())
    worst = np.max(error - bound)
    assert worst <= 0, (name, worst)
    moved += int((np.abs(value.numpy() - initial.params[name].numpy()) >
                  1e-3).sum())
  assert moved > 1000


def test_target_lags_one_export_interval(tmp_path):
  """The target equals the live weights of the previous export, never the
  current ones (JAX's ``TestLaggedTarget``)."""
  features, labels = _random_batch(seed=3)
  model, trainer = _port_sim(tmp_path)
  interval = 3
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, grasping_sim.make_candidate_actions_fn(4),
      num_candidates=4, gamma=0.8, target_update_steps=interval)
  state = trainer.init_state()
  live_at = {}
  batch = {'features': features, 'labels': labels}
  name = 'Dense_0.weight'
  for _ in range(3 * interval):
    state, _ = bqt.train_step(state, batch)
    live_at[state.step] = state.params[name].clone()
    target = bqt.target_variables['params'][name]
    if state.step < 2 * interval:
      # Before the second export the target is the seeded initial weights.
      assert not torch.allclose(target, live_at[state.step])
    else:
      expected = (state.step // interval - 1) * interval
      assert torch.equal(target, live_at[expected])
      assert not torch.allclose(target, live_at[state.step])
  assert bqt.refreshes == 3 * interval // interval - 1
  assert len(export_generators.list_exported_versions(
      bqt.lagged_export_dir)) == 3


def test_off_interval_steps_do_not_poll_the_exports(tmp_path, monkeypatch):
  features, labels = _random_batch(seed=5)
  model, trainer = _port_sim(tmp_path)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, grasping_sim.make_candidate_actions_fn(2),
      num_candidates=2, gamma=0.8, target_update_steps=4)
  state = trainer.init_state()
  batch = {'features': features, 'labels': labels}
  state, _ = bqt.train_step(state, batch)   # seeds the target
  polls = []
  listing = export_generators.list_exported_versions
  monkeypatch.setattr(export_generators, 'list_exported_versions',
                      lambda root: polls.append(root) or listing(root))
  for _ in range(2):
    state, _ = bqt.train_step(state, batch)
  assert polls == []
  state, _ = bqt.train_step(state, batch)   # step 4: export and refresh
  assert state.step == 4 and polls and bqt.refreshes == 0


def test_candidates_are_the_steps_own_draws(tmp_path):
  """Step k's candidates come from (seed + 1, k): the same step draws the
  same targets in another trainer, another step other ones."""
  features, labels = _random_batch(seed=6)
  ys = []
  for name in ('a', 'b'):
    model, trainer = _port_sim(tmp_path, name)
    bqt = offpolicy.BellmanQTOptTrainer(
        model, trainer, grasping_sim.make_candidate_actions_fn(4),
        num_candidates=4, gamma=0.8)
    state = trainer.init_state()
    bqt.seed_target(state)
    f, l = bqt.put_batch({'features': features, 'labels': labels})
    _, next_features, done = offpolicy.split_offpolicy_batch(f)
    ys.append([bqt.bellman_targets(bqt.target_variables, next_features,
                                   l['reward'], done,
                                   bqt.candidate_generator(step))
               for step in (0, 1)])
  assert torch.equal(ys[0][0], ys[1][0]) and torch.equal(ys[0][1], ys[1][1])
  assert not torch.equal(ys[0][0], ys[0][1])


def test_ranking_helpers_match_jax(ref):
  rng = np.random.RandomState(0)
  pairs = [({'x': rng.randn(n, 2), 'a': np.ones((n, 1))},
            {'x': rng.randn(n, 2), 'a': np.zeros((n, 1))})
           for n in (3, 5, 4)]
  got, got_rows = offpolicy.concat_ranking_pairs(pairs)
  want, want_rows = ref.offpolicy.concat_ranking_pairs(pairs)
  assert got_rows == want_rows == [3, 3, 5, 5, 4, 4]
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])
  for seed in range(5):
    scores = np.random.RandomState(seed).randn(sum(got_rows))
    assert (offpolicy.ranking_accuracy_from_scores(scores, got_rows) ==
            ref.offpolicy.ranking_accuracy_from_scores(scores, got_rows))

    def q_fn(features, seed=seed):
      return (features['x'] @ np.random.RandomState(seed).randn(2) +
              features['a'][:, 0])

    assert (offpolicy.pairwise_ranking_accuracy(q_fn, pairs) ==
            ref.offpolicy.pairwise_ranking_accuracy(q_fn, pairs))
  assert offpolicy.concat_ranking_pairs([]) == ({}, [])
  with pytest.raises(ValueError, match='one score per row'):
    offpolicy.ranking_accuracy_from_scores(np.zeros(3), got_rows)


def _batch_stat_critic(features):
  """Q = the batch-normalized action column: a feature constant within a
  forward batch contributes exactly 0."""
  x = np.concatenate([features['state'], features['action']], axis=1)
  return (x - x.mean(axis=0, keepdims=True))[:, -1]


def test_ranking_takes_both_arms_in_one_forward():
  """Per arm, batch statistics would erase each arm's constant action:
  the helper scores every arm in one call, and ranks all 6 pairs right."""
  rng = np.random.RandomState(0)
  pairs = []
  for _ in range(6):
    state = rng.randn(8, 3).astype(np.float32)
    pairs.append(({'state': state, 'action': np.ones((8, 1), np.float32)},
                  {'state': state, 'action': np.zeros((8, 1), np.float32)}))
  calls = []

  def critic(features):
    calls.append(int(features['action'].shape[0]))
    return torch.from_numpy(_batch_stat_critic(features))

  assert offpolicy.pairwise_ranking_accuracy(critic, pairs) == 1.0
  assert calls == [96]
  per_arm = [(_batch_stat_critic(b) > _batch_stat_critic(w)).mean()
             for b, w in pairs]
  assert max(per_arm) == 0.0


def test_tile_state_for_action_batch_matches_jax(ref):
  class Critic(critic_model.CriticModel):
    pass

  features = {'state/image': np.arange(12, dtype=np.float32).reshape(2, 6),
              'action/a': np.arange(6, dtype=np.float32).reshape(6, 1)}
  jax_critic = type('JaxCritic', (ref.critic_model.CriticModel,), {
      'get_state_specification': lambda self: None,
      'get_action_specification': lambda self: None,
      'get_label_specification': lambda self, mode: None,
      'create_network': lambda self: None})
  for k in (None, 3):
    got = Critic(action_batch_size=k, device='cpu').\
        tile_state_for_action_batch(
            {key: torch.from_numpy(v) for key, v in features.items()})
    want = jax_critic(action_batch_size=k).tile_state_for_action_batch(
        ref.struct.SpecStruct(**features))
    for key in features:
      np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
  assert tuple(got['state/image'].shape) == (6, 6)


@pytest.fixture(scope='module')
def sim_replay(tmp_path_factory):
  """150 random-policy episodes at 48x64 from SimGraspingEnv(seed=0),
  written by the port's collector (JAX's test's replay: the same records,
  test_torch_grasping_sim.py)."""
  root = str(tmp_path_factory.mktemp('replay'))
  run_agent = functools.partial(
      run_env_lib.run_env,
      episode_to_transitions_fn=grasping_sim.episode_to_transitions_grasping,
      replay_writer=TFRecordReplayWriter(), close_env=False)
  collect_eval.collect_eval_loop(
      collect_env=grasping_sim.SimGraspingEnv(height=HEIGHT, width=WIDTH,
                                              seed=0),
      eval_env=None,
      policy_class=lambda: grasping_sim.SimGraspingRandomPolicy(seed=0),
      num_collect=150, num_eval=0, run_agent_fn=run_agent, root_dir=root,
      init_with_random_variables=True)
  records = glob.glob(os.path.join(root, 'policy_collect', '*'))
  assert records
  return records


def _train(tmp_path, records, target_update_steps, max_steps, name):
  """JAX's ``TestOffPolicyLearning._train`` on the port: returns (ranking
  accuracy, per family, the one-step-out descend arm's mean Q, refreshes).
  """
  model, trainer = _port_sim(tmp_path, name)
  spec = dict(model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN))
  spec.update(grasping_sim.offpolicy_extra_feature_specs(spec['state/image']))
  parser = ExampleParser(spec, model.preprocessor.get_in_label_specification(
      ModeKeys.TRAIN))
  stream = iter(BatchedExampleStream(RecordDataset(records), parser,
                                     batch_size=32, shuffle=True, seed=0))
  state = trainer.init_state()
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, grasping_sim.make_candidate_actions_fn(8),
      num_candidates=8, gamma=grasping_sim.GAMMA,
      target_update_steps=target_update_steps)
  pairs = grasping_sim.build_ranking_pairs(
      grasping_sim.SimGraspingEnv(height=HEIGHT, width=WIDTH, seed=9),
      per_type=24)

  def q_fn(features, state):
    feats, _ = model.preprocessor.preprocess(
        {k: torch.as_tensor(v) for k, v in features.items()}, None,
        ModeKeys.PREDICT)
    with torch.no_grad():
      return torch.func.functional_call(
          model.network, {**state.params, **state.model_state}, (feats,),
          {'mode': ModeKeys.TRAIN})['q_predicted']

  for step in range(max_steps):
    features, labels = next(stream)
    state, _ = bqt.train_step(state, {'features': features,
                                      'labels': labels})
    if step >= 20 and (step + 1) % 10 == 0:
      q = functools.partial(q_fn, state=state)
      if (offpolicy.pairwise_ranking_accuracy(q, pairs) >= 0.95 and
          float(q(pairs[1][0]).mean()) >= 0.65):
        break
  q = functools.partial(q_fn, state=state)
  per_family = [offpolicy.pairwise_ranking_accuracy(q, [p]) for p in pairs]
  return (offpolicy.pairwise_ranking_accuracy(q, pairs), per_family,
          float(q(pairs[1][0]).mean()), bqt.refreshes)


def test_learns_the_analytic_ordering_with_the_lagged_target(tmp_path,
                                                             sim_replay,
                                                             one_thread):
  acc, per_family, fam2_q, refreshes = _train(
      tmp_path, sim_replay, target_update_steps=8, max_steps=240,
      name='lagged')
  assert refreshes >= 2, 'the target never turned over'
  assert acc >= 0.9, per_family
  # The depth-2 family orders only after two target generations.
  assert per_family[2] >= 0.8, per_family
  # The one-step-out descend arm's value itself, near gamma (0.8).
  assert fam2_q >= 0.6, fam2_q


def test_a_frozen_target_cannot_propagate_value(tmp_path, sim_replay,
                                                one_thread):
  """The target never moves past the initial weights: the bootstrapped
  arm stays near gamma * Q_init (about 0.4)."""
  _, _, fam2_q, refreshes = _train(
      tmp_path, sim_replay, target_update_steps=10**9, max_steps=60,
      name='frozen')
  assert refreshes == 0
  assert fam2_q <= 0.55, fam2_q


def test_the_split_decode_unpacks_the_next_frames_too(tmp_path):
  """The flagship (num_convs (1, 1, 1)) under train_qtopt_sparse.gin's
  wrapper, from 512x640 records of the collector through the native
  loader's coef_sparse plan, next/ frames included: two steps, finite."""
  root = str(tmp_path / 'replay')
  run_agent = functools.partial(
      run_env_lib.run_env,
      episode_to_transitions_fn=grasping_sim.episode_to_transitions_grasping,
      replay_writer=TFRecordReplayWriter(), close_env=False)
  collect_eval.collect_eval_loop(
      collect_env=grasping_sim.SimGraspingEnv(seed=0), eval_env=None,
      policy_class=lambda: grasping_sim.SimGraspingRandomPolicy(seed=0),
      num_collect=3, num_eval=0, run_agent_fn=run_agent, root_dir=root,
      init_with_random_variables=True)
  model, trainer = _port_flagship(tmp_path)
  device_decode.wrap_model_with_device_decode(model, wire_format='sparse')
  wrapped = model.preprocessor
  raw = dict(wrapped.raw_in_feature_specification(ModeKeys.TRAIN))
  raw.update(grasping_sim.offpolicy_extra_feature_specs(raw['state/image']))
  plan = native_loader.plan_for_specs(
      raw, wrapped.get_in_label_specification(ModeKeys.TRAIN),
      image_mode='coef_sparse')
  assert plan is not None
  stream = native_loader.NativeBatchedStream(
      plan, glob.glob(os.path.join(root, 'policy_collect', '*')),
      batch_size=2, shuffle=True, seed=0, num_threads=2)
  bqt = offpolicy.BellmanQTOptTrainer(
      model, trainer, grasping_sim.make_candidate_actions_fn(3),
      num_candidates=3, gamma=grasping_sim.GAMMA, target_update_steps=2)
  try:
    batches = iter(stream)
    features, labels = next(batches)
    assert 'next/state/image/sd' in features
    device_features, _ = bqt.put_batch({'features': features,
                                        'labels': labels})
    for key in ('state/image', 'next/state/image'):
      assert tuple(device_features[key + '/y'].shape) == (2, 64, 80, 64)
    state = trainer.init_state()
    for _ in range(2):
      features, labels = next(batches)
      state, metrics = bqt.train_step(state, {'features': features,
                                              'labels': labels})
      assert np.isfinite(float(metrics['loss']))
      assert 0.0 <= float(metrics['bellman_target_mean']) <= 1.0
  finally:
    stream.close()
  assert state.step == 2 and bqt.target_version is not None
