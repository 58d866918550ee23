"""The port's pusher env (``research/pusher_env.py``) against the JAX
package's: the env and both policies bit for bit from the same seeds, the
transitions' bytes, the Q-net on converted weights, and JAX's learning
test (collect 80 random episodes, train the critic 200 steps at batch 64,
then the critic policy beats random by 0.4 over 30 episodes) on the CPU."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensor2robot_tpu.research import pusher_env as jax_pusher
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.research import pusher_env


class _Scorer:
  """A predictor stand-in: q = -|action - a fixed target|, the same on
  both sides."""

  def predict(self, features):
    target = np.asarray(features['state/obs'])[:, 4:6]
    return {'q_predicted': -np.abs(np.asarray(features['action/force']) -
                                   target).sum(-1)}


def _rollout(module, policy, seed, episodes=3):
  env = module.PusherEnv(seed=seed)
  steps = []
  for _ in range(episodes):
    obs, done = env.reset(), False
    while not done:
      action, debug = policy.sample_action(obs, 0.0)
      obs, reward, done, _ = env.step(action)
      steps.append((obs, reward, done, np.asarray(action), debug))
  return steps


def test_env_and_policies_bit_equal_to_jax():
  for make in (lambda m: m.PusherRandomPolicy(seed=3),
               lambda m: m.PusherCriticPolicy(_Scorer(), num_samples=16,
                                              seed=4)):
    got = _rollout(pusher_env, make(pusher_env), seed=2)
    want = _rollout(jax_pusher, make(jax_pusher), seed=2)
    assert len(got) == len(want) == 24
    for (o1, r1, d1, a1, g1), (o2, r2, d2, a2, g2) in zip(got, want):
      np.testing.assert_array_equal(o1, o2)
      np.testing.assert_array_equal(a1, a2)
      assert (r1, d1, g1) == (r2, d2, g2)
  env = pusher_env.PusherEnv(seed=0, noise_std=0.0)
  env.reset()
  env.step([1.0, 0.0])
  v1 = env._v[0]
  env.step([1.0, 0.0])
  assert env._v[0] > v1 > 0   # momentum
  for _ in range(30):
    env._t = 0
    env.step([1.0, 0.0])
  assert env._p[0] == 1.0 and env._v[0] == 0.0   # inelastic contact


def test_transitions_bytes_equal_to_jax():
  rng = np.random.RandomState(5)
  episode = [(rng.randn(6).astype(np.float32), rng.uniform(-1, 1, 2),
              float(rng.rand()), rng.randn(6).astype(np.float32), t == 3, {})
             for t in range(4)]
  assert (pusher_env.episode_to_transitions_pusher(episode) ==
          jax_pusher.episode_to_transitions_pusher(episode))


def test_qnet_on_converted_weights_matches_flax():
  net = jax_pusher._PusherQNet()
  rng = np.random.RandomState(6)
  features = {'state/obs': rng.randn(32, 6).astype(np.float32),
              'action/force': rng.uniform(-1, 1, (32, 2)).astype(np.float32)}
  variables = jax.tree_util.tree_map(np.asarray, dict(net.init(
      jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in
                              features.items()})))
  want = net.apply(variables, {k: jnp.asarray(v) for k, v in
                               features.items()})
  model = pusher_env.PusherCriticModel(device='cpu')
  got = model.inference_network_fn(
      convert.from_flax(variables),
      {k: torch.tensor(v) for k, v in features.items()}, 'eval')
  for key in ('q_logits', 'q_predicted'):
    np.testing.assert_allclose(got[key].detach().numpy(),
                               np.asarray(want[key]), atol=1e-6, rtol=0)


def test_trained_critic_policy_beats_random(tmp_path):
  """JAX's learning test (tests/test_pusher.py) through the port: its
  collect loop and writer, the trainer from the records, the checkpoint
  predictor; JAX's sizes, seeds and bar."""
  from tensor2robot_tpu_torch.data.input_generators import (
      DefaultRecordInputGenerator)
  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu_torch.models import optimizers
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor)
  from tensor2robot_tpu_torch.rl.collect_eval import collect_eval_loop
  from tensor2robot_tpu_torch.rl.run_env import run_env
  from tensor2robot_tpu_torch.trainer.train_eval import Trainer

  root = str(tmp_path / 'cycle')
  collect_eval_loop(
      collect_env=pusher_env.PusherEnv(seed=2), eval_env=None,
      policy_class=lambda: pusher_env.PusherRandomPolicy(seed=3),
      num_collect=80, num_eval=0,
      run_agent_fn=functools.partial(
          run_env,
          episode_to_transitions_fn=pusher_env.episode_to_transitions_pusher,
          replay_writer=TFRecordReplayWriter(), close_env=False),
      root_dir=root)
  assert glob.glob(os.path.join(root, 'policy_collect', '*'))
  model = pusher_env.PusherCriticModel(
      device='cpu', create_optimizer_fn=functools.partial(
          optimizers.create_adam_optimizer, learning_rate=3e-3))
  model_dir = str(tmp_path / 'run')
  trainer = Trainer(model, model_dir, save_checkpoints_steps=200)
  trainer.train(DefaultRecordInputGenerator(
      file_patterns=os.path.join(root, 'policy_collect', '*'),
      batch_size=64), max_train_steps=200)
  trainer.close()

  def mean_reward(policy, seed):
    return float(np.mean(run_env(pusher_env.PusherEnv(seed=seed),
                                 policy=policy, num_episodes=30, tag='eval',
                                 root_dir=None, close_env=True)))

  predictor = CheckpointPredictor(pusher_env.PusherCriticModel(device='cpu'),
                                  model_dir, timeout=5.0)
  critic_policy = pusher_env.PusherCriticPolicy(predictor, seed=4)
  assert critic_policy.restore() and critic_policy.global_step == 200
  trained = mean_reward(critic_policy, seed=100)
  rand = mean_reward(pusher_env.PusherRandomPolicy(seed=5), seed=100)
  assert trained > rand + 0.4, (trained, rand)
