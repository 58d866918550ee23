"""Step a policy through a Gym-style environment, writing its transitions
and its episode metrics (the JAX package's ``rl/run_env.py``).

Each episode's ``(obs, action, reward, next_obs, done, debug)`` steps go to
``episode_to_transitions_fn`` and the replay writer, under
``<root_dir>/policy_<tag>/gs<step>_t<task>_<timestamp>``; the mean episode
reward and the mean Q a policy reports at each step (``debug['q']``) go to
``<root_dir>/live_eval_<task>/metrics-<tag>.jsonl``, one JSON line
``{'step': global_step, 'tag': ..., 'values': {...}}`` a call.
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import os
from typing import Callable, Optional

import numpy as np

__all__ = ['run_env']


def _write_metrics(root_dir: str, tag: str, global_step: int,
                   values: dict) -> None:
  os.makedirs(root_dir, exist_ok=True)
  path = os.path.join(root_dir, 'metrics-{}.jsonl'.format(tag))
  with open(path, 'a') as f:
    f.write(json.dumps({'step': int(global_step), 'tag': tag,
                        'values': values}) + '\n')


def run_env(env,
            policy=None,
            explore_schedule=None,
            episode_to_transitions_fn: Optional[Callable] = None,
            replay_writer=None,
            root_dir: Optional[str] = None,
            task: int = 0,
            global_step: int = 0,
            num_episodes: int = 100,
            tag: str = 'collect',
            close_env: bool = True) -> list:
  """Runs ``policy`` for ``num_episodes`` episodes; returns their rewards.

  Args:
    env: ``reset() -> obs``, ``step(action) -> (obs, reward, done, debug)``.
    policy: ``reset()`` and ``sample_action(obs, explore_prob) -> (action,
      debug)``.
    explore_schedule: optional, ``value(global_step) -> explore_prob``.
    episode_to_transitions_fn: an episode's steps -> serialized records.
    replay_writer: a ``TFRecordReplayWriter`` for them.
    root_dir: where records and metrics go; None saves nothing.
    task: the replica's index; only task 0 writes metrics.
    global_step: the policy's step, in the records' names and the metrics.
    num_episodes: episodes to run.
    tag: 'collect' or 'eval': the records' ``policy_<tag>`` directory.
    close_env: close ``env`` at the end.
  """
  episode_rewards = []
  episode_q_values = collections.defaultdict(list)

  record_prefix = None
  if root_dir and replay_writer:
    timestamp = datetime.datetime.now().strftime('%Y-%m-%d-%H-%M-%S')
    record_prefix = os.path.join(
        root_dir, 'policy_{}'.format(tag),
        'gs{}_t{}_{}'.format(global_step, task, timestamp))
    os.makedirs(os.path.dirname(record_prefix), exist_ok=True)
    replay_writer.open(record_prefix)

  try:
    for ep in range(num_episodes):
      done, env_step, episode_reward, episode_data = False, 0, 0.0, []
      policy.reset()
      obs = env.reset()
      explore_prob = (explore_schedule.value(global_step)
                      if explore_schedule else 0)
      while not done:
        action, policy_debug = policy.sample_action(obs, explore_prob)
        if policy_debug and 'q' in policy_debug:
          episode_q_values[env_step].append(policy_debug['q'])
        new_obs, rew, done, env_debug = env.step(action)
        env_step += 1
        episode_reward += rew
        episode_data.append((obs, action, rew, new_obs, done, env_debug))
        obs = new_obs
        if done:
          logging.info('Episode %d reward: %f', ep, episode_reward)
          episode_rewards.append(episode_reward)
          # Nothing is saved without root_dir: the writer was not opened.
          if record_prefix and episode_to_transitions_fn:
            replay_writer.write(episode_to_transitions_fn(episode_data))
      if episode_rewards and len(episode_rewards) % 10 == 0:
        logging.info('Average %d episodes reward: %f', len(episode_rewards),
                     np.mean(episode_rewards))
  finally:
    if close_env:
      env.close()
    if replay_writer and record_prefix:
      replay_writer.close()

  if root_dir and task == 0 and episode_rewards:
    values = {'episode_reward': float(np.mean(episode_rewards))}
    for step, q_values in episode_q_values.items():
      values['Q/{}'.format(step)] = float(np.mean(q_values))
    _write_metrics(os.path.join(root_dir, 'live_eval_{}'.format(task)),
                   tag, global_step, values)
  return episode_rewards
