"""The demo -> adaptation -> trial episode loop of meta-RL evaluation (the
JAX package's ``meta_learning/run_meta_env.py``, on the port's
``rl/run_env.py``).

For each task: reset the task, collect demonstration episodes (from a demo
policy, or the env's own task data), ``policy.adapt`` to them, then run
``num_adaptations_per_task`` rounds of trial episodes, adapting again to
the growing condition set each round, so that the reward's rise from
round to round measures the adaptation. Metrics go to
``<root_dir>/live_eval_<task>/metrics-<tag>.jsonl``, as ``run_env``'s do.
"""

from __future__ import annotations

import collections
import copy
import datetime
import logging
import os
from typing import Callable, Optional

import numpy as np

from tensor2robot_tpu_torch.rl.run_env import _write_metrics

__all__ = ['run_meta_env']

_log = logging.info


def run_meta_env(env,
                 policy=None,
                 demo_policy_cls: Optional[Callable] = None,
                 explore_schedule=None,
                 episode_to_transitions_fn: Optional[Callable] = None,
                 replay_writer=None,
                 root_dir: Optional[str] = None,
                 task: int = 0,
                 global_step: int = 0,
                 num_episodes=None,
                 num_tasks: int = 10,
                 num_adaptations_per_task: int = 2,
                 num_episodes_per_adaptation: int = 1,
                 num_demos: int = 1,
                 break_after_one_task: bool = False,
                 tag: str = 'collect',
                 write_summary: bool = False,
                 write_meta_examples: bool = False):
  """Runs ``num_tasks`` tasks (see the module docstring); returns
  ``{task: {round: [episode rewards]}}``.

  ``write_meta_examples``: in place of per-episode transition records,
  each task's episodes as one meta-example record (demos under
  ``condition_ep<i>``, trials under ``inference_ep<i>``), which
  ``MetaExampleInputGenerator`` reads back for MAML training; it needs
  ``episode_to_transitions_fn``, ``replay_writer`` and ``root_dir``.
  ``num_episodes`` is ignored: ``num_tasks`` drives the loop.
  """
  del num_episodes
  if write_meta_examples and episode_to_transitions_fn is None:
    raise ValueError(
        'write_meta_examples requires episode_to_transitions_fn.')

  task_step_rewards = collections.defaultdict(
      lambda: collections.defaultdict(list))
  episode_q_values = collections.defaultdict(list)

  def _run_demo_episode():
    obs = env.reset()
    demo_policy = demo_policy_cls(env)
    episode_data = []
    while True:
      action, _ = demo_policy.sample_action(obs, 0)
      if action is None:
        break
      next_obs, rew, done, debug = env.step(action)
      debug = dict(debug or {})
      debug['is_demo'] = True
      episode_data.append((obs, action, rew, next_obs, done, debug))
      obs = next_obs
      if done:
        break
    return episode_data

  for task_idx in range(num_tasks):
    if hasattr(policy, 'reset_task'):
      policy.reset_task()
    env.reset_task()
    record_name = None
    if root_dir and replay_writer:
      timestamp = datetime.datetime.now().strftime('%Y-%m-%d-%H-%M-%S')
      record_name = os.path.join(root_dir, 'gs{}_t{}_{}_{}'.format(
          global_step, task, timestamp, task_idx))
      os.makedirs(root_dir, exist_ok=True)
      replay_writer.open(record_name)

    condition_data = []
    condition_examples, inference_examples = [], []
    if demo_policy_cls is not None and hasattr(policy, 'adapt'):
      for _ in range(num_demos):
        episode_data = _run_demo_episode()
        condition_data.append(episode_data)
        # Without root_dir the writer was never opened.
        if record_name and episode_to_transitions_fn:
          examples = episode_to_transitions_fn(episode_data)
          if write_meta_examples:
            condition_examples.extend(examples)
          else:
            replay_writer.write(examples)
      policy.adapt(copy.copy(condition_data))
    elif hasattr(env, 'task_data') and hasattr(policy, 'adapt'):
      # Record-backed envs carry their own conditioning episodes.
      for episode_name, episode_data in env.task_data.items():
        if str(episode_name).startswith('condition_ep'):
          condition_data.append(episode_data)
          if write_meta_examples and record_name:
            condition_examples.extend(episode_to_transitions_fn(episode_data))
      policy.adapt(copy.copy(condition_data))

    for step_num in range(num_adaptations_per_task):
      if step_num != 0 and hasattr(policy, 'adapt'):
        policy.adapt(copy.copy(condition_data))
      for ep in range(num_episodes_per_adaptation):
        done, env_step, episode_reward, episode_data = False, 0, 0.0, []
        policy.reset()
        obs = env.reset()
        explore_prob = (explore_schedule.value(global_step)
                        if explore_schedule else 0)
        while not done:
          debug = {}
          action, policy_debug = policy.sample_action(obs, explore_prob)
          if policy_debug is not None:
            debug.update(policy_debug)
          if policy_debug and 'q_predicted' in policy_debug:
            episode_q_values[env_step].append(policy_debug['q_predicted'])
          new_obs, rew, done, env_debug = env.step(action)
          debug.update(env_debug or {})
          env_step += 1
          episode_reward += rew
          episode_data.append((obs, action, rew, new_obs, done, debug))
          obs = new_obs
          if done:
            _log('Step %d episode %d reward: %f', step_num, ep,
                 episode_reward)
            task_step_rewards[task_idx][step_num].append(episode_reward)
            if record_name and episode_to_transitions_fn:
              examples = episode_to_transitions_fn(episode_data)
              if write_meta_examples:
                inference_examples.extend(examples)
              else:
                replay_writer.write(examples)
        condition_data.append(episode_data)
    _log('Task %d avg reward: %f', task_idx,
         np.mean(task_step_rewards[task_idx][num_adaptations_per_task - 1]))

    if write_meta_examples and record_name:
      if not condition_examples or not inference_examples:
        # An empty record file would fail in the reader; say why here.
        raise ValueError(
            'write_meta_examples: task {} collected {} condition and {} '
            'inference examples; both sides need at least one (provide a '
            'demo_policy_cls or env.task_data conditioning episodes).'
            .format(task_idx, len(condition_examples),
                    len(inference_examples)))
      from tensor2robot_tpu_torch.meta_learning.meta_example import (
          make_meta_example)
      replay_writer.write(make_meta_example(condition_examples,
                                            inference_examples))
    if replay_writer and record_name:
      replay_writer.close()
    if break_after_one_task:
      break

  if root_dir and write_summary:
    values = {}
    ran_tasks = sorted(task_step_rewards)
    for step_num in range(num_adaptations_per_task):
      step_rewards = [np.mean(task_step_rewards[t][step_num])
                      for t in ran_tasks]
      values['step_{}_reward'.format(step_num)] = float(np.mean(step_rewards))
      if step_num > 0:
        delta = np.mean([
            np.mean(task_step_rewards[t][step_num]) -
            np.mean(task_step_rewards[t][step_num - 1]) for t in ran_tasks])
        values['step_{}_improvement'.format(step_num)] = float(delta)
    for step, q_values in episode_q_values.items():
      values['Q/{}'.format(step)] = float(np.mean(q_values))
    _write_metrics(os.path.join(root_dir, 'live_eval_{}'.format(task)), tag,
                   global_step, values)
  return task_step_rewards
