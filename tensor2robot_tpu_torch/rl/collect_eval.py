"""The collect and eval loop: the robot side of off-policy RL (the JAX
package's ``rl/collect_eval.py``).

Polls the policy's predictor for new weights (exported by the trainer's
hooks), runs collect and eval episodes with each new version and writes
their transitions as replay records: the filesystem between actor and
learner.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional

from tensor2robot_tpu_torch.rl import run_env as run_env_lib

__all__ = ['collect_eval_loop']

_POLL_SLEEP_SECS = 10


def collect_eval_loop(collect_env,
                      eval_env,
                      policy_class: Callable,
                      num_collect: int = 2000,
                      num_eval: int = 100,
                      run_agent_fn: Optional[Callable] = None,
                      root_dir: str = '',
                      continuous: bool = False,
                      min_collect_eval_step: int = 0,
                      max_steps: int = 1,
                      pre_collect_eval_fn: Optional[Callable] = None,
                      record_eval_env_video: bool = False,
                      init_with_random_variables: bool = False,
                      poll_sleep_secs: float = _POLL_SLEEP_SECS,
                      max_poll_attempts: Optional[int] = None) -> None:
  """Collects and evaluates a policy against live envs.

  Args:
    collect_env: the env to collect training data from (None: no collect).
    eval_env: the env to evaluate on (None: no eval).
    policy_class: zero-arg factory of the policy.
    num_collect: collect episodes a policy version.
    num_eval: eval episodes a policy version.
    run_agent_fn: in place of ``run_env.run_env``.
    root_dir: ``run_env`` writes ``policy_collect/`` and ``policy_eval/``
      under it.
    continuous: keep polling for newer versions until the step passes
      ``max_steps``.
    min_collect_eval_step: skip versions below this step.
    max_steps: stop once the policy's step reaches this (continuous).
    pre_collect_eval_fn: runs once before the loop.
    record_eval_env_video: route the eval env's video by version.
    init_with_random_variables: random weights instead of a restore.
    poll_sleep_secs: the wait between two polls for a version.
    max_poll_attempts: return after this many polls without a new version
      (None: poll forever).
  """
  if pre_collect_eval_fn:
    pre_collect_eval_fn()
  owns_envs = run_agent_fn is None
  if owns_envs:
    # run_env closes its env after each call by default; keep the envs open
    # across versions and close them once, on the way out.
    run_agent_fn = functools.partial(run_env_lib.run_env, close_env=False)

  try:
    _collect_eval(collect_env, eval_env, policy_class, num_collect, num_eval,
                  run_agent_fn, root_dir, continuous, min_collect_eval_step,
                  max_steps, record_eval_env_video,
                  init_with_random_variables, poll_sleep_secs,
                  max_poll_attempts)
  finally:
    if owns_envs:
      for env in (collect_env, eval_env):
        if env is not None and hasattr(env, 'close'):
          env.close()


def _collect_eval(collect_env, eval_env, policy_class, num_collect, num_eval,
                  run_agent_fn, root_dir, continuous, min_collect_eval_step,
                  max_steps, record_eval_env_video,
                  init_with_random_variables, poll_sleep_secs,
                  max_poll_attempts) -> None:
  policy = policy_class()
  prev_global_step = -1
  attempts = 0
  while True:
    restored = True
    if init_with_random_variables:
      policy.init_randomly()
    else:
      restored = policy.restore()
    global_step = policy.global_step

    # Nothing loaded yet (a restore that timed out), or no newer version:
    # poll again.
    if (restored is False or global_step is None
        or global_step < min_collect_eval_step
        or global_step <= prev_global_step):
      attempts += 1
      if max_poll_attempts is not None and attempts >= max_poll_attempts:
        return
      time.sleep(poll_sleep_secs)
      continue
    attempts = 0

    if collect_env:
      run_agent_fn(collect_env, policy=policy, num_episodes=num_collect,
                   root_dir=root_dir, global_step=global_step,
                   tag='collect')
    if eval_env:
      if record_eval_env_video and hasattr(eval_env, 'set_video_output_dir'):
        eval_env.set_video_output_dir(
            os.path.join(root_dir, 'videos', str(global_step)))
      run_agent_fn(eval_env, policy=policy, num_episodes=num_eval,
                   root_dir=root_dir, global_step=global_step, tag='eval')
    if not continuous or global_step >= max_steps:
      return

    prev_global_step = global_step
