"""The RL loop's telemetry vocabulary (``t2r.rl.v1``): a copy of the JAX
package's ``observability/rl_metrics.py``, with the same names.

The actor-learner loop (``rl/loop.py``) reports one ``kind="rl"`` record
each report window; this module holds the record's kind and schema, the
registry series the loop writes and the per-scenario success-spread rule,
so that the JAX package's readers (``doctor``, ``t2r_telemetry``) read the
port's records as its own.

Record fields (every rate is a window delta over ``window_seconds``):

  * ``actor_steps`` / ``actor_steps_per_sec``: acting steps (each advances
    every env slot once).
  * ``env_steps`` / ``env_steps_per_sec``: ``actor_steps * num_envs``.
  * ``episodes`` / ``episodes_per_sec``: episodes completed (terminal or
    timeout) across all slots.
  * ``success_rate`` (window) / ``success_rate_cumulative``: grasp
    successes over completed episodes.
  * ``transitions``: replay records flushed this window.
  * ``learner_steps`` / ``learner_steps_per_sec``: Bellman steps the
    concurrent learner completed.
  * ``actor_version`` / ``learner_version`` / ``swaps`` /
    ``dropped_swaps``: the snapshot version the actor acts under, the
    newest version the learner published, adopted swaps, and polls
    dropped (the ``learner.swap`` fault site; a drop is retried next poll).
  * ``act_step_ms``: mean acting-step wall ms this window.
  * ``act_jit_cache``: the acting program's executable count; the port's
    eager acting step compiles none and reports 1.0 (``rl/loop.py``).
  * ``buckets``: per scenario-difficulty bucket ``{episodes, successes,
    success_rate, window_episodes}`` (cumulative counts, windowed
    activity).
  * ``scenario_success_spread``: max - min cumulative success rate across
    buckets that have completed at least one episode.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

__all__ = ['RL_RECORD_KIND', 'RL_RECORD_SCHEMA',
           'RL_EPISODES_COUNTER', 'RL_SUCCESSES_COUNTER',
           'RL_ENV_STEPS_COUNTER', 'RL_ACTOR_STEPS_COUNTER',
           'RL_LEARNER_STEPS_COUNTER', 'RL_TRANSITIONS_COUNTER',
           'RL_SWAPS_COUNTER', 'RL_DROPPED_SWAPS_COUNTER',
           'RL_ACTOR_VERSION_GAUGE', 'RL_LEARNER_VERSION_GAUGE',
           'RL_ACT_MS_HISTOGRAM', 'ACT_RECOMPILE_GAUGE',
           'scenario_success_spread', 'bucket_table']

RL_RECORD_KIND = 'rl'
RL_RECORD_SCHEMA = 't2r.rl.v1'

# Registry series the loop writes.
RL_EPISODES_COUNTER = 'rl/episodes'          # family, label: bucket
RL_SUCCESSES_COUNTER = 'rl/successes'        # family, label: bucket
RL_ENV_STEPS_COUNTER = 'rl/env_steps'
RL_ACTOR_STEPS_COUNTER = 'rl/actor_steps'
RL_LEARNER_STEPS_COUNTER = 'rl/learner_steps'
RL_TRANSITIONS_COUNTER = 'rl/transitions'
RL_SWAPS_COUNTER = 'rl/swaps'
RL_DROPPED_SWAPS_COUNTER = 'rl/dropped_swaps'
RL_ACTOR_VERSION_GAUGE = 'rl/actor_param_version'
RL_LEARNER_VERSION_GAUGE = 'rl/learner_param_version'
RL_ACT_MS_HISTOGRAM = 'rl/act_step_ms'
# The acting program's executable count (1.0 in the port: see rl/loop.py).
ACT_RECOMPILE_GAUGE = 'recompiles/act_step'


def scenario_success_spread(
    buckets: Mapping[str, Mapping[str, float]]) -> Optional[float]:
  """max - min cumulative success rate across active buckets.

  ``buckets`` is the record's per-bucket table; only buckets with at
  least one completed episode participate. Returns None until two
  buckets are active (a spread over one point is not a spread).
  """
  rates = [float(entry.get('success_rate', 0.0))
           for entry in buckets.values()
           if float(entry.get('episodes', 0)) > 0]
  if len(rates) < 2:
    return None
  return max(rates) - min(rates)


def bucket_table(episodes: Mapping[int, int],
                 successes: Mapping[int, int],
                 window_episodes: Optional[Mapping[int, int]] = None
                 ) -> Dict[str, Dict[str, float]]:
  """The record's ``buckets`` field from cumulative per-bucket counts."""
  table: Dict[str, Dict[str, float]] = {}
  for bucket in sorted(episodes):
    count = int(episodes[bucket])
    if count <= 0:
      continue
    wins = int(successes.get(bucket, 0))
    entry = {'episodes': count, 'successes': wins,
             'success_rate': round(wins / count, 4)}
    if window_episodes is not None:
      entry['window_episodes'] = int(window_episodes.get(bucket, 0))
    table[str(bucket)] = entry
  return table
