"""The live QT-Opt cycle: an actor and a concurrent learner on one card (the
JAX package's ``rl/loop.py``).

  * **Actor** (the calling thread): one acting step (``make_act_step``)
    runs the CEM selector over every env slot at once (each slot its own
    CEM, batched where JAX vmaps), mixes in random actions by epsilon
    exploration, and advances the B env slots with auto-reset. It acts
    under an immutable ``(version, variables)`` snapshot that it swaps
    between acting steps, never inside one.
  * **Replay**: a finished episode's transitions are appended as replay
    records (``replay/wire.py``) through a replay client; timeouts carry
    ``done=0`` (bootstrap through the time limit), terminals ``done=1``.
  * **Learner** (a daemon thread): the Bellman trainer (``rl/offpolicy.py``)
    trains from batches sampled back through ``ReplayBatchIterator`` and
    publishes detached clones of its weights, the batch norm statistics
    included, every ``publish_every_steps``; the actor polls every
    ``swap_poll_steps`` acting steps. The ``learner.swap`` fault site drops
    one poll, and the next adopts the snapshot.
  * **Telemetry**: a ``kind="rl"`` (``t2r.rl.v1``) record every report
    window (``observability/rl_metrics.py``) and heartbeats, which the JAX
    package's ``doctor`` reads; while the actor is quiet the learner writes
    stand-in windows.

Both sides queue their work on the card's default stream, so their kernels
run one after the other: a snapshot's clones are queued before the publish,
and so complete before any forward the actor queues after adopting it.

Left out, and kept out on purpose: the loop's ``Watchdog`` and
``AutoProfiler`` (the port has neither), and ``artifact_workload``, the
JAX package's XLA compile cache for the acting program: eager PyTorch
compiles no acting program, so setting it raises.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import TelemetryLogger, get_registry
from tensor2robot_tpu_torch.observability import rl_metrics
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.replay import wire as replay_wire
from tensor2robot_tpu_torch.replay.client import LocalReplayClient, ReplayClient
from tensor2robot_tpu_torch.replay.feed import ReplayBatchIterator
from tensor2robot_tpu_torch.replay.service import ReplayEmpty, ReplayService
from tensor2robot_tpu_torch.research.qtopt.grasping_sim import CLOSE_INDEX
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    ACTION_DIM_LAYOUT,
    CEM_ACTION_SIZE,
)
from tensor2robot_tpu_torch.utils import cross_entropy

__all__ = ['ACT_SEED_STRIDE', 'RLLoop', 'RLLoopConfig', 'ParamBus',
           'build_grasping_loop', 'build_transition_record',
           'make_act_step', 'make_cem_select_fn']

_STATUS_KEYS = ('gripper_closed', 'height_to_bottom')
# Acting step i draws from the generator seeded (seed * ACT_SEED_STRIDE + i):
# a stream a step, as JAX folds the step into the loop's key.
ACT_SEED_STRIDE = 1 << 32
# The env's first reset is seeded (seed + ENV_RESET_SEED_OFFSET).
ENV_RESET_SEED_OFFSET = 1 << 16


@dataclasses.dataclass
class RLLoopConfig:
  """Knobs of one loop.

  Attributes:
    cem_samples / cem_iters / num_elites: the per-slot CEM budget.
    explore_prob: per-slot probability that an acting step takes a random
      action instead of the CEM argmax (epsilon exploration).
    explore_close_prob: close-gripper probability of a random action.
    batch_size: the learner's batch (and the replay sample's size).
    num_candidates: K of the Bellman target's max (``rl/offpolicy.py``).
    gamma: the discount.
    target_update_steps: the lagged target's export interval.
    publish_every_steps: the learner's snapshot cadence.
    swap_poll_steps: the actor's weight-poll cadence (acting steps).
    min_resident_examples: the replay occupancy the learner waits for
      before its first step.
    report_interval_s: the cadence of ``t2r.rl.v1`` windows.
    artifact_workload: the JAX package's compile cache of the acting
      program; the port compiles none, and a workload set here raises.
    seed: all loop-side randomness.
  """

  cem_samples: int = 16
  cem_iters: int = 2
  num_elites: int = 4
  explore_prob: float = 0.15
  explore_close_prob: float = 0.4
  batch_size: int = 16
  num_candidates: int = 16
  gamma: float = 0.8
  target_update_steps: int = 20
  publish_every_steps: int = 10
  swap_poll_steps: int = 4
  min_resident_examples: int = 32
  report_interval_s: float = 5.0
  artifact_workload: Optional[str] = None
  seed: int = 0


class ParamBus:
  """One-slot atomic ``(version, variables)`` hand-off, learner to actor.

  The pair is one immutable tuple assigned at once, so that a reader never
  sees version N with version M's weights. The learner publishes clones:
  its live tensors are never read by the actor.
  """

  def __init__(self):
    self._snapshot: Tuple[int, Optional[Any]] = (0, None)

  def publish(self, version: int, variables) -> None:
    self._snapshot = (int(version), variables)

  @property
  def snapshot(self) -> Tuple[int, Optional[Any]]:
    return self._snapshot

  @property
  def version(self) -> int:
    return self._snapshot[0]


def make_cem_select_fn(model, cem_samples: int = 16, cem_iters: int = 2,
                       num_elites: int = 4, network=None):
  """A CEM selector over every env slot at once, for any critic with the
  flagship's feature keys (the sim critic too).

  Returns ``select(variables, obs, generator=None, noise=None) -> (action
  [B, 8], q [B])``, ``obs`` = {'image' uint8 [B, H, W, 3],
  'gripper_closed' [B], 'height_to_bottom' [B]} (the env's observation).
  The frames are preprocessed once (PREDICT: the flagship's center crop),
  then each of the ``cem_iters`` iterations and the chosen action's score
  run the whole PREDICT network over the B frames
  and their B x samples candidates (the critic's megabatch), as the JAX
  selector does. The CEM noise [cem_iters, B, cem_samples, 8] comes from
  ``generator`` (on the model's device), or ``noise`` replaces it.

  ``network`` is the module the weights are called through (the model's
  own by default). ``torch.func.functional_call`` swaps a module's tensors
  while it runs, so two threads must not call through one module: the
  loop's actor has a copy of its own.
  """
  network = model.network if network is None else network

  def select(variables, obs, generator=None, noise=None):
    device = model.device
    with torch.no_grad():
      images = torch.as_tensor(obs['image']).to(device)
      batch = images.shape[0]
      status = {key: torch.as_tensor(obs[key]).to(
          device, torch.float32).reshape(batch, 1) for key in _STATUS_KEYS}
      placeholder = {'state/image': images}
      for key, size in ACTION_DIM_LAYOUT:
        placeholder['action/' + key] = torch.zeros((batch, size),
                                                   device=device)
      placeholder.update({'action/' + key: value
                          for key, value in status.items()})
      processed, _ = model.preprocessor.preprocess(placeholder, None,
                                                   ModeKeys.PREDICT)
      image = processed['state/image']

      def objective(samples):  # [B, S, 8] -> [B, S]
        count = samples.shape[1]
        flat = samples.reshape(batch * count, CEM_ACTION_SIZE)
        features = {'state/image': image}
        offset = 0
        for key, size in ACTION_DIM_LAYOUT:
          features['action/' + key] = flat[:, offset:offset + size]
          offset += size
        for key, value in status.items():
          features['action/' + key] = value.repeat_interleave(count, dim=0)
        outputs = torch.func.functional_call(
            network, model.select_params(variables), (features,),
            {'mode': ModeKeys.PREDICT}, strict=True)
        return outputs['q_predicted'].reshape(batch, count)

      mean = torch.zeros((batch, CEM_ACTION_SIZE), device=device)
      _, _, best = cross_entropy.normal_cem(
          objective, mean, torch.ones_like(mean), generator,
          num_samples=cem_samples, num_elites=num_elites,
          num_iterations=cem_iters, noise=noise)
      q = objective(best[:, None, :])[:, 0]
    return best, q

  return select


def make_act_step(model, env, cem_samples: int = 16, cem_iters: int = 2,
                  num_elites: int = 4, explore_prob: float = 0.0,
                  explore_close_prob: float = 0.4, network=None):
  """The acting step: select, explore, then step the B envs.

  Returns ``act(variables, env_state, obs, generator=None, draws=None) ->
  (env_state', obs', transition)``; ``transition`` carries what the replay
  writer needs per slot (the acted-from observation, the action, the
  reward, terminal and done, the pre-reset successor, the chosen action's
  q). The draws come from ``generator`` in this order: the CEM noise, the
  uniform exploration actions, their close bits, the explore coins. A test
  hands JAX's instead in ``draws``: ``cem_noise`` [cem_iters, B,
  cem_samples, 8], ``uniform`` [B, 8], ``close`` [B] (0 or 1) and
  ``explore`` [B] bool. ``network``: as ``make_cem_select_fn``'s.
  """
  select = make_cem_select_fn(model, cem_samples=cem_samples,
                              cem_iters=cem_iters, num_elites=num_elites,
                              network=network)
  explore_prob = float(explore_prob)
  num_envs = env.num_envs

  def draw(draws, key, make):
    value = draws.get(key)
    return make() if value is None else torch.as_tensor(value).to(
        model.device)

  def act(variables, env_state, obs, generator=None, draws=None):
    draws = draws or {}
    device = model.device
    action, q = select(variables, obs, generator, draws.get('cem_noise'))
    if explore_prob > 0.0:
      uniform = draw(draws, 'uniform', lambda: torch.rand(
          (num_envs, CEM_ACTION_SIZE), generator=generator,
          device=device) * 2.0 - 1.0).to(torch.float32).clone()
      close = draw(draws, 'close', lambda: (torch.rand(
          (num_envs,), generator=generator, device=device) <
                                            explore_close_prob))
      uniform[:, CLOSE_INDEX] = close.to(torch.float32)
      explore = draw(draws, 'explore', lambda: torch.rand(
          (num_envs,), generator=generator, device=device) < explore_prob)
      action = torch.where(explore.to(torch.bool)[:, None], uniform, action)
    result = env.step(env_state, action)
    next_obs = result.info['next_obs']
    transition = {
        'obs_image': obs['image'],
        'obs_height': obs['height_to_bottom'],
        'action': action,
        'q': q,
        'reward': result.reward,
        'done': result.done,
        'terminal': result.info['terminal'],
        'next_image': next_obs['image'],
        'next_height': next_obs['height_to_bottom'],
    }
    return result.state, result.obs, transition

  return act


def build_transition_record(obs_image: np.ndarray,
                            obs_height: float,
                            action: np.ndarray,
                            reward: float,
                            terminal: bool,
                            next_image: np.ndarray,
                            next_height: float) -> Dict[str, np.ndarray]:
  """One flushed transition as a flat replay-record dict (the JAX
  package's keys and dtypes).

  Keys are ``features/<critic key>`` plus the off-policy extras
  (``features/next/...``, ``features/done``) and ``labels/reward``: what
  ``ReplayBatchIterator`` hands back as the learner's batch. ``done`` on
  the wire is the env's terminal flag, not the episode's end: timeouts
  bootstrap through.
  """
  action = np.asarray(action, np.float32).ravel()
  entries: Dict[str, np.ndarray] = {
      'features/state/image': np.ascontiguousarray(obs_image),
      'features/next/state/image': np.ascontiguousarray(next_image),
      'features/next/action/gripper_closed': np.zeros((1,), np.float32),
      'features/next/action/height_to_bottom': np.asarray(
          [next_height], np.float32),
      'features/done': np.asarray([1.0 if terminal else 0.0], np.float32),
      'labels/reward': np.asarray([reward], np.float32),
  }
  offset = 0
  for key, size in ACTION_DIM_LAYOUT:
    entries['features/action/' + key] = action[offset:offset + size]
    offset += size
  entries['features/action/gripper_closed'] = np.zeros((1,), np.float32)
  entries['features/action/height_to_bottom'] = np.asarray(
      [obs_height], np.float32)
  return entries


def snapshot_variables(state) -> Dict[str, Dict[str, torch.Tensor]]:
  """Detached clones of a train state's serving variables (``params`` and,
  where the model averages, ``avg_params``, each with the batch norm
  statistics): what the learner publishes."""
  return {name: {key: value.detach().clone() for key, value in tree.items()}
          for name, tree in state.variables().items()}


class RLLoop:
  """Actor, learner, swap and telemetry of one run.

  ``model`` / ``trainer`` / ``learner`` are the critic, its ``Trainer`` and
  a ``BellmanQTOptTrainer``; ``env`` a ``VecEnv`` on the critic's device;
  ``client`` a replay client (the append and the sample side). ``run()``
  is the lifecycle.
  """

  def __init__(self,
               model,
               env,
               client,
               trainer,
               learner,
               model_dir: str,
               config: Optional[RLLoopConfig] = None,
               telemetry: Optional[TelemetryLogger] = None,
               registry=None,
               owned_service: Optional[ReplayService] = None):
    self.config = config or RLLoopConfig()
    if self.config.artifact_workload:
      raise NotImplementedError(
          'artifact_workload is the JAX package\'s XLA compile cache of the '
          'acting program; the port runs the acting step eagerly and '
          'compiles no program to cache.')
    self.model = model
    self.env = env
    self.client = client
    self.trainer = trainer
    self.learner = learner
    self.model_dir = model_dir
    self._registry = registry or get_registry()
    self._owns_telemetry = telemetry is None
    self.telemetry = telemetry or TelemetryLogger(model_dir)
    self._owned_service = owned_service
    cfg = self.config
    # The actor calls the weights through a module of its own: the
    # learner's thread calls through the model's.
    self.actor_network = copy.deepcopy(model.network)
    self._act = make_act_step(
        model, env, cem_samples=cfg.cem_samples, cem_iters=cfg.cem_iters,
        num_elites=cfg.num_elites, explore_prob=cfg.explore_prob,
        explore_close_prob=cfg.explore_close_prob,
        network=self.actor_network)
    self._greedy_act = None  # made by measure_success
    self._act_generator = torch.Generator(device=model.device)

    registry = self._registry
    self._episode_counters = registry.counter_family(
        rl_metrics.RL_EPISODES_COUNTER, ('bucket',))
    self._success_counters = registry.counter_family(
        rl_metrics.RL_SUCCESSES_COUNTER, ('bucket',))
    self._env_steps = registry.counter(rl_metrics.RL_ENV_STEPS_COUNTER)
    self._actor_steps = registry.counter(rl_metrics.RL_ACTOR_STEPS_COUNTER)
    self._learner_steps_counter = registry.counter(
        rl_metrics.RL_LEARNER_STEPS_COUNTER)
    self._transitions = registry.counter(rl_metrics.RL_TRANSITIONS_COUNTER)
    self._swap_counter = registry.counter(rl_metrics.RL_SWAPS_COUNTER)
    self._dropped_counter = registry.counter(
        rl_metrics.RL_DROPPED_SWAPS_COUNTER)
    self._actor_version_gauge = registry.gauge(
        rl_metrics.RL_ACTOR_VERSION_GAUGE)
    self._learner_version_gauge = registry.gauge(
        rl_metrics.RL_LEARNER_VERSION_GAUGE)
    self._act_ms = registry.histogram(rl_metrics.RL_ACT_MS_HISTOGRAM)
    self._act_cache_gauge = registry.gauge(rl_metrics.ACT_RECOMPILE_GAUGE)

    # Per-run state, fresh for each run().
    self._stop = threading.Event()
    self._report_lock = threading.Lock()
    self._targets = {'max_episodes': None, 'max_learner_steps': None}
    self._reset_run_state()

  def _reset_run_state(self) -> None:
    """Fresh bookkeeping for a run: a second run() inherits neither the
    first's totals and windows nor its actor version (a stale high version
    would reject every new publish). Registry counters are cumulative over
    the process, so the run reads them as deltas from here."""
    self._actor_version = 0
    self._actor_variables = None
    self._swaps = 0
    self._dropped_swaps = 0
    self._episodes = 0
    self._successes = 0
    self._learner_steps = 0
    self._bucket_episodes: Dict[int, int] = {}
    self._bucket_successes: Dict[int, int] = {}
    self._windows: List[Dict[str, Any]] = []
    self.bus = ParamBus()
    self._counter_base = {
        'env_steps': self._env_steps.value,
        'actor_steps': self._actor_steps.value,
        'transitions': self._transitions.value,
    }
    # The shared report marks (the actor's windows and the learner's
    # stand-ins): when the last window landed, and the learner steps it
    # covered.
    self._last_report_mark = time.perf_counter()
    self._learner_steps_at_report = 0
    self._learner_errors: List[BaseException] = []
    self._actor_done = threading.Event()
    self._learner_done = threading.Event()

  # -- learner side ----------------------------------------------------------

  def _publish(self, state) -> None:
    version = self.bus.version + 1
    self.bus.publish(version, snapshot_variables(state))
    self._learner_version_gauge.set(float(version))

  def _learner_loop(self, state, deadline: Optional[float],
                    max_learner_steps: Optional[int],
                    errors: List[BaseException]) -> None:
    cfg = self.config
    try:
      # Wait for the collectors: at least min_resident_examples and at
      # least one full batch.
      resident_floor = max(cfg.min_resident_examples, cfg.batch_size, 1)
      while not self._stop.is_set():
        occupancy = self.client.stats().get('occupancy_examples', 0)
        if occupancy >= resident_floor:
          break
        if deadline is not None and time.perf_counter() >= deadline:
          return
        time.sleep(0.02)
      iterator = ReplayBatchIterator(self.client, cfg.batch_size,
                                     wait_timeout_s=60.0)
      while not self._stop.is_set():
        if deadline is not None and time.perf_counter() >= deadline:
          break
        if max_learner_steps is not None and \
            self._learner_steps >= max_learner_steps:
          break
        try:
          features, labels = next(iterator)
        except ReplayEmpty:
          time.sleep(0.05)
          continue
        state, _ = self.learner.train_step(
            state, {'features': features, 'labels': labels})
        self._learner_steps += 1
        self._learner_steps_counter.inc()
        if self._learner_steps % cfg.publish_every_steps == 0:
          self._publish(state)
        # A quiet actor: keep the rl window stream (and the heartbeat)
        # alive from this side, so a wedged actor is a named finding.
        self._learner_standin_report()
      # A final publish, so a short run still hands the actor its last
      # weights.
      self._publish(state)
    except BaseException as e:  # noqa: BLE001 - re-raised after the join
      errors.append(e)
    finally:
      self._learner_done.set()
      self._check_targets()

  # -- actor side ------------------------------------------------------------

  def _poll_swap(self) -> None:
    version, variables = self.bus.snapshot
    if variables is None or version <= self._actor_version:
      return
    if fault_injection.fires(fault_injection.SITE_LEARNER_SWAP):
      # A dropped poll: the snapshot stays on the bus, and the next poll
      # adopts it.
      self._dropped_swaps += 1
      self._dropped_counter.inc()
      return
    self._actor_variables = variables
    self._actor_version = version
    self._swaps += 1
    self._swap_counter.inc()
    self._actor_version_gauge.set(float(version))

  def _flush_slot(self, transition, slot: int,
                  buffers: List[List[Dict[str, np.ndarray]]]) -> None:
    buffers[slot].append(build_transition_record(
        obs_image=transition['obs_image'][slot],
        obs_height=float(transition['obs_height'][slot]),
        action=transition['action'][slot],
        reward=float(transition['reward'][slot]),
        terminal=bool(transition['terminal'][slot]),
        next_image=transition['next_image'][slot],
        next_height=float(transition['next_height'][slot])))
    if not bool(transition['done'][slot]):
      return
    # The episode is complete: append its transitions, book its outcome.
    for record in buffers[slot]:
      self.client.append(replay_wire.encode_example(record))
    self._transitions.inc(len(buffers[slot]))
    buffers[slot].clear()
    bucket = int(self.env.buckets[slot])
    success = bool(transition['terminal'][slot]) and \
        float(transition['reward'][slot]) > 0.5
    self._episodes += 1
    self._bucket_episodes[bucket] = \
        self._bucket_episodes.get(bucket, 0) + 1
    self._episode_counters.series(str(bucket)).inc()
    if success:
      self._successes += 1
      self._bucket_successes[bucket] = \
          self._bucket_successes.get(bucket, 0) + 1
      self._success_counters.series(str(bucket)).inc()

  def _sample_act_cache(self) -> float:
    """The acting program's executable count. Eager PyTorch compiles no
    acting program, so the port reports 1.0, the value of a healthy JAX
    loop (and of its ahead-of-time branch); the field keeps the record's
    schema the JAX package's."""
    self._act_cache_gauge.set(1.0)
    return 1.0

  def _make_record(self, window_s: float, actor_steps: int,
                   episodes: int, successes: int, transitions: int,
                   act_seconds: float, learner_steps: int,
                   act_jit_cache: float, buckets,
                   reporter: str) -> Dict[str, Any]:
    """The one t2r.rl.v1 record builder of both reporters (the actor's
    windows and the learner's stand-ins), field for field the JAX
    package's."""
    num_envs = self.env.num_envs
    window_s = max(window_s, 1e-9)
    record = {
        'schema': rl_metrics.RL_RECORD_SCHEMA,
        'window_seconds': round(window_s, 3),
        'num_envs': num_envs,
        'actor_steps': int(actor_steps),
        'actor_steps_per_sec': round(actor_steps / window_s, 2),
        'env_steps': int(actor_steps * num_envs),
        'env_steps_per_sec': round(actor_steps * num_envs / window_s, 2),
        'episodes': int(episodes),
        'episodes_per_sec': round(episodes / window_s, 2),
        'success_rate': round(successes / episodes, 4) if episodes else 0.0,
        'success_rate_cumulative': round(
            self._successes / self._episodes, 4) if self._episodes else 0.0,
        'transitions': int(transitions),
        'learner_steps': int(learner_steps),
        'learner_steps_per_sec': round(learner_steps / window_s, 2),
        'actor_version': int(self._actor_version),
        'learner_version': int(self.bus.version),
        'swaps': int(self._swaps),
        'dropped_swaps': int(self._dropped_swaps),
        'act_step_ms': round(act_seconds / actor_steps * 1e3, 3)
                       if actor_steps else 0.0,
        'act_jit_cache': act_jit_cache,
        'buckets': buckets,
        'reporter': reporter,
        # Completion flags: a side that finished its target is healthy,
        # one that stalled is not.
        'actor_done': self._actor_done.is_set(),
        'learner_done': self._learner_done.is_set(),
    }
    spread = rl_metrics.scenario_success_spread(buckets)
    if spread is not None:
      record['scenario_success_spread'] = round(spread, 4)
    return record

  def _covered_learner_steps(self) -> int:
    """Learner steps since the last report of either reporter."""
    steps = self._learner_steps - self._learner_steps_at_report
    self._learner_steps_at_report = self._learner_steps
    self._last_report_mark = time.perf_counter()
    return steps

  def _report_window(self, step_i: int, window: Dict[str, Any],
                     window_s: float) -> Dict[str, Any]:
    with self._report_lock:
      learner_steps = self._covered_learner_steps()
    buckets = rl_metrics.bucket_table(
        self._bucket_episodes, self._bucket_successes,
        window_episodes=window['bucket_episodes'])
    record = self._make_record(
        window_s, window['actor_steps'], window['episodes'],
        window['successes'], window['transitions'],
        window['act_seconds'], learner_steps,
        self._sample_act_cache(), buckets, reporter='actor')
    self.telemetry.log(rl_metrics.RL_RECORD_KIND, step=step_i, **record)
    self.telemetry.heartbeat(step_i)
    self.telemetry.flush()
    self._windows.append(record)
    return record

  def _learner_standin_report(self) -> None:
    """A learner-side ``kind="rl"`` window once the actor has been quiet
    for three report intervals (wedged, or finished while the learner runs
    to its own target): zero actor activity, the learner's steps since the
    last window, and the completion flags."""
    cfg = self.config
    with self._report_lock:
      now = time.perf_counter()
      window_s = now - self._last_report_mark
      if window_s < 3 * cfg.report_interval_s:
        return
      learner_steps = self._covered_learner_steps()
    step_i = int(self._actor_steps.value
                 - self._counter_base['actor_steps'])
    buckets = rl_metrics.bucket_table(self._bucket_episodes,
                                      self._bucket_successes)
    record = self._make_record(
        window_s, 0, 0, 0, 0, 0.0, learner_steps,
        self._act_cache_gauge.value, buckets, reporter='learner')
    self.telemetry.log(rl_metrics.RL_RECORD_KIND, step=step_i, **record)
    self.telemetry.heartbeat(step_i)
    self.telemetry.flush()
    self._windows.append(record)

  def act_generator(self, step_i: int) -> torch.Generator:
    """The device generator of acting step ``step_i``'s draws."""
    return self._act_generator.manual_seed(
        (self.config.seed * ACT_SEED_STRIDE + step_i) % (1 << 63))

  def fetch(self, transition) -> Dict[str, np.ndarray]:
    """A transition's tensors as host numpy arrays."""
    return {key: value.cpu().numpy() for key, value in transition.items()}

  def _actor_loop(self, deadline: Optional[float],
                  max_episodes: Optional[int]) -> None:
    cfg = self.config
    env_state, obs = self.env.reset(seed=cfg.seed + ENV_RESET_SEED_OFFSET)
    buffers: List[List[Dict[str, np.ndarray]]] = [
        [] for _ in range(self.env.num_envs)]
    step_i = 0
    window = self._fresh_window()
    window_start = time.perf_counter()
    try:
      while not self._stop.is_set():
        if deadline is not None and time.perf_counter() >= deadline:
          break
        if max_episodes is not None and self._episodes >= max_episodes:
          break
        if self._learner_errors:
          # Fail fast: nobody learns from the episodes of a dead learner.
          break
        if step_i % cfg.swap_poll_steps == 0:
          self._poll_swap()
        stall_s = fault_injection.actor_stall_seconds()
        if stall_s > 0.0:
          time.sleep(stall_s)
        t0 = time.perf_counter()
        env_state, obs, transition = self._act(
            self._actor_variables, env_state, obs,
            self.act_generator(step_i))
        fetched = self.fetch(transition)
        act_s = time.perf_counter() - t0 + stall_s
        self._act_ms.record(act_s * 1e3)
        step_i += 1
        self._actor_steps.inc()
        self._env_steps.inc(self.env.num_envs)
        window['actor_steps'] += 1
        window['act_seconds'] += act_s
        episodes_before = self._episodes
        successes_before = self._successes
        transitions_before = self._transitions.value
        for slot in np.flatnonzero(fetched['done']):
          bucket = int(self.env.buckets[int(slot)])
          window['bucket_episodes'][bucket] = \
              window['bucket_episodes'].get(bucket, 0) + 1
        for slot in range(self.env.num_envs):
          self._flush_slot(fetched, slot, buffers)
        window['episodes'] += self._episodes - episodes_before
        window['successes'] += self._successes - successes_before
        window['transitions'] += \
            self._transitions.value - transitions_before
        self._check_targets()
        now = time.perf_counter()
        if now - window_start >= cfg.report_interval_s:
          self._report_window(step_i, window, now - window_start)
          window = self._fresh_window()
          window_start = now
    finally:
      now = time.perf_counter()
      if window['actor_steps']:
        self._report_window(step_i, window, max(now - window_start, 1e-9))
      self._actor_done.set()
      self._check_targets()

  def _fresh_window(self) -> Dict[str, Any]:
    return {'actor_steps': 0, 'act_seconds': 0.0, 'episodes': 0,
            'successes': 0, 'transitions': 0, 'bucket_episodes': {}}

  # -- lifecycle -------------------------------------------------------------

  def _check_targets(self) -> None:
    """Sets the shared stop flag once every given target is met. A
    deadline-only run never stops early; with both targets, the side that
    finishes first leaves the other running to its own."""
    max_episodes = self._targets['max_episodes']
    max_learner_steps = self._targets['max_learner_steps']
    if max_episodes is None and max_learner_steps is None:
      return
    episodes_done = (max_episodes is None
                     or self._episodes >= max_episodes
                     or self._actor_done.is_set())
    learner_done = (max_learner_steps is None
                    or self._learner_steps >= max_learner_steps
                    or self._learner_done.is_set())
    if episodes_done and learner_done:
      self._stop.set()

  def init_learner_state(self):
    """The learner's first state: the trainer's (fresh weights from its
    seed)."""
    return self.trainer.init_state()

  def run(self,
          max_seconds: Optional[float] = None,
          max_episodes: Optional[int] = None,
          max_learner_steps: Optional[int] = None,
          join_timeout_s: float = 300.0) -> Dict[str, Any]:
    """Runs the loop until every given target is met (or the deadline
    passes); returns the run's summary.

    At least one bound must be given. The actor runs in this thread, the
    learner in a daemon thread whose exception is raised here after the
    join; a learner still alive ``join_timeout_s`` after the actor stopped
    is an error.
    """
    if max_seconds is None and max_episodes is None and \
        max_learner_steps is None:
      raise ValueError('give at least one of max_seconds / max_episodes /'
                       ' max_learner_steps')
    cfg = self.config
    self._stop.clear()
    self._reset_run_state()
    self._targets = {'max_episodes': max_episodes,
                     'max_learner_steps': max_learner_steps}
    start = time.perf_counter()
    deadline = None if max_seconds is None else start + max_seconds

    state = self.init_learner_state()
    self._publish(state)
    # Version 1 (the initial weights) is the loop's starting point, not a
    # swap: it neither counts in ``swaps`` nor passes the drop site.
    self._actor_version, self._actor_variables = self.bus.snapshot
    self._actor_version_gauge.set(float(self._actor_version))
    self.telemetry.log(
        'rl_start', num_envs=self.env.num_envs,
        episode_length=self.env.episode_length,
        num_buckets=getattr(self.env, 'num_buckets', 1),
        config={'cem_samples': cfg.cem_samples,
                'cem_iters': cfg.cem_iters,
                'batch_size': cfg.batch_size,
                'explore_prob': cfg.explore_prob,
                'swap_poll_steps': cfg.swap_poll_steps,
                'publish_every_steps': cfg.publish_every_steps})
    self.telemetry.flush()

    learner_thread = threading.Thread(
        target=self._learner_loop,
        args=(state, deadline, max_learner_steps, self._learner_errors),
        name='t2r-rl-learner', daemon=True)
    learner_thread.start()
    try:
      self._actor_loop(deadline, max_episodes)
    except BaseException:
      self._stop.set()
      raise
    finally:
      # The learner runs on to its own target after the actor finished;
      # only the deadline or the targets stop it.
      learner_thread.join(timeout=join_timeout_s)
      self._stop.set()
    if self._learner_errors:
      raise self._learner_errors[0]
    if learner_thread.is_alive():
      raise RuntimeError('learner thread failed to stop')

    elapsed = max(time.perf_counter() - start, 1e-9)
    buckets = rl_metrics.bucket_table(self._bucket_episodes,
                                      self._bucket_successes)
    env_steps = self._env_steps.value - self._counter_base['env_steps']
    actor_steps = (self._actor_steps.value
                   - self._counter_base['actor_steps'])
    transitions = (self._transitions.value
                   - self._counter_base['transitions'])
    summary = {
        'seconds': round(elapsed, 3),
        'num_envs': self.env.num_envs,
        'episodes': self._episodes,
        'successes': self._successes,
        'success_rate': round(self._successes / self._episodes, 4)
                        if self._episodes else 0.0,
        'episodes_per_sec': round(self._episodes / elapsed, 3),
        'env_steps': int(env_steps),
        'env_steps_per_sec': round(env_steps / elapsed, 2),
        'actor_steps': int(actor_steps),
        'learner_steps': self._learner_steps,
        'transitions': int(transitions),
        'swaps': self._swaps,
        'dropped_swaps': self._dropped_swaps,
        'actor_version': self._actor_version,
        'learner_version': self.bus.version,
        'act_jit_cache': self._sample_act_cache(),
        'buckets': buckets,
        'windows': list(self._windows),
    }
    spread = rl_metrics.scenario_success_spread(buckets)
    if spread is not None:
      summary['scenario_success_spread'] = round(spread, 4)
    self.telemetry.log('rl_stop', **{
        key: summary[key] for key in
        ('episodes', 'success_rate', 'learner_steps', 'swaps',
         'dropped_swaps', 'actor_version')})
    self.telemetry.flush()
    return summary

  def measure_success(self, variables=None, episodes: int = 32,
                      seed: int = 1234, max_steps: int = 1000) -> float:
    """The greedy (no exploration) success rate over fresh episodes, from
    ``variables`` (the actor's last, by default)."""
    if variables is None:
      variables = self._actor_variables
      if variables is None:
        raise ValueError('no variables: run() first or pass variables')
    if self._greedy_act is None:
      cfg = self.config
      self._greedy_act = make_act_step(
          self.model, self.env, cem_samples=cfg.cem_samples,
          cem_iters=cfg.cem_iters, num_elites=cfg.num_elites,
          explore_prob=0.0, network=self.actor_network)
    env_state, obs = self.env.reset(seed=seed + 1)
    generator = torch.Generator(device=self.model.device)
    done_episodes = 0
    wins = 0
    for step in range(max_steps):
      generator.manual_seed((seed * ACT_SEED_STRIDE + 2 + step) % (1 << 63))
      env_state, obs, transition = self._greedy_act(variables, env_state,
                                                    obs, generator)
      done = transition['done']
      wins += int(((transition['reward'] > 0.5)
                   & transition['terminal']).sum())
      done_episodes += int(done.sum())
      if done_episodes >= episodes:
        break
    return wins / max(done_episodes, 1)

  def close(self) -> None:
    self.trainer.close()
    if self._owns_telemetry:
      self.telemetry.close()
    if self._owned_service is not None:
      self._owned_service.close()


def build_grasping_loop(model_dir: str,
                        num_envs: int = 16,
                        height: int = 48,
                        width: int = 64,
                        episode_length: int = 3,
                        scenario_config=None,
                        replay=None,
                        config: Optional[RLLoopConfig] = None,
                        num_shards: int = 2,
                        seed: int = 0,
                        device='cuda') -> RLLoop:
  """The whole loop over the grasping MDP, with the sim critic.

  ``replay``: None (an in-process ReplayService the loop owns), a
  ``host:port`` / URL endpoint, a ReplayService, or any client. The critic
  is the test-scale sim critic at the env's resolution with Adam at 3e-3;
  the env randomizes scenarios per slot unless ``scenario_config`` pins
  them. Everything runs on ``device``, the card unless the caller asks for
  the CPU.
  """
  from tensor2robot_tpu_torch.envs import ScenarioConfig, VecGraspingEnv
  from tensor2robot_tpu_torch.models import optimizers
  from tensor2robot_tpu_torch.replay.service import ReplayConfig
  from tensor2robot_tpu_torch.research.qtopt import grasping_sim
  from tensor2robot_tpu_torch.rl.offpolicy import BellmanQTOptTrainer
  from tensor2robot_tpu_torch.trainer.train_eval import Trainer

  config = config or RLLoopConfig(seed=seed)
  if scenario_config is None:
    scenario_config = ScenarioConfig.randomized()
  env = VecGraspingEnv(num_envs, height=height, width=width,
                       episode_length=episode_length,
                       scenario_config=scenario_config, seed=seed,
                       device=device)
  owned_service = None
  if replay is None:
    owned_service = ReplayService(ReplayConfig(
        num_shards=num_shards, batch_size=config.batch_size, seed=seed))
    client = LocalReplayClient(owned_service)
  elif isinstance(replay, str):
    client = ReplayClient(replay)
  elif isinstance(replay, ReplayService):
    client = LocalReplayClient(replay)
  else:
    client = replay
  model = grasping_sim.make_sim_critic_model(
      height, width, device=device,
      create_optimizer_fn=lambda: optimizers.create_adam_optimizer(3e-3))
  trainer = Trainer(model, model_dir, save_checkpoints_steps=10**9,
                    log_every_n_steps=10**9, write_metrics=False)
  learner = BellmanQTOptTrainer(
      model, trainer,
      grasping_sim.make_candidate_actions_fn(config.num_candidates),
      num_candidates=config.num_candidates, gamma=config.gamma,
      target_update_steps=config.target_update_steps)
  return RLLoop(model, env, client, trainer, learner, model_dir,
                config=config, owned_service=owned_service)
