"""ServingFleet: an autoscaled, telemetry-routed PolicyServer replica set.

A copy of the JAX package's ``serving/fleet.py``: the same lifecycle, the
same telemetry and the same ``t2r.serving_fleet.v1`` record. The fleet owns
the replicas' lifecycle (the router is `serving/router.py`): it spins
replicas up from a factory, drains them down through the server's
close-then-terminate contract (zero drops), walks rolling swaps one replica
at a time (both weight versions serve during the wave; each replica's swap
is drain-free), and scales the set against the demand curve. A torch
replica has no compiled executable to persist: its factory reuses the
CUDA kernels already built under ``_build/`` and answers one warm batch
before the replica enters rotation, so replicas after the first build
nothing (``kernels.BUILDS`` counts the builds).

Telemetry layout (indexed streams, `observability/telemetry_file.py`): the
fleet's model_dir is fleet-shaped. The router owns stream 0
(``telemetry.0.jsonl``: ``t2r.serving_fleet.v1`` windows, scale, eject and
swap events, the fleet heartbeat) and replica *i* owns stream *i* (its
PolicyServer's ``serving`` SLO windows and heartbeat). Replica ids are
1-based for this reason: ``discover_hosts`` takes the lowest-index stream
as the primary, which is the router's, so the doctor judges the fleet
record in a fleet-shaped serving dir and the replica streams sit under it.

``t2r.serving_fleet.v1`` window record (kind ``serving_fleet``): the
per-replica table (windowed p99, queue depth, routing weight, ejected
flag, params version), the fleet's actions/s and end-to-end p50/p95/p99
against the SLO, ejection, scale and shed totals, and the params versions
serving (a rolling wave shows two).

The factory owns whatever device code a replica needs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.observability import (
    TelemetryLogger,
    get_registry,
)
from tensor2robot_tpu_torch.serving.router import (
    FleetRouter,
    ReplicaHandle,
    RouterConfig,
    RoutedResult,
)

__all__ = ['ServingFleet', 'ServingFleetConfig', 'replica_host_meta',
           'router_host_meta', 'SERVING_FLEET_RECORD_KIND',
           'SERVING_FLEET_SCHEMA', 'SERVING_FLEET_BENCH_KEYS',
           'FLEET_SCALE_UPS_COUNTER', 'FLEET_SCALE_DOWNS_COUNTER']

SERVING_FLEET_RECORD_KIND = 'serving_fleet'
SERVING_FLEET_SCHEMA = 't2r.serving_fleet.v1'

FLEET_SCALE_UPS_COUNTER = 'serving_fleet/scale_ups'
FLEET_SCALE_DOWNS_COUNTER = 'serving_fleet/scale_downs'

_LOG = logging.getLogger(__name__)

# The serving-fleet bench keys, spelled as the JAX package spells them: the
# throughput-at-SLO scaling curve against the replica count, the builds at
# request time and across a warm scale-up (``*_compiles``: eager PyTorch
# compiles no program, so the port counts its nvcc builds), the scale-up's
# time to ready, and the mid-load rolling swap's outcome.
SERVING_FLEET_BENCH_KEYS = (
    'serving_fleet_actions_per_sec_r1',
    'serving_fleet_actions_per_sec_r2',
    'serving_fleet_actions_per_sec_r4',
    'serving_fleet_p99_ms_r1',
    'serving_fleet_p99_ms_r2',
    'serving_fleet_p99_ms_r4',
    'serving_fleet_scaling_monotonic',
    'serving_fleet_request_time_compiles',
    'serving_fleet_scaleup_compiles',
    'fleet_scaleup_time_to_ready_s',
    'serving_fleet_swap_failed',
    'serving_fleet_swap_versions_served',
)


def router_host_meta(max_replicas: int) -> Dict[str, object]:
  """The router's stream-0 identity in a fleet-shaped serving dir."""
  return {'process_index': 0, 'process_count': int(max_replicas) + 1}


def replica_host_meta(replica_id: int,
                      max_replicas: int) -> Dict[str, object]:
  """Replica *i*'s indexed-stream identity (``telemetry.<i>.jsonl``).

  Replica ids are 1-based: stream 0 is the router's, so the primary
  stream ``discover_hosts`` picks for a fleet dir is the fleet view.
  """
  if int(replica_id) < 1:
    raise ValueError('replica ids are 1-based (stream 0 is the '
                     'router\'s); got {}.'.format(replica_id))
  return {'process_index': int(replica_id),
          'process_count': int(max_replicas) + 1}


@dataclasses.dataclass
class ServingFleetConfig:
  """Knobs for one ServingFleet.

  Attributes:
    min_replicas / max_replicas: the autoscaler's bounds (and the
      ``process_count`` stamped into the per-replica streams).
    autoscale: run the scale-up/-down policy in the report loop.
    scale_up_at / scale_down_at: fleet utilization (router outstanding
      over fleet queue capacity) thresholds; crossing one for
      ``scale_windows`` CONSECUTIVE report windows triggers a scale
      event — one bursty window moves nothing.
    scale_windows: the consecutive-window hysteresis above.
    report_interval_s: cadence of ``t2r.serving_fleet.v1`` records (and
      autoscale decisions).
    health_interval_s / stale_after_s / max_fleet_pending: forwarded to
      the router (see :class:`~...router.RouterConfig`).
    slo_ms: the fleet-level end-to-end latency objective; per-replica
      SLOs live in each replica's own ServingConfig.
    drain_timeout_s: scale-down / close drain budget per replica.
  """

  min_replicas: int = 1
  max_replicas: int = 4
  autoscale: bool = False
  scale_up_at: float = 0.75
  scale_down_at: float = 0.1
  scale_windows: int = 2
  report_interval_s: float = 10.0
  health_interval_s: float = 1.0
  stale_after_s: float = 30.0
  max_fleet_pending: Optional[int] = None
  slo_ms: float = 33.0
  drain_timeout_s: float = 30.0


class ServingFleet:
  """N PolicyServer replicas behind one router, scaled and swapped.

  Args:
    replica_factory: ``(replica_id, telemetry) -> ReplicaHandle`` —
      builds ONE ready-to-serve replica. ``telemetry`` is the replica's
      indexed-stream TelemetryLogger under the fleet model_dir (None
      when the fleet runs without one); pass it to the PolicyServer so
      the replica reports into its own stream. A factory builds its
      replica's own critic module and answers one warm batch before the
      replica enters rotation; replicas after the first build no kernel.
    config: :class:`ServingFleetConfig`.
    model_dir: the fleet-shaped serving dir (see module docstring);
      None = registry metrics only.
    initial_replicas: replicas spun up by :meth:`start`.
  """

  def __init__(self,
               replica_factory: Callable[[int, Optional[TelemetryLogger]],
                                         ReplicaHandle],
               config: Optional[ServingFleetConfig] = None,
               model_dir: Optional[str] = None,
               initial_replicas: int = 1,
               registry=None,
               clock: Callable[[], float] = time.monotonic):
    self.config = config or ServingFleetConfig()
    if not (1 <= self.config.min_replicas <= self.config.max_replicas):
      raise ValueError(
          'need 1 <= min_replicas <= max_replicas; got {}..{}.'.format(
              self.config.min_replicas, self.config.max_replicas))
    self._factory = replica_factory
    self._clock = clock
    self._registry = registry or get_registry()
    self._initial_replicas = int(initial_replicas)
    self.model_dir = model_dir
    self._telemetry: Optional[TelemetryLogger] = None
    if model_dir is not None:
      self._telemetry = TelemetryLogger(
          model_dir, host_meta=router_host_meta(self.config.max_replicas))
    self._replica_telemetry: Dict[int, TelemetryLogger] = {}
    self.router = FleetRouter(
        [], config=RouterConfig(
            health_interval_s=self.config.health_interval_s,
            stale_after_s=self.config.stale_after_s,
            max_fleet_pending=self.config.max_fleet_pending),
        on_event=self._on_router_event, registry=self._registry,
        clock=clock)
    self._scale_ups = self._registry.counter(FLEET_SCALE_UPS_COUNTER)
    self._scale_downs = self._registry.counter(FLEET_SCALE_DOWNS_COUNTER)

    self._lock = threading.Lock()  # replica-set mutations (scale, swap)
    self._next_replica_id = 1
    # The newest rolling-swap payload: a replica that was EJECTED while
    # a wave walked the fleet missed it, and on re-arm it must not
    # silently rejoin rotation serving the old version.
    self._last_swap: Optional[Tuple[Any, int]] = None
    self._ejections_window = 0
    self._scale_events_window = 0
    self._util_high_streak = 0
    self._util_low_streak = 0
    self._window_started = self._clock()
    self.last_record: Optional[Dict[str, object]] = None
    self.last_scaleup_seconds: Optional[float] = None

    self._stop = threading.Event()
    self._reporter: Optional[threading.Thread] = None
    self._started = False
    self._closed = False

  # -- lifecycle --------------------------------------------------------------

  def start(self) -> 'ServingFleet':
    if self._started:
      raise RuntimeError('ServingFleet already started.')
    self._started = True
    try:
      if self._telemetry is not None:
        self._telemetry.log(
            'serving_fleet_start',
            config={'min_replicas': self.config.min_replicas,
                    'max_replicas': self.config.max_replicas,
                    'autoscale': self.config.autoscale,
                    'slo_ms': self.config.slo_ms,
                    'report_interval_s': self.config.report_interval_s},
            initial_replicas=self._initial_replicas)
      for _ in range(self._initial_replicas):
        self._spawn_replica()
      self.router.start()
      self._window_started = self._clock()
      self._reporter = threading.Thread(target=self._report_loop,
                                        name='t2r-serving-fleet',
                                        daemon=True)
      self._reporter.start()
    except Exception:
      # A spawn that fails mid-boot (replica 2 of 3) must not strand
      # the replicas that DID start, their streams, or the router
      # stream — clean up, then surface the original failure.
      self.close()
      raise
    return self

  def __enter__(self) -> 'ServingFleet':
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.close()

  def close(self) -> None:
    """Stops reporting/routing, then drains and closes every replica
    (zero drops — each replica's close() answers its whole queue).

    Safe on a fleet that never started, or whose start() failed partway
    (already-spawned replicas and open telemetry streams are released
    either way); idempotent.
    """
    if self._closed:
      return
    self._closed = True
    if self._reporter is not None:
      self._stop.set()
      self._reporter.join()
      self._reporter = None
    self.router.stop()
    if self._started:
      try:
        self._report(force=True)
      except Exception as e:  # noqa: BLE001 — still release the replicas
        _LOG.warning('final fleet report failed: %s', e)
    for replica_id in list(self.router.replica_ids()):
      handle = self.router.remove_replica(replica_id)
      try:
        handle.drain(timeout_s=self.config.drain_timeout_s)
        handle.close()
      except Exception as e:  # noqa: BLE001 — close the rest regardless
        _LOG.warning('replica %s close failed: %s', replica_id, e)
      self._close_replica_telemetry(replica_id)
    if self._telemetry is not None:
      if self._started:
        stats = self.router.stats()
        self._telemetry.log('serving_fleet_stop',
                            rejected_total=stats['rejected_total'],
                            ejections_total=stats['ejections_total'],
                            requests_total=stats['requests_total'])
        self._telemetry.flush()
      self._telemetry.close()
    for logger in self._replica_telemetry.values():
      logger.close()
    self._replica_telemetry.clear()

  # -- request path (the frontend-facing contract) ----------------------------

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    return self.router.submit(features)

  def select_action(self, features: Dict[str, np.ndarray],
                    timeout_s: Optional[float] = None) -> RoutedResult:
    return self.router.select_action(features, timeout_s=timeout_s)

  def stats(self) -> Dict[str, object]:
    stats = self.router.stats()
    stats['scale_ups_total'] = self._scale_ups.value
    stats['scale_downs_total'] = self._scale_downs.value
    stats['ejected'] = self.router.ejected_ids()
    return stats

  # -- replica lifecycle ------------------------------------------------------

  def _spawn_replica(self) -> Tuple[int, float]:
    with self._lock:
      replica_id = self._next_replica_id
      self._next_replica_id += 1
    telemetry = None
    if self.model_dir is not None:
      # Ids are never reused, so scale-down/up cycles can push an id
      # past max_replicas; the stamped process_count grows with it —
      # an identity must never contradict itself (process_index <
      # process_count).
      telemetry = TelemetryLogger(
          self.model_dir,
          host_meta=replica_host_meta(
              replica_id, max(self.config.max_replicas, replica_id)))
      self._replica_telemetry[replica_id] = telemetry
    started = self._clock()
    try:
      handle = self._factory(replica_id, telemetry)
    except Exception:
      # A failed spawn (a bad checkpoint, OOM) must not leak an open
      # indexed stream that doctor/discover_hosts would read as a
      # replica that never served. The id stays burned — ids are
      # never reused.
      self._close_replica_telemetry(replica_id, remove_if_empty=True)
      raise
    if handle.replica_id != replica_id:
      handle.replica_id = replica_id
    self.router.add_replica(handle)
    ready_s = self._clock() - started
    return replica_id, ready_s

  def scale_up(self, reason: str = 'manual') -> Tuple[int, float]:
    """Adds one replica; returns ``(replica_id, time_to_ready_s)``.

    Time-to-ready covers the factory (module copy, warm batch, server
    start) through rotation entry — the ``fleet_scaleup_time_to_ready_s``
    bench quantity. Raises when the fleet is at ``max_replicas``.
    """
    if len(self.router.replica_ids()) >= self.config.max_replicas:
      raise RuntimeError('fleet already at max_replicas={}'.format(
          self.config.max_replicas))
    replica_id, ready_s = self._spawn_replica()
    self._scale_ups.inc()
    self.last_scaleup_seconds = ready_s
    with self._lock:
      self._scale_events_window += 1
    if self._telemetry is not None:
      self._telemetry.log('serving_fleet_scale', direction='up',
                          replica=replica_id, reason=reason,
                          time_to_ready_s=round(ready_s, 4),
                          replicas_after=len(self.router.replica_ids()))
    return replica_id, ready_s

  def scale_down(self, replica_id: Optional[int] = None,
                 reason: str = 'manual') -> int:
    """Retires one replica: out of rotation first, then drained through
    the close-then-terminate batcher contract — zero dropped requests —
    then closed. Returns the retired id."""
    if len(self.router.replica_ids()) <= self.config.min_replicas:
      raise RuntimeError('fleet already at min_replicas={}'.format(
          self.config.min_replicas))
    if replica_id is None:
      table = self.router.table()
      healthy = self.router.healthy_ids()
      pool = healthy or self.router.replica_ids()
      replica_id = min(pool,
                       key=lambda i: table.get(i, {}).get('outstanding', 0))
    handle = self.router.remove_replica(replica_id)
    drained = handle.drain(timeout_s=self.config.drain_timeout_s)
    handle.close()
    self._close_replica_telemetry(replica_id)
    self._scale_downs.inc()
    with self._lock:
      self._scale_events_window += 1
    if self._telemetry is not None:
      self._telemetry.log('serving_fleet_scale', direction='down',
                          replica=replica_id, reason=reason,
                          drained=bool(drained),
                          replicas_after=len(self.router.replica_ids()))
    return replica_id

  def _close_replica_telemetry(self, replica_id: int,
                               remove_if_empty: bool = False) -> None:
    logger = self._replica_telemetry.pop(replica_id, None)
    if logger is None:
      return
    logger.close()
    if remove_if_empty:
      # A spawn that failed before its first record leaves a 0-byte
      # indexed stream; drop it so the fleet dir only names replicas
      # that existed. A stream with history is always kept.
      try:
        if os.path.getsize(logger.path) == 0:
          os.remove(logger.path)
      except OSError:
        pass

  # -- rolling hot swap -------------------------------------------------------

  def rolling_swap(self, variables: Any, version: int,
                   pause_s: float = 0.0) -> List[int]:
    """Walks the fleet ONE replica at a time onto new weights.

    Each per-replica swap is the server's drain-free swap (in-flight
    batches finish on the weights they started with), so during the
    wave both versions serve — by construction, not by luck. Returns
    the wave order (replica ids swapped). Replicas whose handle cannot
    swap (a remote replica owned by another orchestrator) are skipped
    with a warning and reported in the wave record.
    """
    wave: List[int] = []
    skipped: List[int] = []
    with self._lock:
      self._last_swap = (variables, int(version))
    for replica_id in self.router.healthy_ids():
      try:
        handle = self.router.handle(replica_id)
      except KeyError:
        continue  # scaled down mid-wave
      try:
        handle.swap_params(variables, version)
        wave.append(replica_id)
      except NotImplementedError:
        skipped.append(replica_id)
        _LOG.warning('rolling swap: replica %s handle cannot swap '
                     '(remote); skipped', replica_id)
      if pause_s > 0:
        time.sleep(pause_s)
    if self._telemetry is not None:
      self._telemetry.log('serving_fleet_swap', version=int(version),
                          wave=wave, skipped=skipped)
    return wave

  # -- reporting + autoscaling ------------------------------------------------

  def _on_router_event(self, kind: str, **payload) -> None:
    if kind == 'eject':
      with self._lock:
        self._ejections_window += 1
    if kind == 'return':
      self._reconcile_swap(payload.get('replica'))
    if self._telemetry is not None:
      self._telemetry.log('serving_fleet_{}'.format(kind), **payload)
      self._telemetry.flush()

  def _reconcile_swap(self, replica_id) -> None:
    """Brings a re-armed replica onto the newest rolling-swap version.

    A replica ejected mid-wave missed its swap; rejoining rotation on
    the OLD weights would silently serve a stale policy until the next
    checkpoint poll. Swapped here, at the re-arm edge, before routing
    weight returns to it in earnest.
    """
    with self._lock:
      last = self._last_swap
    if last is None or replica_id is None:
      return
    variables, version = last
    try:
      handle = self.router.handle(int(replica_id))
      if handle.snapshot().get('params_version') == version:
        return
      handle.swap_params(variables, version)
      _LOG.warning('replica %s re-armed on a stale version; swapped to '
                   'v%s (it missed a rolling wave while ejected)',
                   replica_id, version)
    except KeyError:
      pass  # removed between the event and here
    except NotImplementedError:
      _LOG.warning('replica %s re-armed on a stale version but its '
                   'handle cannot swap (remote orchestrator owns it)',
                   replica_id)

  def _report_loop(self) -> None:
    while not self._stop.wait(self.config.report_interval_s):
      try:
        self._report()
        if self.config.autoscale:
          self._autoscale()
      except Exception as e:  # noqa: BLE001 — reporting/scaling must not
        # take the data path down with it.
        _LOG.warning('ServingFleet report failed (kept serving): %s', e)

  def _report(self, force: bool = False) -> Optional[Dict[str, object]]:
    now = self._clock()
    window_s = now - self._window_started
    if window_s <= 0 and not force:
      return None
    self._window_started = now
    window = self.router.window_stats()
    table = self.router.table()
    with self._lock:
      ejections = self._ejections_window
      scale_events = self._scale_events_window
      self._ejections_window = self._scale_events_window = 0
    replicas: Dict[str, Dict[str, object]] = {}
    versions = set()
    for replica_id, entry in sorted(table.items()):
      replicas[str(replica_id)] = {
          'alive': bool(entry.get('alive')),
          'ejected': bool(entry.get('ejected')),
          'weight': round(float(entry.get('weight') or 0.0), 4),
          'queue_depth': entry.get('queue_depth'),
          'outstanding': entry.get('outstanding'),
          'p99_ms': entry.get('p99_ms'),
          'requests_per_sec': entry.get('requests_per_sec'),
          'requests': entry.get('requests'),
          'over_slo': bool(entry.get('over_slo')),
          'slo_ms': entry.get('slo_ms'),
          'params_version': entry.get('params_version'),
      }
      if not entry.get('ejected') and \
          entry.get('params_version') is not None:
        versions.add(int(entry['params_version']))
    latency = window['latency']
    completed = int(window['completed'])
    p99 = float(latency.get('p99', 0.0) or 0.0)
    stats = self.router.stats()
    record = {
        'schema': SERVING_FLEET_SCHEMA,
        'window_seconds': round(window_s, 3),
        'replica_count': stats['replica_count'],
        'healthy_count': stats['healthy_count'],
        'ejected': self.router.ejected_ids(),
        'replicas': replicas,
        'requests': completed,
        'actions_per_sec': round(completed / window_s, 2)
                           if window_s > 0 else 0.0,
        'retried': int(window['retried']),
        'p50_ms': round(float(latency.get('p50', 0.0) or 0.0), 3),
        'p95_ms': round(float(latency.get('p95', 0.0) or 0.0), 3),
        'p99_ms': round(p99, 3),
        'slo_ms': self.config.slo_ms,
        'over_slo': bool(completed > 0 and p99 > self.config.slo_ms),
        'ejections': ejections,
        'scale_events': scale_events,
        'rejected_total': stats['rejected_total'],
        'ejections_total': stats['ejections_total'],
        'retries_total': stats['retries_total'],
        'scale_ups_total': self._scale_ups.value,
        'scale_downs_total': self._scale_downs.value,
        'versions_serving': sorted(versions),
    }
    self.last_record = record
    if self._telemetry is not None:
      self._telemetry.log(SERVING_FLEET_RECORD_KIND, **record)
      self._telemetry.heartbeat()
      self._telemetry.flush()
    return record

  def _utilization(self) -> float:
    healthy = self.router.healthy_ids()
    if not healthy:
      return 1.0  # nothing in rotation IS maximal demand pressure
    table = self.router.table()
    capacity = 0
    for replica_id in healthy:
      capacity += int(table.get(replica_id, {}).get('max_queue_depth')
                      or 64)
    if capacity <= 0:
      return 0.0
    return self.router.outstanding_total() / float(capacity)

  def _autoscale(self) -> None:
    """One scale decision per report window, with streak hysteresis."""
    util = self._utilization()
    if util >= self.config.scale_up_at:
      self._util_high_streak += 1
      self._util_low_streak = 0
    elif util <= self.config.scale_down_at:
      self._util_low_streak += 1
      self._util_high_streak = 0
    else:
      self._util_high_streak = self._util_low_streak = 0
    replicas = len(self.router.replica_ids())
    if self._util_high_streak >= self.config.scale_windows and \
        replicas < self.config.max_replicas:
      self._util_high_streak = 0
      self.scale_up(reason='autoscale util={:.2f}'.format(util))
    elif self._util_low_streak >= self.config.scale_windows and \
        replicas > self.config.min_replicas:
      self._util_low_streak = 0
      self.scale_down(reason='autoscale util={:.2f}'.format(util))
