"""Fleet router: telemetry-weighted dispatch over N PolicyServer replicas.

A copy of the JAX package's ``serving/router.py``, with the same decisions,
counters and wire. One PolicyServer answers within the 33 ms SLO at one
batch at a time; aggregate actions/s scale with the replica count. The
router spreads ``select_action`` requests over a replica set, reading each
replica's windowed p99 and queue depth as its load and health signal.

  * **Weighted least-loaded dispatch.** Each health pass computes a
    routing weight per replica from its last closed SLO window
    (``weight ∝ 1/p99``); each dispatch picks the replica minimizing
    ``outstanding / weight``, so a replica serving at half the latency
    carries twice the depth before it looks equally loaded. Depth is the
    router's own count (submitted minus answered): dispatch never asks a
    replica over the network how busy it is.
  * **Shed at the router, before any replica queue.** A fleet-wide pending
    cap (the sum of healthy replicas' ``max_queue_depth`` by default)
    rejects new arrivals with :class:`RequestRejected` at the door, which
    the HTTP front end answers 503. Retries of already-admitted requests
    bypass the cap: admission is a promise.
  * **Ejection, latched per replica.** A replica whose heartbeat goes stale
    (its serve loop stopped closing report windows, or its /healthz
    stopped answering) while at least one peer is healthy leaves rotation
    and is re-armed only when it comes back. Its queued requests are
    retried exactly once on a healthy peer, after their replica-side
    futures are cancelled, so a replica that revives can never deliver a
    second answer (the caller's future resolves once).
  * **Replica handles speak HTTP too.** The router talks to replicas only
    through :class:`ReplicaHandle`: :class:`LocalReplicaHandle` wraps an
    in-process server, :class:`HttpReplicaHandle` speaks the JSON front
    end of either package's server.

Numpy, threads and stdlib HTTP only: the routing, ejection and retry
contract runs on the CPU in the tests.
"""

from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import logging
import threading
import time
from concurrent.futures import Future
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Set,
                    Tuple)

import numpy as np

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    SLO_LATENCY_BUCKETS_MS,
    Histogram,
    get_registry,
)
from tensor2robot_tpu_torch.serving.batching import RequestRejected
from tensor2robot_tpu_torch.serving.server import PolicyServer, ServeResult

__all__ = ['FleetRouter', 'RouterConfig', 'RoutedResult', 'ReplicaHandle',
           'LocalReplicaHandle', 'HttpReplicaHandle', 'ReplicaUnreachable',
           'FLEET_REJECTED_COUNTER', 'FLEET_RETRIES_COUNTER',
           'FLEET_EJECTIONS_COUNTER', 'FLEET_RETURNS_COUNTER',
           'FLEET_REQUESTS_COUNTER', 'FLEET_REPLICAS_GAUGE',
           'FLEET_HEALTHY_GAUGE', 'FLEET_WEIGHT_GAUGE_FAMILY',
           'FLEET_REQUEST_LATENCY_SERIES']

FLEET_REJECTED_COUNTER = 'serving_fleet/rejected'
FLEET_RETRIES_COUNTER = 'serving_fleet/retries'
FLEET_EJECTIONS_COUNTER = 'serving_fleet/ejections'
FLEET_RETURNS_COUNTER = 'serving_fleet/returns'
FLEET_REQUESTS_COUNTER = 'serving_fleet/requests'
FLEET_REPLICAS_GAUGE = 'serving_fleet/replicas'
FLEET_HEALTHY_GAUGE = 'serving_fleet/healthy'
FLEET_WEIGHT_GAUGE_FAMILY = 'serving_fleet/weight'
# Same family as the per-server series (inference/latency_ms): the
# fleet's end-to-end latency is one more labeled series.
INFERENCE_LATENCY_HISTOGRAM = 'inference/latency_ms'
FLEET_REQUEST_LATENCY_SERIES = 'serving_fleet_request'

_DEFAULT_REPLICA_CAPACITY = 64
# Re-dispatches one request may consume (an ejection, a replica's shed or
# an unreachable replica): 1 is the exactly-once-retry contract.
_RETRY_LIMIT = 1
# Floor for the 1/p99 weight, so one lucky sub-microsecond window cannot
# take all the routing.
_P99_FLOOR_MS = 0.5

_LOG = logging.getLogger(__name__)


class ReplicaUnreachable(RuntimeError):
  """A replica's transport failed under a request (the connection was
  refused, reset or timed out): the replica, not the batch, failed, so the
  router retries the request once on a peer, as it does a shed."""


class RoutedResult(NamedTuple):
  """One fulfilled fleet request.

  ``request_id`` is the router-scoped unique id — the duplicate-
  execution sentinel: however a retry raced a zombie replica, exactly
  one RoutedResult per id ever reaches a caller. ``version`` names the
  params snapshot that scored it (the per-replica contract, preserved);
  ``latency_ms`` is end-to-end at the ROUTER (submit to response),
  which is what the fleet SLO is about; ``replica`` names the replica
  that answered and ``retried`` whether an ejection/overflow re-route
  happened on the way.
  """

  outputs: Dict[str, np.ndarray]
  version: int
  latency_ms: float
  request_id: int
  replica: int
  retried: bool


@dataclasses.dataclass
class RouterConfig:
  """Knobs for one FleetRouter.

  Attributes:
    health_interval_s: cadence of the health/weight pass (snapshots,
      weight recompute, ejection/re-arm).
    stale_after_s: replica report/heartbeat age beyond which it is
      considered dead (ejected while a healthy peer exists). Should be
      a small multiple of the replicas' ``report_interval_s``.
    max_fleet_pending: router-level shed bound; None derives it as the
      sum of healthy replicas' ``max_queue_depth``.
  """

  health_interval_s: float = 1.0
  stale_after_s: float = 30.0
  max_fleet_pending: Optional[int] = None


class _RoutedRequest:
  """Router-side state for one in-flight request."""

  __slots__ = ('request_id', 'features', 'future', 'enqueued_at',
               'retries_left', 'retried', 'replica_future', 'replica')

  def __init__(self, request_id: int, features: Dict[str, np.ndarray],
               enqueued_at: float, retries_left: int):
    self.request_id = request_id
    self.features = features
    self.future: Future = Future()
    self.enqueued_at = enqueued_at
    self.retries_left = retries_left
    self.retried = False
    self.replica_future: Optional[Future] = None
    self.replica: Optional[int] = None


# -- replica handles ----------------------------------------------------------


class ReplicaHandle:
  """What the router needs from one replica, local or remote.

  ``submit`` must return a Future resolving to something with
  ``outputs``/``version``/``latency_ms`` (a :class:`ServeResult`), or
  raise :class:`RequestRejected`/``RuntimeError`` synchronously.
  ``snapshot`` is the health/load read — cheap, never raising (a dead
  replica answers ``alive=False``, it does not throw).
  """

  replica_id: int = -1

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    raise NotImplementedError

  def snapshot(self) -> Dict[str, Any]:
    raise NotImplementedError

  def swap_params(self, variables: Any, version: int) -> None:
    raise NotImplementedError(
        'replica {} cannot swap params through this handle'.format(
            self.replica_id))

  def drain(self, timeout_s: float = 30.0) -> bool:
    return True

  def close(self) -> None:
    pass


class LocalReplicaHandle(ReplicaHandle):
  """An in-process :class:`PolicyServer` as one fleet replica.

  The health signal is the server's own report cadence: a serve loop
  that stopped closing SLO windows (wedged batch, dead thread) reads as
  a stale heartbeat, exactly like a host that stopped writing
  ``heartbeat.<i>.json``.
  """

  def __init__(self, replica_id: int, server: PolicyServer):
    self.replica_id = int(replica_id)
    self.server = server

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    return self.server.submit(features)

  def snapshot(self) -> Dict[str, Any]:
    server = self.server
    report = server.last_report or {}
    return {
        'alive': server.alive,
        'heartbeat_age_s': server.report_age_s(),
        'queue_depth': float(report.get('queue_depth', 0) or 0),
        'max_queue_depth': server.config.max_queue_depth,
        'p99_ms': report.get('p99_ms'),
        'requests': report.get('requests'),
        'requests_per_sec': report.get('requests_per_sec'),
        'over_slo': bool(report.get('over_slo')),
        'slo_ms': server.config.slo_ms,
        'params_version': server.params_version,
    }

  def swap_params(self, variables: Any, version: int) -> None:
    self.server.swap_params(variables, version)

  def drain(self, timeout_s: float = 30.0) -> bool:
    return self.server.drain(timeout_s=timeout_s)

  def close(self) -> None:
    self.server.close()


class HttpReplicaHandle(ReplicaHandle):
  """A remote PolicyServer behind its HTTP front end (either package's).

  Same contract as a local handle — which is the multi-host story: the
  router's API does not change when replicas leave the process.
  ``submit`` rides a small per-handle thread pool (one blocking POST
  per request); 503 maps back to :class:`RequestRejected`, a refused,
  reset or timed-out connection to :class:`ReplicaUnreachable`.
  ``snapshot`` is one ``GET /healthz`` — reachability IS the heartbeat
  (``heartbeat_age_s`` 0 when it answers; ``alive=False`` when it does
  not), and the p99 is the server's cumulative view (the windowed
  number still lands in fleet telemetry via the replica's own stream).
  """

  def __init__(self, replica_id: int, host: str, port: int,
               timeout_s: float = 30.0, max_workers: int = 8,
               health_timeout_s: float = 2.0):
    from concurrent.futures import ThreadPoolExecutor

    self.replica_id = int(replica_id)
    self.host = host
    self.port = int(port)
    self.timeout_s = float(timeout_s)
    # Health probes run SERIALLY in the router's health pass: a
    # black-holed remote must cost one short timeout per pass, not the
    # request timeout — otherwise one partitioned replica throttles
    # ejection/re-arm detection for the whole fleet to ~1/timeout Hz.
    self.health_timeout_s = float(health_timeout_s)
    self._pool = ThreadPoolExecutor(
        max_workers=max_workers,
        thread_name_prefix='t2r-replica-{}'.format(replica_id))

  def _request(self, method: str, path: str, payload=None,
               timeout_s: Optional[float] = None):
    conn = http.client.HTTPConnection(
        self.host, self.port,
        timeout=self.timeout_s if timeout_s is None else timeout_s)
    try:
      body = None if payload is None else json.dumps(payload)
      conn.request(method, path, body=body,
                   headers={'Content-Type': 'application/json'})
      response = conn.getresponse()
      return response.status, json.loads(response.read() or b'{}')
    finally:
      conn.close()

  def _post_select_action(self, features: Dict[str, np.ndarray]):
    try:
      status, body = self._request(
          'POST', '/v1/select_action',
          {'features': {name: np.asarray(value).tolist()
                        for name, value in features.items()}})
    except (OSError, http.client.HTTPException) as e:
      raise ReplicaUnreachable('replica {} unreachable: {!r}'.format(
          self.replica_id, e)) from e
    if status == 503:
      raise RequestRejected(body.get('error', 'replica shed the request'))
    if status != 200:
      raise RuntimeError('replica {} answered {}: {}'.format(
          self.replica_id, status, body.get('error')))
    return ServeResult(
        outputs={name: np.asarray(value)
                 for name, value in body['outputs'].items()},
        version=int(body['version']),
        latency_ms=float(body['latency_ms']))

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    return self._pool.submit(self._post_select_action, features)

  def snapshot(self) -> Dict[str, Any]:
    try:
      status, stats = self._request('GET', '/healthz',
                                    timeout_s=self.health_timeout_s)
    except (OSError, ValueError) as e:
      return {'alive': False, 'heartbeat_age_s': float('inf'),
              'queue_depth': 0.0, 'max_queue_depth': None, 'p99_ms': None,
              'requests': None, 'requests_per_sec': None, 'over_slo': False,
              'slo_ms': None, 'params_version': None, 'error': str(e)}
    latency = stats.get('latency_ms') or {}
    return {
        'alive': status == 200,
        'heartbeat_age_s': 0.0,
        'queue_depth': float(stats.get('queue_depth', 0) or 0),
        'max_queue_depth': stats.get('max_queue_depth'),
        'p99_ms': latency.get('p99'),
        'requests': stats.get('requests_total'),
        'requests_per_sec': None,
        'over_slo': False,
        'slo_ms': stats.get('slo_ms'),
        'params_version': stats.get('params_version'),
    }

  def close(self) -> None:
    self._pool.shutdown(wait=False)


# -- the router ---------------------------------------------------------------


class FleetRouter:
  """Spreads requests over replica handles; ejects the dead; retries once.

  Args:
    handles: initial replicas (add/remove later via
      :meth:`add_replica` / :meth:`remove_replica`).
    config: :class:`RouterConfig`.
    on_event: optional callback ``(kind, **payload)`` for lifecycle
      events (``eject``/``return``) — the fleet wires this into its
      telemetry stream; the router itself owns no files.
  """

  def __init__(self, handles: List[ReplicaHandle],
               config: Optional[RouterConfig] = None,
               on_event: Optional[Callable[..., None]] = None,
               registry=None,
               clock: Callable[[], float] = time.monotonic):
    self.config = config or RouterConfig()
    self._clock = clock
    self._on_event = on_event
    self._registry = registry or get_registry()
    # RLock: Future.cancel()/set_result() invoke done-callbacks
    # synchronously on the calling thread, and _on_replica_done re-takes
    # the lock the ejection pass already holds.
    self._lock = threading.RLock()
    self._handles: Dict[int, ReplicaHandle] = {}
    self._ejected: Set[int] = set()
    self._weights: Dict[int, float] = {}
    self._last_p99: Dict[int, float] = {}  # survives idle (empty) windows
    self._capacity: Dict[int, int] = {}
    self._outstanding: Dict[int, Dict[int, _RoutedRequest]] = {}
    self._snapshots: Dict[int, Dict[str, Any]] = {}
    self._ids = itertools.count()

    self._rejected = self._registry.counter(FLEET_REJECTED_COUNTER)
    self._retries = self._registry.counter(FLEET_RETRIES_COUNTER)
    self._ejections = self._registry.counter(FLEET_EJECTIONS_COUNTER)
    self._returns = self._registry.counter(FLEET_RETURNS_COUNTER)
    self._requests = self._registry.counter(FLEET_REQUESTS_COUNTER)
    self._replicas_gauge = self._registry.gauge(FLEET_REPLICAS_GAUGE)
    self._healthy_gauge = self._registry.gauge(FLEET_HEALTHY_GAUGE)
    self._weight_family = self._registry.gauge_family(
        FLEET_WEIGHT_GAUGE_FAMILY, ('replica',))
    # Family default = the predictors' default edges (whoever registers
    # the family first must agree — same rule as server.py); only the
    # fleet's own series runs on SLO-resolution edges.
    latency_family = self._registry.histogram_family(
        INFERENCE_LATENCY_HISTOGRAM, ('predictor',),
        bounds=DEFAULT_LATENCY_BUCKETS_MS)
    self._latency = latency_family.series(
        FLEET_REQUEST_LATENCY_SERIES, bounds=SLO_LATENCY_BUCKETS_MS)

    # Windowed fleet view, reset each report (the fleet record's input).
    self._window_lock = threading.Lock()
    self._window_hist = Histogram(SLO_LATENCY_BUCKETS_MS)
    self._window_completed = 0
    self._window_retried = 0

    for handle in handles:
      self.add_replica(handle)

    self._stop = threading.Event()
    self._monitor: Optional[threading.Thread] = None

  # -- lifecycle --------------------------------------------------------------

  def start(self) -> 'FleetRouter':
    if self._monitor is not None:
      raise RuntimeError('FleetRouter already started.')
    self.observe()  # arm weights/capacities before the first dispatch
    self._monitor = threading.Thread(target=self._monitor_loop,
                                     name='t2r-fleet-router', daemon=True)
    self._monitor.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._monitor is not None:
      self._monitor.join()
      self._monitor = None

  def _monitor_loop(self) -> None:
    while not self._stop.wait(self.config.health_interval_s):
      try:
        self.observe()
      except Exception as e:  # noqa: BLE001 — health passes must outlive
        # anything; a dead monitor silently freezes weights and ejection.
        _LOG.exception('FleetRouter health pass failed (kept routing): %s',
                       e)

  # -- replica set ------------------------------------------------------------

  def add_replica(self, handle: ReplicaHandle) -> None:
    with self._lock:
      if handle.replica_id in self._handles:
        raise ValueError('replica id {} already routed'.format(
            handle.replica_id))
      self._handles[handle.replica_id] = handle
      self._outstanding.setdefault(handle.replica_id, {})
      # Enter at the peers' MEAN weight, not 1.0: post-observe weights
      # are normalized to sum 1, and a 1.0 entry would make a freshly
      # scaled-up replica look ~N x less loaded than its equally-idle
      # peers — dogpiling it until the next health pass, at exactly the
      # high-load moment that triggered the scale-up.
      active = [w for rid, w in self._weights.items()
                if rid in self._handles and w > 0]
      self._weights.setdefault(
          handle.replica_id,
          (sum(active) / len(active)) if active else 1.0)
      self._capacity.setdefault(handle.replica_id,
                                _DEFAULT_REPLICA_CAPACITY)
      self._replicas_gauge.set(float(len(self._handles)))

  def remove_replica(self, replica_id: int) -> ReplicaHandle:
    """Takes a replica out of rotation (scale-down path).

    New dispatches stop immediately; requests already queued on it stay
    with it — the caller drains the handle (zero drops: the server's
    close answers its whole queue) before closing it.
    """
    with self._lock:
      handle = self._handles.pop(replica_id)
      self._ejected.discard(replica_id)
      self._outstanding.pop(replica_id, None)
      self._weights.pop(replica_id, None)
      self._last_p99.pop(replica_id, None)
      self._capacity.pop(replica_id, None)
      self._snapshots.pop(replica_id, None)
      self._replicas_gauge.set(float(len(self._handles)))
    return handle

  def replica_ids(self) -> List[int]:
    with self._lock:
      return sorted(self._handles)

  def healthy_ids(self) -> List[int]:
    with self._lock:
      return sorted(set(self._handles) - self._ejected)

  def ejected_ids(self) -> List[int]:
    with self._lock:
      return sorted(self._ejected)

  def handle(self, replica_id: int) -> ReplicaHandle:
    with self._lock:
      return self._handles[replica_id]

  # -- request path -----------------------------------------------------------

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    """Routes one request; returns the Future resolving to a
    :class:`RoutedResult`. Raises :class:`RequestRejected` on fleet-wide
    shed and RuntimeError when no replica is in rotation."""
    routed = _RoutedRequest(next(self._ids), dict(features),
                            self._clock(), _RETRY_LIMIT)
    self._dispatch(routed, admit=True)
    self._requests.inc()
    return routed.future

  def select_action(self, features: Dict[str, np.ndarray],
                    timeout_s: Optional[float] = None) -> RoutedResult:
    return self.submit(features).result(timeout=timeout_s)

  def _fleet_capacity_locked(self, healthy: List[int]) -> int:
    if self.config.max_fleet_pending is not None:
      return int(self.config.max_fleet_pending)
    return sum(self._capacity.get(i) or _DEFAULT_REPLICA_CAPACITY
               for i in healthy)

  def _pick_locked(self, healthy: List[int],
                   exclude: Set[int]) -> Optional[int]:
    candidates = [i for i in healthy if i not in exclude]
    if not candidates:
      return None
    # Weighted least-loaded: depth normalized by the telemetry weight.
    # +1 biases an idle tie toward the higher-weight (faster) replica.
    return min(candidates,
               key=lambda i: (len(self._outstanding[i]) + 1)
               / max(self._weights.get(i, 1.0), 1e-9))

  def _dispatch(self, routed: _RoutedRequest, admit: bool,
                exclude: Optional[Set[int]] = None) -> None:
    exclude = set(exclude or ())
    while True:
      with self._lock:
        healthy = [i for i in self._handles if i not in self._ejected]
        if not healthy:
          raise RuntimeError('no replicas in rotation')
        if admit:
          total = sum(len(self._outstanding[i]) for i in healthy)
          if total >= self._fleet_capacity_locked(healthy):
            # The shed decision, at the router: no replica queue was
            # touched for this request. Retries (admit=False) bypass —
            # an admitted request is a promise.
            self._rejected.inc()
            raise RequestRejected(
                'fleet saturated ({} pending >= capacity {}); request '
                'shed at the router'.format(
                    total, self._fleet_capacity_locked(healthy)))
          # Admitted: a later loop iteration (retrying a replica-level
          # rejection) must not re-face the cap — the promise holds
          # even if the fleet filled up in between.
          admit = False
        replica = self._pick_locked(healthy, exclude)
        if replica is None:
          raise RequestRejected(
              'every healthy replica rejected or is excluded for this '
              'request')
        handle = self._handles[replica]
        self._outstanding[replica][routed.request_id] = routed
        routed.replica = replica
      try:
        replica_future = handle.submit(routed.features)
      except Exception as e:  # noqa: BLE001 — classify below
        with self._lock:
          # .get(): the replica may have been REMOVED (scale-down racing
          # a submit against its mid-shutdown server) — the original
          # rejection must win, not a KeyError from the cleanup.
          self._outstanding.get(replica, {}).pop(routed.request_id, None)
        if isinstance(e, (RequestRejected, RuntimeError)) and \
            routed.retries_left > 0:
          # One replica-level rejection (its queue filled between the
          # router's cap check and the enqueue, or it is mid-shutdown):
          # spend the retry budget on a different replica.
          routed.retries_left -= 1
          routed.retried = True
          self._retries.inc()
          exclude.add(replica)
          continue
        # Spec violations (ValueError) and exhausted budgets fail THIS
        # caller synchronously — the single-server contract, preserved.
        raise e
      with self._lock:
        # Entry may have been cleared by a concurrent ejection pass (or
        # the replica removed) between submit and here; only attach the
        # future if we still own the slot.
        owned = self._outstanding.get(replica, {}).get(
            routed.request_id) is routed
        if owned:
          routed.replica_future = replica_future
      if owned:
        replica_future.add_done_callback(
            lambda f, r=routed, i=replica: self._on_replica_done(r, i, f))
      else:
        # An ejection pass raced this submit and already re-routed the
        # request: withdraw the replica-side copy so a revived zombie
        # cannot execute it (a copy already executing still cannot
        # double-deliver — _resolve is single-assignment).
        replica_future.cancel()
      return

  def _on_replica_done(self, routed: _RoutedRequest, replica: int,
                       future: Future) -> None:
    with self._lock:
      entry = self._outstanding.get(replica, {})
      if entry.get(routed.request_id) is routed:
        del entry[routed.request_id]
      # An ejection pass re-routed this request while the replica still
      # ran it (an HTTP request in flight cannot be cancelled): the peer
      # owns it now, and whatever this replica answers, a result or its
      # transport's failure, is dropped. The JAX package's router lets the
      # first answer win, and so can hand the caller the dead replica's
      # error while the retry is still running.
      stale = routed.replica != replica
    if future.cancelled() or stale:
      return  # an ejection pass took this request and re-routed it
    try:
      error = future.exception()
    except Exception as e:  # noqa: BLE001 — CancelledError race
      error = e
    if error is not None:
      # An HTTP replica's shed and its transport's failure arrive HERE
      # (its submit never raises synchronously; the 503 or the refused
      # connection resolves the pool future): give them the same
      # one-retry-on-a-peer semantics as a synchronous replica rejection.
      # Batch failures (anything else) propagate to the caller, the
      # single-server contract. (The JAX package's router fails the
      # caller on a transport failure: a replica killed under load loses
      # every request it held.)
      if isinstance(error, (RequestRejected, ReplicaUnreachable)) and \
          routed.retries_left > 0:
        routed.retries_left -= 1
        routed.retried = True
        self._retries.inc()
        try:
          self._dispatch(routed, admit=False, exclude={replica})
        except Exception as e:  # noqa: BLE001 — no peer left
          self._resolve(routed, error=e)
        return
      self._resolve(routed, error=error)
      return
    result = future.result()
    latency_ms = (self._clock() - routed.enqueued_at) * 1e3
    self._latency.record(latency_ms)
    with self._window_lock:
      self._window_hist.record(latency_ms)
      self._window_completed += 1
      if routed.retried:
        self._window_retried += 1
    self._resolve(routed, result=RoutedResult(
        outputs=result.outputs, version=result.version,
        latency_ms=latency_ms, request_id=routed.request_id,
        replica=replica, retried=routed.retried))

  def _resolve(self, routed: _RoutedRequest, result=None,
               error=None) -> None:
    """Resolves the caller-facing future AT MOST ONCE (a zombie replica
    racing a retry loses; a cancelled caller is tolerated)."""
    try:
      if error is not None:
        routed.future.set_exception(error)
      else:
        routed.future.set_result(result)
    except Exception:  # noqa: BLE001 — InvalidStateError: already
      pass  # answered by the other contender, or cancelled by caller

  # -- health / weights / ejection -------------------------------------------

  def observe(self) -> Dict[int, Dict[str, Any]]:
    """One health pass: snapshot replicas, recompute weights, eject the
    stale, re-arm the returned, retry the ejected replicas' in-queue
    requests. Returns the snapshots (the fleet record's raw input)."""
    with self._lock:
      handles = dict(self._handles)
    snapshots: Dict[int, Dict[str, Any]] = {}
    for replica_id, handle in sorted(handles.items()):
      try:
        snapshots[replica_id] = handle.snapshot()
      except Exception as e:  # noqa: BLE001 — a throwing snapshot IS dead
        snapshots[replica_id] = {'alive': False,
                                 'heartbeat_age_s': float('inf'),
                                 'p99_ms': None, 'queue_depth': 0.0,
                                 'max_queue_depth': None,
                                 'error': str(e)}
    stale = self.config.stale_after_s
    to_retry: List[_RoutedRequest] = []
    events: List[Tuple[str, Dict[str, Any]]] = []  # emitted post-lock
    with self._lock:
      healthy_now = []
      for replica_id, snap in snapshots.items():
        if replica_id not in self._handles:
          continue  # removed between snapshot and here
        dead = (not snap.get('alive')) or \
            float(snap.get('heartbeat_age_s') or 0.0) > stale
        if not dead:
          healthy_now.append(replica_id)
      for replica_id, snap in sorted(snapshots.items()):
        if replica_id not in self._handles:
          continue
        dead = replica_id not in healthy_now
        if dead and replica_id not in self._ejected and \
            any(h != replica_id for h in healthy_now):
          # Eject: latched, like host_dead — fired once, re-armed only
          # on return. Needs >= 1 healthy peer (all-dead is a fleet
          # outage the doctor pages on, not a routing decision).
          self._ejected.add(replica_id)
          self._ejections.inc()
          pending = list(self._outstanding[replica_id].values())
          self._outstanding[replica_id].clear()
          for routed in pending:
            # Claim it first: from here the ejected replica no longer owns
            # the request, so an answer or a transport failure it delivers
            # before the retry below is dispatched is dropped, and cannot
            # spend the retry a second time.
            routed.replica = None
            # Cancel the replica-side future FIRST: a zombie that
            # revives finds a cancelled future (the server's _answer
            # tolerates it) and can never double-deliver.
            if routed.replica_future is not None:
              routed.replica_future.cancel()
          to_retry.extend(pending)
          events.append(('eject',
                         {'replica': replica_id,
                          'heartbeat_age_s': snap.get('heartbeat_age_s'),
                          'in_queue_retried': len(pending)}))
        elif not dead and replica_id in self._ejected:
          self._ejected.discard(replica_id)
          self._returns.inc()
          events.append(('return', {'replica': replica_id}))
      for replica_id, snap in snapshots.items():
        if snap.get('max_queue_depth'):
          self._capacity[replica_id] = int(snap['max_queue_depth'])
      self._update_weights_locked(snapshots)
      self._snapshots = snapshots
      self._healthy_gauge.set(
          float(len(set(self._handles) - self._ejected)))
    # Events fire OUTSIDE the dispatch lock: the fleet's callback does
    # telemetry I/O and (on 'return') a version-reconcile that may read
    # a remote replica — none of which may stall submit()/dispatch.
    for kind, payload in events:
      self._emit(kind, **payload)
    for routed in to_retry:
      if routed.future.done():
        continue  # answered (or cancelled by its caller) already
      if routed.retries_left <= 0:
        self._resolve(routed, error=RuntimeError(
            'replica died and the retry budget is spent'))
        continue
      routed.retries_left -= 1
      routed.retried = True
      self._retries.inc()
      try:
        self._dispatch(routed, admit=False)  # admitted once already
      except Exception as e:  # noqa: BLE001 — no healthy peer left
        self._resolve(routed, error=e)
    return snapshots

  def _update_weights_locked(self,
                             snapshots: Dict[int, Dict[str, Any]]) -> None:
    floor = _P99_FLOOR_MS
    raw: Dict[int, float] = {}
    for replica_id in self._handles:
      if replica_id in self._ejected:
        continue
      p99 = (snapshots.get(replica_id) or {}).get('p99_ms')
      if p99:
        # Only a window that SERVED updates the signal: an idle (empty)
        # window reports p99 0, which is "no evidence", not "infinitely
        # fast" — the last traffic-bearing window's weight persists.
        self._last_p99[replica_id] = float(p99)
      if self._last_p99.get(replica_id):
        raw[replica_id] = 1.0 / max(self._last_p99[replica_id], floor)
    if raw:
      # Replicas with no window yet (just scaled up) enter at the
      # healthy median, not at a made-up extreme.
      median = sorted(raw.values())[len(raw) // 2]
    else:
      median = 1.0
    total = 0.0
    weights: Dict[int, float] = {}
    for replica_id in self._handles:
      if replica_id in self._ejected:
        weights[replica_id] = 0.0
        continue
      weights[replica_id] = raw.get(replica_id, median)
      total += weights[replica_id]
    if total > 0:
      for replica_id in weights:
        weights[replica_id] /= total
    self._weights = weights
    for replica_id, weight in weights.items():
      self._weight_family.series(str(replica_id)).set(weight)

  def _emit(self, kind: str, **payload) -> None:
    if self._on_event is None:
      return
    try:
      self._on_event(kind, **payload)
    except Exception as e:  # noqa: BLE001 — telemetry must not kill routing
      _LOG.exception('FleetRouter event callback failed: %s', e)

  # -- introspection ----------------------------------------------------------

  def outstanding_total(self) -> int:
    with self._lock:
      return sum(len(v) for v in self._outstanding.values())

  def table(self) -> Dict[int, Dict[str, Any]]:
    """Per-replica routing view: the fleet record's replica table."""
    with self._lock:
      out: Dict[int, Dict[str, Any]] = {}
      for replica_id in sorted(self._handles):
        snap = dict(self._snapshots.get(replica_id) or {})
        snap['weight'] = self._weights.get(replica_id, 0.0)
        snap['outstanding'] = len(self._outstanding[replica_id])
        snap['ejected'] = replica_id in self._ejected
        out[replica_id] = snap
      return out

  def window_stats(self) -> Dict[str, Any]:
    """Reset-on-read window counters + latency summary for one fleet
    report interval."""
    with self._window_lock:
      summary = self._window_hist.summary()
      self._window_hist.reset()
      completed = self._window_completed
      retried = self._window_retried
      self._window_completed = self._window_retried = 0
    return {'completed': completed, 'retried': retried,
            'latency': summary}

  def stats(self) -> Dict[str, Any]:
    """Cumulative router stats (frontend /healthz + bench)."""
    with self._lock:
      replica_count = len(self._handles)
      healthy = len(set(self._handles) - self._ejected)
      outstanding = sum(len(v) for v in self._outstanding.values())
    return {
        'replica_count': replica_count,
        'healthy_count': healthy,
        'queue_depth': outstanding,
        'requests_total': self._requests.value,
        'rejected_total': self._rejected.value,
        'retries_total': self._retries.value,
        'ejections_total': self._ejections.value,
        'returns_total': self._returns.value,
        'latency_ms': self._latency.summary(),
        'params_version': max(
            [int(s.get('params_version') or 0)
             for s in self._snapshots.values()] or [0]),
    }
