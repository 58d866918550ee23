"""The port's serving fleet on the CPU, against the JAX package's.

  * Control-plane parity: both packages' ``FleetRouter`` and
    ``ServingFleet`` driven by one script over the same scripted replica
    handles under one fake clock make the same decisions (routing weights
    and picks, sheds, ejections, retries, re-arms, scale events, the swap
    wave) and write the same ``t2r.serving_fleet.v1`` records, field for
    field, less the wall-clock times and pids.
  * The JAX package's fleet contracts (``tests/test_serving_fleet.py``) on
    the port's real ``PolicyServer`` replicas: handles, dispatch, the shed
    at the door, ejection with exactly-once retry, scaling with zero drops,
    the autoscaler, rolling swaps, the JAX package's later fixes, the
    telemetry layout and the HTTP door.
  * The JAX package's readers (``discover_hosts``, ``read_heartbeat``, the
    doctor) on fleet dirs the port wrote.
  * The slice: ``serve`` with ``--replicas 2`` on a checkpoint the port
    trained, every answer's q the JAX critic's on the same weights, and a
    newer checkpoint rolled through the fleet under load with no failed
    request; ``fleet_bench`` prints JAX's keys.

Replicas run numpy batch functions (the contracts are host logic) or the
tiny critic (num_convs 1, 1, 1). Torch runs one intra-op thread, so the
replica threads and the clients do not oversubscribe the CPU.
"""

import copy
import functools
import http.client
import json
import os
import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from tensor2robot_tpu.observability import TelemetryRegistry as JaxRegistry
from tensor2robot_tpu.observability import doctor
from tensor2robot_tpu.observability import read_telemetry as jax_read
from tensor2robot_tpu.observability.telemetry_file import (
    discover_hosts as jax_discover_hosts)
from tensor2robot_tpu.observability.telemetry_file import (
    read_heartbeat as jax_read_heartbeat)
from tensor2robot_tpu.serving import batching as jax_batching
from tensor2robot_tpu.serving import fleet as jax_fleet
from tensor2robot_tpu.serving import router as jax_router
from tensor2robot_tpu.serving import server as jax_server
from tensor2robot_tpu_torch.observability import TelemetryRegistry
from tensor2robot_tpu_torch.observability import discover_hosts
from tensor2robot_tpu_torch.observability import read_telemetry
from tensor2robot_tpu_torch.observability import set_registry
from tensor2robot_tpu_torch.serving import (
    SERVING_FLEET_BENCH_KEYS,
    FleetRouter,
    HttpReplicaHandle,
    LocalReplicaHandle,
    PolicyServer,
    ReplicaHandle,
    ReplicaUnreachable,
    RequestRejected,
    RouterConfig,
    ServeResult,
    ServingConfig,
    ServingFleet,
    ServingFleetConfig,
    replica_host_meta,
)
from tensor2robot_tpu_torch.serving import batching
from tensor2robot_tpu_torch.serving import fleet as port_fleet
from tensor2robot_tpu_torch.serving import router as port_router
from tensor2robot_tpu_torch.serving import server as port_server
from tensor2robot_tpu_torch.serving.frontend import build_http_server
# The JAX critic's import shim (a module fixture) and the trained weights'
# way back to flax.
from test_torch_qtopt import ref  # noqa: F401
from test_torch_serving import _init_features, _jax_critic, _to_flax



@pytest.fixture(autouse=True)
def one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture()
def registry():
  fresh = TelemetryRegistry()
  previous = set_registry(fresh)
  yield fresh
  set_registry(previous)


def _state(value, size=3):
  return {'x': np.full((size,), float(value), np.float32)}


def _echo_batch_fn(variables, features, seed):
  x = features['x']
  return {'y': x * variables['scale'],
          'version': np.full((x.shape[0],), variables['version'], np.int64)}


def _make_server(registry, scale=2.0, version=1, batch_fn=None,
                 telemetry=None, report_interval_s=0.05, max_queue_depth=64):
  server = PolicyServer(
      batch_fn or _echo_batch_fn, {'scale': scale, 'version': version},
      ServingConfig(max_batch_size=4, max_wait_ms=1.0,
                    max_queue_depth=max_queue_depth,
                    report_interval_s=report_interval_s),
      version=version, telemetry=telemetry, registry=registry)
  server.start()
  return server


def _drive(submit, n, concurrency=8, timeout_s=10.0):
  """n concurrent requests through ``submit``; returns (results, errors)."""
  results, errors = [], []
  lock = threading.Lock()
  todo = iter(range(n))

  def worker():
    while True:
      with lock:
        try:
          i = next(todo)
        except StopIteration:
          return
      try:
        result = submit(_state(i)).result(timeout=timeout_s)
        with lock:
          results.append((i, result))
      except Exception as e:  # noqa: BLE001 — errors are the assertion
        with lock:
          errors.append((i, e))

  threads = [threading.Thread(target=worker) for _ in range(concurrency)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  assert not any(t.is_alive() for t in threads)
  return results, errors


def _wait_for(condition, timeout_s=5.0):
  deadline = time.monotonic() + timeout_s
  while not condition():
    assert time.monotonic() < deadline, 'condition not met in time'
    time.sleep(0.01)


# -- control-plane parity with the JAX package -------------------------------

PACKAGES = {
    'jax': types.SimpleNamespace(
        router=jax_router, fleet=jax_fleet, Registry=JaxRegistry,
        RequestRejected=jax_batching.RequestRejected,
        ServeResult=jax_server.ServeResult),
    'port': types.SimpleNamespace(
        router=port_router, fleet=port_fleet, Registry=TelemetryRegistry,
        RequestRejected=batching.RequestRejected,
        ServeResult=port_server.ServeResult),
}


class ScriptedHandle:
  """A replica whose health, answers and rejections a script decides: its
  futures resolve only when the script answers them."""

  def __init__(self, replica_id, package, picks, telemetry=None):
    self.replica_id = replica_id
    self.package = package
    self.picks = picks
    self.telemetry = telemetry
    self.pending = []
    self.reject_next = 0
    self.swaps = []
    self.closed = False
    self.snap = {'alive': True, 'heartbeat_age_s': 0.0, 'queue_depth': 0.0,
                 'max_queue_depth': 4, 'p99_ms': None, 'requests': None,
                 'requests_per_sec': None, 'over_slo': False,
                 'slo_ms': 33.0, 'params_version': 1}
    if telemetry is not None:
      telemetry.log('serving_start', params_version=1)
      telemetry.heartbeat()
      telemetry.flush()

  def submit(self, features):
    value = float(np.asarray(features['x'])[0])
    if self.reject_next:
      self.reject_next -= 1
      self.picks.append(('rejected', self.replica_id, value))
      raise self.package.RequestRejected('scripted replica shed')
    self.picks.append(('pick', self.replica_id, value))
    future = Future()
    self.pending.append((value, future))
    return future

  def snapshot(self):
    return dict(self.snap)

  def swap_params(self, variables, version):
    self.swaps.append(int(version))
    self.snap['params_version'] = int(version)

  def answer_all(self):
    """Answers every pending future in order; a cancelled one (retried on
    a peer) stays unanswered. Returns the values answered."""
    answered = []
    for value, future in self.pending:
      if future.cancelled():
        continue
      future.set_result(self.package.ServeResult(
          outputs={'y': np.float32(2 * value)},
          version=self.snap['params_version'], latency_ms=1.0))
      answered.append(value)
    self.pending = []
    return answered

  def drain(self, timeout_s=30.0):
    return True

  def close(self):
    self.closed = True
    if self.telemetry is not None:
      self.telemetry.log('serving_stop', params_version=1)


def _entries(trace, kind):
  return [entry[1:] for entry in trace if entry[0] == kind]


def _strip(record, keys=('time', 'pid', 'hostname')):
  return {k: v for k, v in record.items() if k not in keys}


def _run_script(name, model_dir):
  """One scripted fleet life under a fake clock; returns its trace."""
  package = PACKAGES[name]
  now = [100.0]
  picks = []
  handles = {}

  def factory(replica_id, telemetry):
    handles[replica_id] = ScriptedHandle(replica_id, package, picks)
    return handles[replica_id]

  config = package.fleet.ServingFleetConfig(
      min_replicas=1, max_replicas=3, autoscale=True, scale_up_at=0.5,
      scale_down_at=0.1, scale_windows=2, report_interval_s=1e9,
      health_interval_s=1e9, stale_after_s=5.0, slo_ms=33.0,
      drain_timeout_s=1.0)
  fleet = package.fleet.ServingFleet(
      factory, config, model_dir=model_dir, initial_replicas=2,
      registry=package.Registry(), clock=lambda: now[0])
  trace = []
  callers = []

  def tick(seconds=1.0):
    now[0] += seconds

  def submit(values):
    for value in values:
      try:
        callers.append((value, fleet.submit({'x': np.full(3, value,
                                                          np.float32)})))
      except Exception as e:  # noqa: BLE001 — the outcome is traced
        trace.append(('refused', value, type(e).__name__, str(e)))

  def observe():
    fleet.router.observe()
    trace.append(('table', {i: {k: (round(v, 12) if isinstance(v, float)
                                    else v) for k, v in entry.items()}
                            for i, entry in fleet.router.table().items()}))

  def report():
    tick()
    trace.append(('record', _strip(fleet._report())))
    fleet._autoscale()
    trace.append(('replicas', fleet.router.replica_ids(),
                  fleet.router.ejected_ids()))

  fleet.start()
  handles[1].snap.update(p99_ms=10.0, requests=5)
  handles[2].snap.update(p99_ms=20.0, requests=5)
  tick()
  observe()
  submit(range(6))                       # weighted least-loaded picks
  tick(0.01)
  for replica_id in (1, 2):
    trace.append(('answered', replica_id, handles[replica_id].answer_all()))
  report()                               # utilization low: no scale
  submit(range(6, 16))                   # fill the fleet; the rest shed
  report()                               # high streak 1
  report()                               # high streak 2: scale up to 3
  handles[3].snap.update(p99_ms=15.0, requests=1)
  handles[2].snap.update(heartbeat_age_s=10.0)
  tick()
  observe()                              # eject 2, retry its queue once
  trace.append(('wave', fleet.rolling_swap({'w': 2}, 2)))
  handles[2].snap.update(heartbeat_age_s=0.0)
  tick()
  observe()                              # re-armed, reconciled onto v2
  trace.append(('swaps', {i: h.swaps for i, h in handles.items()}))
  handles[1].reject_next = handles[3].reject_next = 1
  submit([100.0, 101.0])                 # replica-level sheds, retried
  tick(0.02)
  for replica_id in sorted(handles):
    trace.append(('answered', replica_id, handles[replica_id].answer_all()))
  for value, future in callers:
    if future.done() and future.exception() is None:
      result = future.result()
      trace.append(('result', value, result.request_id, result.replica,
                    result.version, result.retried,
                    round(result.latency_ms, 9), float(result.outputs['y'])))
    else:
      trace.append(('result', value, future.done() and
                    type(future.exception()).__name__))
  report()                               # low streak 1
  report()                               # low streak 2: scale down
  report()
  trace.append(('stats', {k: v for k, v in fleet.stats().items()}))
  fleet.close()
  trace.append(('picks', picks))
  trace.append(('closed', {i: h.closed for i, h in handles.items()}))
  trace.append(('stream', [_strip(r) for r in
                           jax_read(os.path.join(model_dir,
                                                 'telemetry.0.jsonl'))]))
  trace.append(('heartbeat', _strip(jax_read_heartbeat(model_dir, 0))))
  return trace


def test_router_and_fleet_decide_and_record_as_jax_does(tmp_path):
  want = _run_script('jax', str(tmp_path / 'jax'))
  got = _run_script('port', str(tmp_path / 'port'))
  assert [entry[0] for entry in got] == [entry[0] for entry in want]
  for got_entry, want_entry in zip(got, want):
    assert got_entry == want_entry, got_entry[0]
  # The script reached every decision it is meant to compare.
  kinds = [r['kind'] for r in _entries(got, 'stream')[0][0]]
  for kind in ('serving_fleet_start', 'serving_fleet', 'serving_fleet_scale',
               'serving_fleet_eject', 'serving_fleet_return',
               'serving_fleet_swap', 'serving_fleet_stop'):
    assert kind in kinds, kind
  stats = _entries(got, 'stats')[0][0]
  assert stats['rejected_total'] > 0 and stats['retries_total'] >= 2
  assert stats['ejections_total'] == 1 and stats['returns_total'] == 1
  assert stats['scale_ups_total'] == 1 and stats['scale_downs_total'] >= 1
  assert _entries(got, 'swaps')[0][0][2] == [2]   # reconciled onto v2


# -- replica handles ----------------------------------------------------------


def test_local_handle_snapshot_reflects_the_server_window(registry):
  handle = LocalReplicaHandle(1, _make_server(registry))
  try:
    snap = handle.snapshot()
    assert snap['alive'] and snap['p99_ms'] is None  # no window yet
    assert snap['max_queue_depth'] == 64
    handle.server.select_action(_state(1), timeout_s=5.0)
    _wait_for(lambda: handle.snapshot()['p99_ms'] is not None)
    snap = handle.snapshot()
    assert snap['p99_ms'] > 0 and snap['heartbeat_age_s'] < 5.0
  finally:
    handle.close()
  assert not handle.snapshot()['alive']  # a closed server reads dead


def test_wedged_serve_loop_reads_as_a_stale_heartbeat(registry):
  gate, entered = threading.Event(), threading.Event()
  now = [0.0]

  def wedged(variables, features, seed):
    entered.set()
    gate.wait(10.0)
    return _echo_batch_fn(variables, features, seed)

  server = PolicyServer(wedged, {'scale': 2.0, 'version': 1},
                        ServingConfig(max_batch_size=4, max_wait_ms=0.0,
                                      report_interval_s=1.0),
                        registry=registry, clock=lambda: now[0])
  handle = LocalReplicaHandle(1, server.start())
  try:
    future = handle.submit(_state(1))   # wedges the loop inside the batch
    assert entered.wait(10.0)
    now[0] = 1e6
    snap = handle.snapshot()
    assert snap['alive']                # the thread lives, but...
    assert snap['heartbeat_age_s'] == 1e6  # ...the age grows unbounded
  finally:
    gate.set()
    future.result(timeout=10.0)
    handle.close()


@pytest.fixture()
def http_replica(registry):
  server = PolicyServer(_echo_batch_fn, {'scale': 2.0, 'version': 5},
                        ServingConfig(max_batch_size=4, max_wait_ms=1.0),
                        version=5, registry=registry,
                        feature_spec={'x': ((3,), np.float32)})
  server.start()
  httpd, port = build_http_server(server, port=0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  yield server, port
  httpd.shutdown()
  httpd.server_close()
  server.close()


@pytest.mark.parametrize('handle_package', ['port', 'jax'])
def test_http_handle_submits_and_snapshots(http_replica, handle_package):
  """The same wire: the port's handle and the JAX package's handle both
  front the port's server."""
  _, port = http_replica
  module = {'port': port_router, 'jax': jax_router}[handle_package]
  handle = module.HttpReplicaHandle(7, '127.0.0.1', port)
  try:
    result = handle.submit(_state(3)).result(timeout=10.0)
    np.testing.assert_allclose(result.outputs['y'], 6.0)
    assert result.version == 5
    snap = handle.snapshot()
    assert snap['alive'] and snap['params_version'] == 5
    assert snap['max_queue_depth'] == 64
  finally:
    handle.close()


def test_http_handle_fronts_a_jax_server(registry):
  """The port's handle speaks the JAX package's front end too."""
  from tensor2robot_tpu.serving.frontend import (
      build_http_server as jax_build_http_server)

  server = jax_server.PolicyServer(
      _echo_batch_fn, {'scale': 3.0, 'version': 4},
      jax_server.ServingConfig(max_batch_size=4, max_wait_ms=1.0),
      version=4, registry=JaxRegistry(),
      feature_spec={'x': ((3,), np.float32)})
  server.start()
  httpd, port = jax_build_http_server(server, port=0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  handle = HttpReplicaHandle(2, '127.0.0.1', port)
  try:
    result = handle.submit(_state(2)).result(timeout=10.0)
    np.testing.assert_allclose(result.outputs['y'], 6.0)
    assert result.version == 4 and handle.snapshot()['params_version'] == 4
  finally:
    handle.close()
    httpd.shutdown()
    httpd.server_close()
    server.close()


def test_dead_endpoint_reads_dead_within_the_health_timeout(registry):
  handle = HttpReplicaHandle(7, '127.0.0.1', 1, timeout_s=30.0,
                             health_timeout_s=0.5)  # nothing listens
  start = time.monotonic()
  snap = handle.snapshot()
  assert not snap['alive'] and snap['heartbeat_age_s'] == float('inf')
  assert time.monotonic() - start < 5.0   # the probe's timeout, not 30 s
  handle.close()


def test_router_mixes_local_and_http_replicas(registry, http_replica):
  _, port = http_replica
  local = LocalReplicaHandle(1, _make_server(registry, version=5))
  remote = HttpReplicaHandle(2, '127.0.0.1', port)
  router = FleetRouter([local, remote], RouterConfig(health_interval_s=0.05),
                       registry=registry).start()
  try:
    results, errors = _drive(router.submit, 40, concurrency=8)
    assert not errors
    assert {r.replica for _, r in results} == {1, 2}
    for i, result in results:
      np.testing.assert_allclose(result.outputs['y'], i * 2.0)
  finally:
    router.stop()
    local.close()
    remote.close()


# -- router dispatch ----------------------------------------------------------


def _router(registry, n=3, config=None, batch_fns=None):
  handles = [LocalReplicaHandle(i, _make_server(
      registry, batch_fn=(batch_fns or {}).get(i))) for i in range(1, n + 1)]
  router = FleetRouter(handles, config or RouterConfig(health_interval_s=0.05),
                       registry=registry)
  return router, handles


def test_router_spreads_load_and_ids_are_unique(registry):
  router, handles = _router(registry)
  router.start()
  try:
    results, errors = _drive(router.submit, 120, concurrency=16)
    assert not errors and len(results) == 120
    ids = [r.request_id for _, r in results]
    assert len(set(ids)) == len(ids)  # exactly-once delivery
    assert {r.replica for _, r in results} == {1, 2, 3}
    for i, result in results:
      np.testing.assert_allclose(result.outputs['y'], i * 2.0)
  finally:
    router.stop()
    for handle in handles:
      handle.close()


def test_router_weights_follow_the_windowed_p99(registry):
  def slow(variables, features, seed):
    time.sleep(0.02)
    return _echo_batch_fn(variables, features, seed)

  router, handles = _router(registry, n=2, batch_fns={2: slow})
  router.start()
  try:
    results, errors = _drive(router.submit, 60, concurrency=8)
    assert not errors
    time.sleep(0.1)  # closed report windows for the health pass
    router.observe()
    weights = {i: e['weight'] for i, e in router.table().items()}
    assert weights[1] > weights[2]
    served = [r.replica for _, r in results]
    assert served.count(1) > served.count(2)  # load followed the weights
  finally:
    router.stop()
    for handle in handles:
      handle.close()


def test_fleet_wide_shed_happens_before_any_replica_queue(registry):
  gate = threading.Event()

  def gated(variables, features, seed):
    gate.wait(10.0)
    return _echo_batch_fn(variables, features, seed)

  router, handles = _router(
      registry, n=2,
      config=RouterConfig(health_interval_s=0.05, max_fleet_pending=6),
      batch_fns={1: gated, 2: gated})
  router.start()
  futures = []
  try:
    shed = 0
    for i in range(40):
      try:
        futures.append(router.submit(_state(i)))
      except RequestRejected:
        shed += 1
    assert shed == 40 - 6
    assert registry.counter('serving/rejected').value == 0
    assert registry.counter('serving_fleet/rejected').value == shed
  finally:
    gate.set()
    for future in futures:
      future.result(timeout=10.0)  # admitted requests all complete
    router.stop()
    for handle in handles:
      handle.close()


def test_no_replicas_is_a_runtime_error(registry):
  router = FleetRouter([], RouterConfig(), registry=registry)
  with pytest.raises(RuntimeError, match='no replicas'):
    router.submit(_state(1))


# -- replica death under load -------------------------------------------------


def test_eject_retry_exactly_once_no_duplicate_executions(registry,
                                                          tmp_path):
  """Replica 2 wedges mid-stream: the router ejects it, its queued
  requests are retried exactly once on healthy peers, every request id is
  answered once, no request runs on two replicas, and the JAX package's
  doctor names the replica."""
  executed = {}
  executed_lock = threading.Lock()
  call_ids = iter(range(10**9))
  wedge, wedge_release = threading.Event(), threading.Event()

  def make_batch_fn(replica_id):
    def batch_fn(variables, features, seed):
      if replica_id == 2 and wedge.is_set():
        wedge_release.wait(45.0)  # the "killed" replica: wedged
        raise RuntimeError('zombie batch discarded')  # never scores
      call_id = next(call_ids)
      with executed_lock:
        # Padding repeats a row within one call; the same value in two
        # calls is a duplicate execution.
        for value in set(np.asarray(features['x'])[:, 0].tolist()):
          executed.setdefault(value, set()).add(call_id)
      return _echo_batch_fn(variables, features, seed)
    return batch_fn

  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(
        registry, batch_fn=make_batch_fn(replica_id), telemetry=telemetry))

  # A live replica whose heartbeat passed stale_after_s would be ejected
  # with a batch in flight, and that batch would run on a peer as well:
  # the bound sits well above a live loop's reports on a loaded machine.
  config = ServingFleetConfig(max_replicas=3, report_interval_s=0.1,
                              health_interval_s=0.05, stale_after_s=1.0,
                              drain_timeout_s=2.0)
  fleet = ServingFleet(factory, config, model_dir=str(tmp_path),
                       initial_replicas=3, registry=registry)
  fleet.start()
  results, errors = [], []
  stop = threading.Event()
  lock = threading.Lock()
  values = iter(range(10**9))

  def client():
    while not stop.is_set():
      with lock:
        value = next(values)
      try:
        result = fleet.select_action(_state(value), timeout_s=30.0)
        with lock:
          results.append((value, result))
      except Exception as e:  # noqa: BLE001
        with lock:
          errors.append((value, e))

  threads = [threading.Thread(target=client) for _ in range(8)]
  for t in threads:
    t.start()
  try:
    time.sleep(0.2)   # all three replicas serving
    wedge.set()       # replica 2 "dies" mid-stream
    _wait_for(lambda: 2 in fleet.router.ejected_ids())
    assert fleet.router.ejected_ids() == [2]
    time.sleep(0.3)   # serving on the peers after the ejection
  finally:
    stop.set()
    for t in threads:
      t.join(timeout=60)
  try:
    assert not errors
    ids = [r.request_id for _, r in results]
    assert len(set(ids)) == len(ids)
    retried = [r for _, r in results if r.retried]
    assert retried and all(r.replica != 2 for r in retried)
    assert not {v: c for v, c in executed.items() if len(c) > 1}
    for value, result in results:
      np.testing.assert_allclose(result.outputs['y'], value * 2.0)
    time.sleep(0.15)  # one more fleet window carrying the ejection
    crit = [f for f in doctor.diagnose(str(tmp_path))
            if f['severity'] == doctor.CRITICAL
            and (f.get('detail') or {}).get('kind') == 'fleet_replica_ejected']
    assert crit and crit[0]['detail']['replicas'] == ['2']
  finally:
    wedge_release.set()
    fleet.close()


def test_returned_replica_re_arms_into_rotation(registry):
  wedge = threading.Event()
  wedge.set()

  def flaky(variables, features, seed):
    if wedge.is_set():
      time.sleep(0.4)
    return _echo_batch_fn(variables, features, seed)

  fast = LocalReplicaHandle(1, _make_server(registry, report_interval_s=0.03))
  sick = LocalReplicaHandle(2, _make_server(registry, batch_fn=flaky,
                                            report_interval_s=0.03))
  router = FleetRouter([fast, sick], RouterConfig(health_interval_s=0.03,
                                                  stale_after_s=0.15),
                       registry=registry).start()
  try:
    sick.submit(_state(0))  # wedges replica 2's loop past staleness
    _wait_for(lambda: 2 in router.ejected_ids())
    assert router.ejected_ids() == [2]
    wedge.clear()           # the replica recovers and reports again
    _wait_for(lambda: not router.ejected_ids())
    assert registry.counter('serving_fleet/returns').value == 1
  finally:
    router.stop()
    fast.close()
    sick.close()


def test_a_dead_http_replica_loses_no_request(registry, http_replica):
  """An HTTP replica whose door goes away under load: its refused requests
  are retried once on the local peer, it is ejected, and no caller sees a
  failure (the JAX package's router fails them)."""
  server, port = http_replica
  local = LocalReplicaHandle(1, _make_server(registry, version=5))
  remote = HttpReplicaHandle(2, '127.0.0.1', port, health_timeout_s=0.5)
  router = FleetRouter([local, remote], RouterConfig(health_interval_s=0.05),
                       registry=registry).start()
  try:
    results, errors = _drive(router.submit, 20, concurrency=4)
    assert not errors and {r.replica for _, r in results} == {1, 2}
    remote.port = 1   # nothing listens there: the replica is gone
    results, errors = _drive(router.submit, 40, concurrency=8)
    assert not errors and len(results) == 40
    retried = [r for _, r in results if r.retried]
    assert all(r.replica == 1 for _, r in results)
    assert retried and len({r.request_id for _, r in results}) == 40
    _wait_for(lambda: router.ejected_ids() == [2])
  finally:
    router.stop()
    local.close()
    remote.close()


@pytest.mark.parametrize('late', ['after_the_retry', 'before_the_retry'])
def test_a_re_routed_requests_late_answer_is_dropped(registry, late):
  """A request still running on a replica when the replica is ejected
  (an HTTP request cannot be cancelled) is retried once on the peer; what
  the ejected replica delivers later, its transport's failure or a result,
  never reaches the caller, who gets the peer's answer once. The late
  delivery may land after the retry is dispatched, or between the ejection
  and the retry (from the eject event's callback), where it must not spend
  the retry budget a second time."""
  running = []

  def deliver():
    running[0].set_exception(ReplicaUnreachable('connection reset'))
    running[1].set_result(ServeResult(outputs={'y': np.float32(-1)},
                                      version=9, latency_ms=0.0))

  class Wedged(_StaticSnapshot):
    replica_id = 2
    alive = True

    def submit(self, features):
      future = Future()
      future.set_running_or_notify_cancel()   # in flight: cannot cancel
      running.append(future)
      return future

    def snapshot(self):
      return dict(super().snapshot(), alive=self.alive)

  def on_event(kind, **payload):
    if kind == 'eject' and late == 'before_the_retry':
      deliver()

  wedged = Wedged()
  peer = LocalReplicaHandle(1, _make_server(registry))
  router = FleetRouter([wedged, peer], RouterConfig(health_interval_s=10.0),
                       on_event=on_event, registry=registry)
  router.observe()
  try:
    futures = []
    while len(running) < 2:   # until the wedged replica holds two
      futures.append(router.submit(_state(len(futures))))
    wedged.alive = False
    router.observe()              # eject 2: retry its two on the peer
    if late == 'after_the_retry':
      deliver()
    for value, future in enumerate(futures):
      result = future.result(timeout=10.0)
      assert result.replica == 1 and result.version == 1
      np.testing.assert_allclose(result.outputs['y'], value * 2.0)
    assert registry.counter('serving_fleet/retries').value == 2
  finally:
    peer.close()


# -- fleet lifecycle: scaling and rolling swaps --------------------------------


def _factory(registry, created=None, batch_ms=0.0):
  def factory(replica_id, telemetry):
    if created is not None:
      created.append(replica_id)

    def batch_fn(variables, features, seed):
      if batch_ms:
        time.sleep(batch_ms / 1e3)
      return _echo_batch_fn(variables, features, seed)

    return LocalReplicaHandle(replica_id, _make_server(
        registry, batch_fn=batch_fn, telemetry=telemetry, max_queue_depth=8))
  return factory


def test_scale_up_and_down_with_zero_drops(registry, tmp_path):
  created = []
  config = ServingFleetConfig(max_replicas=3, report_interval_s=0.1,
                              health_interval_s=0.05, drain_timeout_s=5.0)
  fleet = ServingFleet(_factory(registry, created), config,
                       model_dir=str(tmp_path), initial_replicas=1,
                       registry=registry)
  with fleet:
    replica_id, ready_s = fleet.scale_up(reason='test')
    assert replica_id == 2 and ready_s >= 0.0
    assert fleet.last_scaleup_seconds == ready_s
    assert fleet.router.replica_ids() == [1, 2]
    results, errors = _drive(fleet.submit, 40, concurrency=8)
    assert not errors and len(results) == 40
    assert fleet.scale_down(reason='test') in (1, 2)
    assert len(fleet.router.replica_ids()) == 1
    results, errors = _drive(fleet.submit, 10, concurrency=4)
    assert not errors
    with pytest.raises(RuntimeError, match='min_replicas'):
      fleet.scale_down()
  assert created == [1, 2]
  records = read_telemetry(str(tmp_path / 'telemetry.0.jsonl'))
  scales = [r for r in records if r['kind'] == 'serving_fleet_scale']
  assert [s['direction'] for s in scales] == ['up', 'down']
  assert records[-1]['kind'] == 'serving_fleet_stop'


def test_scale_up_refused_at_max(registry):
  fleet = ServingFleet(_factory(registry),
                       ServingFleetConfig(max_replicas=1,
                                          report_interval_s=0.1),
                       initial_replicas=1, registry=registry)
  with fleet:
    with pytest.raises(RuntimeError, match='max_replicas'):
      fleet.scale_up()


def test_autoscaler_follows_the_demand_curve(registry):
  config = ServingFleetConfig(
      min_replicas=1, max_replicas=3, autoscale=True, scale_up_at=0.4,
      scale_down_at=0.05, scale_windows=2, report_interval_s=0.05,
      health_interval_s=0.05, drain_timeout_s=5.0)
  fleet = ServingFleet(_factory(registry, batch_ms=30.0), config,
                       initial_replicas=1, registry=registry)
  futures = []
  with fleet:
    stop_pump = threading.Event()

    def pump():
      while not stop_pump.is_set():
        try:
          futures.append(fleet.submit(_state(1)))
        except RequestRejected:
          pass  # saturated IS the demand signal
        time.sleep(0.002)

    pump_thread = threading.Thread(target=pump)
    pump_thread.start()
    try:
      _wait_for(lambda: len(fleet.router.replica_ids()) == 3, 10.0)
    finally:
      stop_pump.set()
      pump_thread.join(timeout=10)
    for future in futures:
      future.result(timeout=30.0)  # every admitted request answered
    _wait_for(lambda: len(fleet.router.replica_ids()) == 1, 10.0)
  assert registry.counter('serving_fleet/scale_ups').value == 2
  assert registry.counter('serving_fleet/scale_downs').value == 2


def test_rolling_swap_under_load_serves_both_versions(registry, tmp_path):
  def slowish(variables, features, seed):
    time.sleep(0.002)
    return _echo_batch_fn(variables, features, seed)

  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(
        registry, batch_fn=slowish, telemetry=telemetry))

  config = ServingFleetConfig(max_replicas=3, report_interval_s=0.05,
                              health_interval_s=0.05)
  fleet = ServingFleet(factory, config, model_dir=str(tmp_path),
                       initial_replicas=3, registry=registry)
  results, failures = [], []
  stop = threading.Event()

  def client(value):
    while not stop.is_set():
      try:
        results.append((value, fleet.select_action(_state(value),
                                                    timeout_s=10.0)))
      except Exception as e:  # noqa: BLE001
        failures.append(e)

  with fleet:
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
      t.start()
    time.sleep(0.1)
    wave = fleet.rolling_swap({'scale': 3.0, 'version': 2}, 2, pause_s=0.02)
    time.sleep(0.1)
    stop.set()
    for t in threads:
      t.join(timeout=60)
  assert wave == [1, 2, 3] and not failures
  assert {r.version for _, r in results} == {1, 2}
  for value, result in results:
    scale = {1: 2.0, 2: 3.0}[result.version]
    np.testing.assert_allclose(result.outputs['y'], value * scale)
    assert int(result.outputs['version']) == result.version
  swaps = [r for r in read_telemetry(str(tmp_path / 'telemetry.0.jsonl'))
           if r['kind'] == 'serving_fleet_swap']
  assert len(swaps) == 1 and swaps[0]['wave'] == [1, 2, 3]


# -- the JAX package's later fixes, on the port -------------------------------


def test_rearmed_replica_is_reconciled_onto_the_swap_version(registry):
  wedge, released = threading.Event(), threading.Event()

  def gated(variables, features, seed):
    if wedge.is_set():
      released.wait(10.0)
    return _echo_batch_fn(variables, features, seed)

  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(
        registry, batch_fn=gated if replica_id == 2 else None,
        telemetry=telemetry, report_interval_s=0.03))

  config = ServingFleetConfig(max_replicas=2, report_interval_s=0.1,
                              health_interval_s=0.03, stale_after_s=0.15,
                              drain_timeout_s=2.0)
  with ServingFleet(factory, config, initial_replicas=2,
                    registry=registry) as fleet:
    wedge.set()
    fleet.router.handle(2).submit(_state(0))  # wedges replica 2
    _wait_for(lambda: 2 in fleet.router.ejected_ids())
    assert fleet.rolling_swap({'scale': 5.0, 'version': 2}, 2) == [1]
    wedge.clear()
    released.set()  # replica 2 recovers
    _wait_for(lambda: not fleet.router.ejected_ids())
    assert fleet.router.handle(2).server.params_version == 2
    result = fleet.router.handle(2).submit(_state(3)).result(timeout=5.0)
    assert result.version == 2
    np.testing.assert_allclose(result.outputs['y'], 15.0)


class _StaticSnapshot(ReplicaHandle):
  def snapshot(self):
    return {'alive': True, 'heartbeat_age_s': 0.0, 'queue_depth': 0.0,
            'max_queue_depth': 64, 'p99_ms': None, 'requests': None,
            'requests_per_sec': None, 'over_slo': False, 'slo_ms': 33.0,
            'params_version': 1}


@pytest.mark.parametrize('shed', ['synchronous', 'in_the_future'])
def test_a_replica_level_shed_is_retried_on_a_peer(registry, shed):
  """Admission is a promise: a request that passed the router's cap and
  then met a replica's rejection, raised at once (a local replica) or in
  its future (an HTTP replica's 503), is retried once on a peer, even when
  the fleet filled up in between."""
  real = LocalReplicaHandle(2, _make_server(registry))
  box = []

  class Shedding(_StaticSnapshot):
    replica_id = 1
    sheds = 0

    def submit(self, features):
      type(self).sheds += 1
      if shed == 'synchronous':
        with box[0]._lock:   # the fleet fills between check and enqueue
          box[0]._outstanding[2][999_999] = object()
        raise RequestRejected('queue filled between check and enqueue')
      future = Future()
      future.set_exception(RequestRejected('remote replied 503'))
      return future

  router = FleetRouter([Shedding(), real],
                       RouterConfig(health_interval_s=10.0,
                                    max_fleet_pending=1 if shed ==
                                    'synchronous' else None),
                       registry=registry)
  box.append(router)
  try:
    result = router.submit(_state(4)).result(timeout=10.0)
    assert Shedding.sheds == 1
    assert result.retried and result.replica == 2
    np.testing.assert_allclose(result.outputs['y'], 8.0)
    assert registry.counter('serving_fleet/rejected').value == 0
    assert registry.counter('serving_fleet/retries').value == 1
  finally:
    with router._lock:
      router._outstanding[2].pop(999_999, None)
    real.close()


def test_failed_spawn_leaks_no_phantom_replica_stream(registry, tmp_path):
  fail = threading.Event()

  def factory(replica_id, telemetry):
    if fail.is_set():
      raise RuntimeError('checkpoint store exploded')
    return LocalReplicaHandle(replica_id, _make_server(
        registry, telemetry=telemetry))

  fleet = ServingFleet(factory, ServingFleetConfig(max_replicas=3,
                                                   report_interval_s=0.5),
                       model_dir=str(tmp_path), initial_replicas=1,
                       registry=registry)
  with fleet:
    fail.set()
    with pytest.raises(RuntimeError, match='exploded'):
      fleet.scale_up()
    assert 2 not in fleet._replica_telemetry
    assert not (tmp_path / 'telemetry.2.jsonl').exists()
    fail.clear()
    assert fleet.scale_up()[0] == 3   # the fleet recovers; the id burned
    assert not _drive(fleet.submit, 10, concurrency=4)[1]
  assert sorted(jax_discover_hosts(str(tmp_path))) == [0, 1, 3]


def test_fresh_replica_enters_at_the_peers_mean_weight(registry):
  handles = [LocalReplicaHandle(i, _make_server(registry)) for i in (1, 2)]
  router = FleetRouter(handles, RouterConfig(health_interval_s=10.0),
                       registry=registry)
  try:
    for i in range(20):
      router.submit(_state(i)).result(timeout=10.0)
    time.sleep(0.1)
    router.observe()   # weights normalized to sum 1 (about 0.5 each)
    late = LocalReplicaHandle(3, _make_server(registry))
    handles.append(late)
    router.add_replica(late)
    weights = {i: e['weight'] for i, e in router.table().items()}
    assert weights[3] <= max(weights[1], weights[2]) * 1.5
  finally:
    for handle in handles:
      handle.close()


def test_close_after_a_failed_start_releases_everything(registry, tmp_path):
  spawned = []

  def factory(replica_id, telemetry):
    if replica_id == 2:
      raise RuntimeError('replica 2 factory exploded')
    handle = LocalReplicaHandle(replica_id, _make_server(
        registry, telemetry=telemetry))
    spawned.append(handle)
    return handle

  fleet = ServingFleet(factory, ServingFleetConfig(max_replicas=3,
                                                   report_interval_s=0.5),
                       model_dir=str(tmp_path), initial_replicas=3,
                       registry=registry)
  with pytest.raises(RuntimeError, match='exploded'):
    fleet.start()
  assert spawned and not spawned[0].server.alive
  assert fleet._replica_telemetry == {}
  fleet.close()


def test_close_on_a_never_started_fleet_is_safe(registry, tmp_path):
  fleet = ServingFleet(
      lambda rid, t: (_ for _ in ()).throw(AssertionError('no spawn')),
      ServingFleetConfig(), model_dir=str(tmp_path), registry=registry)
  fleet.close()
  assert read_telemetry(str(tmp_path / 'telemetry.0.jsonl')) == []


def test_burned_ids_keep_the_identity_self_consistent(registry, tmp_path):
  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(
        registry, telemetry=telemetry))

  config = ServingFleetConfig(min_replicas=1, max_replicas=2,
                              report_interval_s=0.5)
  with ServingFleet(factory, config, model_dir=str(tmp_path),
                    initial_replicas=2, registry=registry) as fleet:
    fleet.scale_down(replica_id=1)
    assert fleet.scale_up()[0] == 3   # ids never reused: 3 > max 2
    fleet.select_action(_state(1), timeout_s=10.0)
    time.sleep(0.1)
  records = read_telemetry(str(tmp_path / 'telemetry.3.jsonl'))
  assert records
  assert all(r['process_index'] < r['process_count'] for r in records)


# -- the telemetry layout, read by the JAX package ----------------------------


def _run_fleet(registry, model_dir):
  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(
        registry, telemetry=telemetry))

  config = ServingFleetConfig(max_replicas=3, report_interval_s=0.05,
                              health_interval_s=0.05, slo_ms=10_000.0)
  with ServingFleet(factory, config, model_dir=model_dir,
                    initial_replicas=2, registry=registry) as fleet:
    assert not _drive(fleet.submit, 30, concurrency=6)[1]
    time.sleep(0.15)   # replica and fleet report windows close


def test_indexed_streams_the_router_owns_stream_zero(registry, tmp_path):
  _run_fleet(registry, str(tmp_path))
  hosts = jax_discover_hosts(str(tmp_path))
  assert hosts == discover_hosts(str(tmp_path))
  assert sorted(hosts) == [0, 1, 2]
  router_records = jax_read(hosts[0]['telemetry'])
  kinds = {r['kind'] for r in router_records}
  assert 'serving_fleet' in kinds and 'serving' not in kinds
  for replica in (1, 2):
    records = jax_read(hosts[replica]['telemetry'])
    kinds = {r['kind'] for r in records}
    assert 'serving' in kinds and 'serving_fleet' not in kinds
    assert all(r['process_index'] == replica for r in records)
    beat = jax_read_heartbeat(str(tmp_path), process_index=replica)
    assert beat['process_index'] == replica and beat['process_count'] == 4
  assert jax_read_heartbeat(str(tmp_path))['process_index'] == 0


def test_replica_ids_are_one_based():
  with pytest.raises(ValueError, match='1-based'):
    replica_host_meta(0, 4)


def test_jax_doctor_judges_the_router_stream(registry, tmp_path):
  _run_fleet(registry, str(tmp_path))
  findings = doctor.diagnose(str(tmp_path))
  assert not any(f['severity'] == doctor.CRITICAL for f in findings)
  healthy = [f for f in findings
             if (f.get('detail') or {}).get('kind') == 'fleet_healthy']
  assert healthy and healthy[0]['detail']['replica_count'] == 2


@pytest.mark.parametrize('case', ['breach', 'ejected', 'clean_stopped',
                                  'breach_stopped'])
def test_jax_doctor_on_a_port_fleet_dir(tmp_path, case):
  """The port's fleet writes the dir (scripted replicas, the JAX doctor's
  cases): a breaching or an ejected replica is CRITICAL while the fleet is
  live, a stopped fleet downgrades a breach to WARNING, a clean one is
  healthy."""
  package = PACKAGES['port']
  picks, handles = [], {}

  def factory(replica_id, telemetry):
    handles[replica_id] = ScriptedHandle(replica_id, package, picks,
                                         telemetry=telemetry)
    return handles[replica_id]

  fleet = ServingFleet(factory, ServingFleetConfig(
      max_replicas=3, report_interval_s=1e9, health_interval_s=1e9),
                       model_dir=str(tmp_path), initial_replicas=3,
                       registry=TelemetryRegistry())
  fleet.start()
  for replica_id, handle in handles.items():
    breach = case.startswith('breach') and replica_id == 2
    handle.snap.update(p99_ms=48.2 if breach else 12.0 + replica_id,
                       over_slo=breach, requests=100)
  if case == 'ejected':
    handles[3].snap.update(alive=False)
  fleet.router.observe()
  fleet._report()
  if case.endswith('stopped'):
    fleet.close()
  else:
    fleet._telemetry.flush()
  try:
    findings = doctor.diagnose(str(tmp_path))
  finally:
    fleet.close()
  by_kind = {(f.get('detail') or {}).get('kind'): f for f in findings}
  if case == 'breach':
    finding = by_kind['fleet_replica_over_slo']
    assert finding['severity'] == doctor.CRITICAL
    assert finding['detail']['replica'] == '2'
    assert finding['detail']['p99_ms'] == 48.2
  elif case == 'ejected':
    finding = by_kind['fleet_replica_ejected']
    assert finding['severity'] == doctor.CRITICAL
    assert finding['detail']['replicas'] == ['3']
  elif case == 'clean_stopped':
    assert not any(f['severity'] in (doctor.CRITICAL, doctor.WARNING)
                   for f in findings), findings
    assert 'fleet_healthy' in by_kind
  else:
    assert not any(f['severity'] == doctor.CRITICAL for f in findings)
    finding = by_kind['fleet_replica_over_slo']
    assert finding['severity'] == doctor.WARNING
    assert finding['detail']['replica'] == '2'


# -- the HTTP door ----------------------------------------------------------


def test_the_door_answers_a_fleet_wide_shed_503(registry):
  gate = threading.Event()

  def gated(variables, features, seed):
    gate.wait(10.0)
    return _echo_batch_fn(variables, features, seed)

  def factory(replica_id, telemetry):
    return LocalReplicaHandle(replica_id, _make_server(registry,
                                                       batch_fn=gated))

  config = ServingFleetConfig(max_replicas=2, report_interval_s=0.5,
                              health_interval_s=0.1, max_fleet_pending=4,
                              drain_timeout_s=15.0)
  fleet = ServingFleet(factory, config, initial_replicas=2,
                       registry=registry)
  fleet.start()
  httpd, port = build_http_server(fleet, port=0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  body = json.dumps({'features': {'x': [1.0, 2.0, 3.0]}})
  try:
    futures = [fleet.submit(_state(i)) for i in range(4)]  # the cap
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=10)
    conn.request('POST', '/v1/select_action', body=body,
                 headers={'Content-Type': 'application/json'})
    response = conn.getresponse()
    reply = json.loads(response.read())
    conn.close()
    assert response.status == 503 and 'shed at the router' in reply['error']
    gate.set()
    for future in futures:
      future.result(timeout=10.0)
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=10)
    conn.request('POST', '/v1/select_action', body=body,
                 headers={'Content-Type': 'application/json'})
    response = conn.getresponse()
    reply = json.loads(response.read())
    assert response.status == 200
    np.testing.assert_allclose(reply['outputs']['y'], [2.0, 4.0, 6.0])
    conn.request('GET', '/healthz')
    health = json.loads(conn.getresponse().read())
    conn.request('GET', '/metricz')
    metrics = json.loads(conn.getresponse().read())
    conn.close()
    assert health['replica_count'] == 2 and health['rejected_total'] >= 1
    assert metrics['serving_fleet/rejected'] >= 1
  finally:
    gate.set()
    httpd.shutdown()
    httpd.server_close()
    fleet.close()


# -- the slice: serve --replicas on the port's checkpoint, against JAX --------

TINY_CEM = ['--cem_samples', '4', '--cem_iters', '2', '--num_elites', '2']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
  """A checkpoint the port's trainer wrote: the tiny critic, one step on
  random frames."""
  import contextlib
  import io

  from tensor2robot_tpu_torch.trainer import train_eval

  model_dir = str(tmp_path_factory.mktemp('trained'))
  with contextlib.redirect_stdout(io.StringIO()):
    assert train_eval.main([
        '--device', 'cpu', '--num_convs', '1,1,1', '--batch_size', '2',
        '--max_train_steps', '1', '--model_dir', model_dir]) == 0
  return model_dir


def _jax_q(ref, weights, states, actions):
  """The JAX critic's PREDICT q (center crop, / 255, the network) for each
  state and action on each version's weights (``{version: (avg_params,
  model_state)}``, the port's, converted back to flax), in one compiled
  program: ``{version: q [N]}``."""
  import jax

  from tensor2robot_tpu.specs.struct import SpecStruct

  jax_model = _jax_critic(ref)
  template = jax.eval_shape(functools.partial(
      jax_model.create_network().init, jax.random.PRNGKey(0),
      _init_features(ref), mode='predict', train=False))

  @jax.jit
  def q_of(variables, features):
    processed, _ = jax_model.preprocessor.preprocess(
        SpecStruct(features), None, 'predict', rng=None)
    outputs, _ = jax_model.inference_network_fn(variables, processed, None,
                                                'predict', None)
    return outputs['q_predicted'].reshape(-1)

  out = {}
  for version, (params, model_state) in weights.items():
    features = {'state/image': np.stack([s['image'] for s in states[version]])}
    action = np.stack(actions[version]).astype(np.float32)
    offset = 0
    for key, size in ref.t2r_models.ACTION_DIM_LAYOUT:
      features['action/' + key] = action[:, offset:offset + size]
      offset += size
    for key in ('gripper_closed', 'height_to_bottom'):
      features['action/' + key] = np.asarray(
          [[s[key]] for s in states[version]], np.float32)
    out[version] = np.asarray(q_of(
        {'params': _to_flax(params, template['params']),
         'batch_stats': _to_flax(model_state, template['batch_stats'])},
        features))
  return out


def test_the_fleet_serves_the_jax_critics_q_and_rolls_a_newer_checkpoint(
    ref, trained, registry, tmp_path):
  """``serve --replicas 2`` on the port's checkpoint: each replica calls
  the weights through its own module, every answer's q is the JAX
  critic's on the weights of the version it is labelled with (1e-5, as
  tests/test_torch_qtopt.py holds the two critics), and a newer
  checkpoint rolls through the fleet under load with no failed request."""
  import shutil

  from tensor2robot_tpu_torch.serving import serve
  from tensor2robot_tpu_torch.trainer import checkpointing

  model_dir = str(tmp_path / 'model')
  shutil.copytree(trained, model_dir)
  args = serve.make_parser().parse_args(
      ['--device', 'cpu', '--checkpoint_dir', model_dir, '--replicas', '2',
       '--num_convs', '1,1,1', '--max_batch_size', '2', '--max_wait_ms', '1',
       '--poll_secs', '0.1', '--fleet_report_interval_s', '0.2',
       '--report_interval_s', '0.2'] + TINY_CEM)
  serving = serve.start(args)
  fleet = serving.service
  results, failures = [], []
  stop = threading.Event()
  lock = threading.Lock()

  def client(seed):
    rng = np.random.RandomState(seed)
    state = serve.synthetic_state(serving.feature_spec, rng)
    while not stop.is_set():
      try:
        result = fleet.select_action(state, timeout_s=60)
      except Exception as e:  # noqa: BLE001 — counted, fails below
        failures.append(repr(e))
        continue
      with lock:
        results.append((state, result))

  threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
  try:
    assert serving.is_fleet and fleet.router.replica_ids() == [1, 2]
    modules = []
    for replica_id in (1, 2):
      batch_fn = fleet.router.handle(replica_id).server._batch_fn
      modules += [cell.cell_contents for cell in batch_fn.__closure__
                  if isinstance(cell.cell_contents, torch.nn.Module)]
    assert len(modules) == 2 and modules[0] is not modules[1]
    assert all(m is not serving.model.network.grasping44 for m in modules)
    for t in threads:
      t.start()
    _wait_for(lambda: {r.replica for _, r in results} == {1, 2}, 30.0)
    state = checkpointing.CheckpointManager(model_dir).restore()
    first_step = state.step
    state.step = 7
    state.avg_params = {k: v * 1.5 for k, v in state.avg_params.items()}
    checkpointing.CheckpointManager(model_dir).save(state)
    _wait_for(lambda: any(r.version == 7 for _, r in results), 30.0)
    time.sleep(0.3)
  finally:
    stop.set()
    for t in threads:
      t.join(timeout=60)
    serving.stop()
  assert not failures
  assert [version for version, _ in serving.swaps] == [7]
  versions = {r.version for _, r in results}
  assert versions == {first_step, 7}
  records = read_telemetry(os.path.join(model_dir, 'serving',
                                        'telemetry.0.jsonl'))
  assert [r['wave'] for r in records if r['kind'] == 'serving_fleet_swap'
          ] == [[1, 2]]
  manager = checkpointing.CheckpointManager(model_dir)
  weights, states, actions, got = {}, {}, {}, {}
  for version in (first_step, 7):
    restored = manager.restore(step=version)
    weights[version] = (restored.avg_params, restored.model_state)
    sample = [(s, r) for s, r in results if r.version == version][:4]
    assert len(sample) == 4
    states[version] = [s for s, _ in sample]
    actions[version] = [r.outputs['action'] for _, r in sample]
    got[version] = np.asarray([float(r.outputs['q']) for _, r in sample])
  want = _jax_q(ref, weights, states, actions)
  for version in (first_step, 7):
    np.testing.assert_allclose(got[version], want[version], atol=1e-5)


TINY_SERVE = ['--device', 'cpu', '--init_randomly', '--num_convs', '1,1,1',
              '--max_batch_size', '2',
              '--max_wait_ms', '1', '--report_interval_s', '0.2',
              '--fleet_report_interval_s', '0.2'] + TINY_CEM


@pytest.mark.parametrize('fleet', [None, True],
                         ids=['one_server', 'fleet_of_one'])
def test_replicas_one_is_one_server_unless_a_fleet_is_asked(registry, tmp_path,
                                                            fleet):
  """``--replicas 1`` serves one ``PolicyServer`` without a router and its
  single ``telemetry.jsonl``, as the JAX package's ``t2r_serve`` does;
  ``start(fleet=True)`` puts the one replica behind the router, with the
  fleet-shaped dir."""
  from tensor2robot_tpu_torch.serving import serve

  serving = serve.start(serve.make_parser().parse_args(
      TINY_SERVE + ['--replicas', '1', '--model_dir', str(tmp_path)]),
                        fleet=fleet)
  try:
    state = serve.synthetic_state(serving.feature_spec,
                                  np.random.RandomState(0))
    result = serving.service.select_action(state, timeout_s=60)
    replicas = (serving.service.router.replica_ids() if serving.is_fleet
                else None)
  finally:
    serving.stop()
  assert np.isfinite(float(result.outputs['q']))
  assert result.outputs['action'].shape == (8,)
  names = set(os.listdir(tmp_path))
  if fleet:
    assert serving.is_fleet and replicas == [1] and result.replica == 1
    assert {'telemetry.0.jsonl', 'telemetry.1.jsonl'} <= names
    assert 'telemetry.jsonl' not in names
  else:
    assert not serving.is_fleet and isinstance(serving.service,
                                               PolicyServer)
    assert 'telemetry.jsonl' in names and 'telemetry.0.jsonl' not in names


def test_serve_main_runs_a_fleet_under_synthetic_load(registry, capsys):
  """``serve --replicas 2 --synthetic_load`` drives the fleet and prints
  one JSON line of its stats, every request answered."""
  from tensor2robot_tpu_torch.serving import serve

  assert serve.main(TINY_SERVE + ['--replicas', '2', '--synthetic_load',
                                  '3', '--duration', '0.5']) == 0
  stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert stats['failed'] == 0 and stats['completed'] > 0
  assert stats['device'] == 'cpu' and stats['p99_ms'] > 0
  assert stats['replica_count'] == 2 and stats['healthy_count'] == 2
  assert stats['requests_total'] == stats['completed']
  assert stats['retries_total'] == 0 and stats['scale_ups_total'] == 0


def test_fleet_bench_keys_are_jax_keys_and_all_printed(capsys):
  """``fleet_bench --device cpu`` at a tiny size prints one JSON line that
  holds every one of JAX's ``SERVING_FLEET_BENCH_KEYS``: no build at
  request time or in the scale-out, the swap failing nothing."""
  from tensor2robot_tpu_torch.serving import fleet_bench

  assert SERVING_FLEET_BENCH_KEYS == jax_fleet.SERVING_FLEET_BENCH_KEYS
  assert fleet_bench.main([
      '--device', 'cpu', '--batch', '2', '--height', '24', '--width', '32',
      '--cem_samples', '4', '--cem_iters', '1', '--num_elites', '2',
      '--duration', '0.4', '--replica_counts', '1,2,4']) == 0
  out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert set(SERVING_FLEET_BENCH_KEYS) <= set(out)
  assert out['serving_fleet_request_time_compiles'] == 0
  assert out['serving_fleet_scaleup_compiles'] == 0
  assert out['serving_fleet_swap_failed'] == 0
  assert out['serving_fleet_swap_versions_served'] == [1, 2]
  assert all(out['serving_fleet_actions_per_sec_r{}'.format(n)] > 0
             for n in (1, 2, 4))
