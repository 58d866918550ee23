"""PolicyServer: batched, SLO-tracked policy inference.

A copy of the JAX package's ``serving/server.py`` with the same contract:
concurrent ``SelectAction`` requests are admitted (or shed), coalesced into
padded batches by a deadline-aware batcher, run through ONE batch function
``batch_fn(variables, features, seed)`` over an atomically swapped,
versioned parameter snapshot, and answered with per-request latency
accounting against an explicit SLO.

  * Versioned params, drain-free hot swap: ``swap_params`` replaces one
    immutable ``(version, variables)`` reference; a batch reads it ONCE,
    so every response is labeled with the version that produced it.
  * SLOs are measured, not asserted: per-request and per-batch latency
    land in the ``inference/latency_ms`` histogram family (series
    ``serving_request`` / ``serving_batch``) on SLO-resolution edges;
    ``serving/{queue_depth,batch_size,padding_waste,rejected}`` cover the
    queueing; a ``kind="serving"`` record in ``telemetry.jsonl`` carries
    the windowed p50/p95/p99 against ``slo_ms`` each report interval.

The batch function may return torch tensors on any device; the server
copies them to host numpy arrays before it answers.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    SLO_LATENCY_BUCKETS_MS,
    Histogram,
    TelemetryLogger,
    get_registry,
)
from tensor2robot_tpu_torch.serving.batching import (
    AdmissionController,
    DeadlineBatcher,
    pad_batch,
    split_outputs,
)

_LOG = logging.getLogger(__name__)

__all__ = ['PolicyServer', 'ServeResult', 'ServingConfig',
           'SERVING_RECORD_KIND', 'SERVING_QUEUE_DEPTH_GAUGE',
           'SERVING_BATCH_SIZE_HISTOGRAM', 'SERVING_PADDING_WASTE_COUNTER',
           'SERVING_REQUESTS_COUNTER', 'SERVING_BATCHES_COUNTER',
           'SERVING_ERRORS_COUNTER', 'SERVING_SWAPS_COUNTER',
           'SERVING_VERSION_GAUGE', 'REQUEST_LATENCY_SERIES',
           'BATCH_LATENCY_SERIES']

# The JAX package's predictors report into the same family; serving is
# one more labeled series of it.
INFERENCE_LATENCY_HISTOGRAM = 'inference/latency_ms'
REQUEST_LATENCY_SERIES = 'serving_request'
BATCH_LATENCY_SERIES = 'serving_batch'

SERVING_RECORD_KIND = 'serving'
SERVING_QUEUE_DEPTH_GAUGE = 'serving/queue_depth'
SERVING_BATCH_SIZE_HISTOGRAM = 'serving/batch_size'
SERVING_PADDING_WASTE_COUNTER = 'serving/padding_waste'
SERVING_REQUESTS_COUNTER = 'serving/requests'
SERVING_BATCHES_COUNTER = 'serving/batches'
SERVING_ERRORS_COUNTER = 'serving/errors'
SERVING_SWAPS_COUNTER = 'serving/swaps'
SERVING_VERSION_GAUGE = 'serving/params_version'


@dataclasses.dataclass
class ServingConfig:
  """Knobs for one PolicyServer.

  Attributes:
    max_batch_size: the ONE padded batch shape the executable serves; a
      full batch dispatches immediately.
    max_wait_ms: deadline for under-full batches — the batching latency
      tax a trickle request can pay, ever.
    max_queue_depth: admission-control bound on PENDING requests;
      arrivals beyond it are shed with :class:`RequestRejected`.
    slo_ms: the per-request latency objective (33 ms = the 30 Hz robot
      control envelope); reported against, never enforced by dropping.
    report_interval_s: cadence of ``kind="serving"`` telemetry records.
  """

  max_batch_size: int = 8
  max_wait_ms: float = 5.0
  max_queue_depth: int = 64
  slo_ms: float = 33.0
  report_interval_s: float = 10.0


class ServeResult(NamedTuple):
  """One fulfilled request: outputs + the params version that produced
  them + the request's measured queue-to-response latency."""

  outputs: Dict[str, np.ndarray]
  version: int
  latency_ms: float


class _VersionedParams(NamedTuple):
  """The atomically-swapped snapshot (one reference; never mutated)."""

  version: int
  variables: Any


def _to_numpy(outputs) -> Dict[str, np.ndarray]:
  """Device outputs -> host arrays (the copy waits for the device)."""
  return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in dict(outputs).items()}


class PolicyServer:
  """Batches concurrent action requests through one batch function.

  Args:
    batch_fn: ``(variables, batched_features, seed) -> outputs dict``;
      every array in ``batched_features`` has leading dim
      ``max_batch_size`` and ``seed`` is a ``np.uint32`` scalar (seed the
      program's generator with it).
    variables: the initial parameter pytree; ``version`` labels it.
    config: :class:`ServingConfig`.
    model_dir: when set, a ``TelemetryLogger`` writes ``serving_start`` /
      ``serving`` / ``serving_swap`` / ``serving_stop`` records (and
      heartbeats) under it for the doctor; None = metrics-registry only.
    feature_spec: optional ``{name: (shape, dtype)}`` per-request
      contract; submissions are validated and cast against it so a
      malformed request fails ITS caller, never the batch it would have
      ridden in.
    aot_info: provenance dict published in the ``serving_start`` record.
  """

  def __init__(self,
               batch_fn: Callable[..., Dict[str, np.ndarray]],
               variables: Any,
               config: Optional[ServingConfig] = None,
               version: int = 0,
               model_dir: Optional[str] = None,
               feature_spec: Optional[Dict[str, Tuple]] = None,
               aot_info: Optional[Dict[str, Any]] = None,
               registry=None,
               telemetry: Optional[TelemetryLogger] = None,
               clock: Callable[[], float] = time.monotonic):
    self.config = config or ServingConfig()
    self._batch_fn = batch_fn
    self._params = _VersionedParams(version=int(version),
                                    variables=variables)
    self._feature_spec = feature_spec
    self._aot_info = dict(aot_info or {})
    self._clock = clock
    self._registry = registry or get_registry()
    self._batcher = DeadlineBatcher(self.config.max_batch_size,
                                    self.config.max_wait_ms, clock=clock)
    self._admission = AdmissionController(self.config.max_queue_depth,
                                          registry=self._registry)
    self._owns_telemetry = telemetry is None and model_dir is not None
    self._telemetry = telemetry
    if self._owns_telemetry:
      self._telemetry = TelemetryLogger(model_dir)

    # Family default = the predictors' default edges, so whichever of
    # predictor/server registers the family first, the config agrees;
    # the serving series override their own edges to SLO resolution.
    latency_family = self._registry.histogram_family(
        INFERENCE_LATENCY_HISTOGRAM, ('predictor',),
        bounds=DEFAULT_LATENCY_BUCKETS_MS)
    self._request_latency = latency_family.series(
        REQUEST_LATENCY_SERIES, bounds=SLO_LATENCY_BUCKETS_MS)
    self._batch_latency = latency_family.series(
        BATCH_LATENCY_SERIES, bounds=SLO_LATENCY_BUCKETS_MS)
    # Fixed 1..256 integer edges (NOT derived from max_batch_size: two
    # servers with different batch shapes share one registry name, and
    # re-registering a histogram with different bounds is an error).
    self._batch_size_hist = self._registry.histogram(
        SERVING_BATCH_SIZE_HISTOGRAM,
        bounds=tuple(float(i) for i in range(1, 257)))
    self._queue_gauge = self._registry.gauge(SERVING_QUEUE_DEPTH_GAUGE)
    self._padding_counter = self._registry.counter(
        SERVING_PADDING_WASTE_COUNTER)
    self._requests_counter = self._registry.counter(
        SERVING_REQUESTS_COUNTER)
    self._batches_counter = self._registry.counter(SERVING_BATCHES_COUNTER)
    self._errors_counter = self._registry.counter(SERVING_ERRORS_COUNTER)
    self._swaps_counter = self._registry.counter(SERVING_SWAPS_COUNTER)
    self._version_gauge = self._registry.gauge(SERVING_VERSION_GAUGE)
    self._version_gauge.set(float(version))

    # Windowed SLO view: reset each report interval; the registry series
    # above stays cumulative for TensorBoard.
    self._window_hist = Histogram(SLO_LATENCY_BUCKETS_MS)
    self._window_lock = threading.Lock()
    self._window_started = self._clock()
    self._window_batches = 0
    self._window_rows = 0
    self._window_padded = 0

    # Drain accounting: a request is "accepted" at submit and "answered"
    # when its future resolves — so drain() can never observe the gap
    # between a batch leaving the queue and entering execution.
    self._count_lock = threading.Lock()
    self._accepted = 0
    self._answered = 0
    self._batch_index = 0
    self._stop = False
    self._worker: Optional[threading.Thread] = None

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> 'PolicyServer':
    if self._worker is not None:
      raise RuntimeError('PolicyServer already started.')
    if self._telemetry is not None:
      self._telemetry.log(
          'serving_start',
          config={'max_batch_size': self.config.max_batch_size,
                  'max_wait_ms': self.config.max_wait_ms,
                  'max_queue_depth': self.config.max_queue_depth,
                  'slo_ms': self.config.slo_ms},
          params_version=self._params.version, **self._aot_info)
    self._worker = threading.Thread(target=self._serve_loop,
                                    name='t2r-policy-server', daemon=True)
    self._worker.start()
    return self

  def __enter__(self) -> 'PolicyServer':
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.close()

  def close(self) -> None:
    """Drains pending requests (they are answered, not dropped), stops
    the serve loop, emits the final report + ``serving_stop``."""
    if self._worker is None:
      return
    self._stop = True
    self._batcher.close()
    self._worker.join()
    self._worker = None
    self._report(force=True)
    if self._telemetry is not None:
      self._telemetry.log('serving_stop',
                          params_version=self._params.version,
                          rejected_total=self._admission.rejected_total)
      self._telemetry.flush()
      if self._owns_telemetry:
        self._telemetry.close()
    self._queue_gauge.set(0.0)

  def drain(self, timeout_s: float = 30.0) -> bool:
    """Blocks until every accepted request has been ANSWERED (True), or
    the timeout passes (False). Shutdown helper — hot swaps do NOT
    drain. Counted from submit to future resolution, so a batch between
    queue and execution still counts as outstanding."""
    deadline = self._clock() + timeout_s
    while self._clock() < deadline:
      with self._count_lock:
        outstanding = self._accepted - self._answered
      if outstanding == 0:
        return True
      time.sleep(0.002)
    return False

  # -- request path ----------------------------------------------------------

  def submit(self, features: Dict[str, np.ndarray]) -> Future:
    """Enqueues one single-state request; returns the Future resolving
    to a :class:`ServeResult`. Raises :class:`RequestRejected` when the
    queue is saturated and ValueError on a spec-violating request."""
    features = self._coerce(features)
    # Depth check and enqueue are one atomic step under the batcher's
    # lock: concurrent submitters cannot all pass the check and
    # overshoot max_queue_depth.
    request = self._batcher.submit(features, admission=self._admission)
    with self._count_lock:
      self._accepted += 1
    self._queue_gauge.set(float(self._batcher.pending_count()))
    return request.future

  def select_action(self, features: Dict[str, np.ndarray],
                    timeout_s: Optional[float] = None) -> ServeResult:
    """Blocking convenience wrapper over :meth:`submit`."""
    return self.submit(features).result(timeout=timeout_s)

  def _coerce(self, features: Dict[str, np.ndarray]
              ) -> Dict[str, np.ndarray]:
    if self._feature_spec is None:
      return dict(features)
    spec_names = set(self._feature_spec)
    got_names = set(features)
    if spec_names != got_names:
      raise ValueError(
          'Request features {} do not match the serving spec {}.'.format(
              sorted(got_names), sorted(spec_names)))
    out: Dict[str, np.ndarray] = {}
    for name, (shape, dtype) in self._feature_spec.items():
      value = np.asarray(features[name], dtype=dtype)
      if tuple(value.shape) != tuple(shape):
        raise ValueError(
            'Feature {!r} has shape {}; the serving spec requires '
            '{} (per request, no batch dim).'.format(
                name, value.shape, tuple(shape)))
      out[name] = value
    return out

  # -- hot swap --------------------------------------------------------------

  @property
  def params_version(self) -> int:
    return self._params.version

  def swap_params(self, variables: Any, version: int) -> None:
    """Replaces the serving weights with zero dropped requests.

    One reference assignment: batches formed after this line read the
    new snapshot; a batch already executing keeps the old one until its
    futures are set (versioned-params contract — the response's
    ``version`` field always names the weights that scored it).
    """
    previous = self._params.version
    self._params = _VersionedParams(version=int(version),
                                    variables=variables)
    self._swaps_counter.inc()
    self._version_gauge.set(float(version))
    if self._telemetry is not None:
      self._telemetry.log('serving_swap', version=int(version),
                          previous_version=previous)

  # -- serve loop ------------------------------------------------------------

  def _serve_loop(self) -> None:
    while True:
      batch = self._batcher.next_batch(timeout=0.05)
      if batch is None:
        if self._stop:
          break  # closed AND drained (next_batch drains before None)
      else:
        try:
          self._run_batch(batch)
        except Exception as e:  # noqa: BLE001 — the loop must outlive
          # anything: a dead serve thread hangs EVERY future caller.
          # (_run_batch already answers the batch's futures for device
          # failures; this guards the accounting/future plumbing itself.)
          _LOG.exception('PolicyServer serve loop error (kept serving): %s',
                         e)
      try:
        self._maybe_report()
      except Exception as e:  # noqa: BLE001 — telemetry I/O (full disk,
        # yanked model_dir) must degrade to a warning, not kill serving.
        _LOG.warning('PolicyServer report failed (kept serving): %s', e)

  def _run_batch(self, batch) -> None:
    try:
      params = self._params  # ONE snapshot read for the whole batch
      start = self._clock()
      try:
        stacked, n_real = pad_batch([r.features for r in batch],
                                    self.config.max_batch_size)
        seed = np.uint32(self._batch_index & 0xFFFFFFFF)
        self._batch_index += 1
        outputs = _to_numpy(
            self._batch_fn(params.variables, stacked, seed))
        rows = split_outputs(outputs, n_real)
      except Exception as e:  # noqa: BLE001 — answer the callers, keep serving
        self._errors_counter.inc(len(batch))
        _LOG.exception('PolicyServer batch failed (%d requests): %s',
                       len(batch), e)
        for request in batch:
          self._answer(request, error=e)
        return
      end = self._clock()
      batch_ms = (end - start) * 1e3
      self._batch_latency.record(batch_ms)
      self._batch_size_hist.record(float(n_real))
      self._padding_counter.inc(self.config.max_batch_size - n_real)
      self._requests_counter.inc(n_real)
      self._batches_counter.inc()
      with self._window_lock:
        self._window_batches += 1
        self._window_rows += n_real
        self._window_padded += self.config.max_batch_size - n_real
      for request, row in zip(batch, rows):
        latency_ms = (end - request.enqueued_at) * 1e3
        self._request_latency.record(latency_ms)
        with self._window_lock:
          self._window_hist.record(latency_ms)
        self._answer(request,
                     result=ServeResult(outputs=row, version=params.version,
                                        latency_ms=latency_ms))
    finally:
      self._queue_gauge.set(float(self._batcher.pending_count()))

  def _answer(self, request, result=None, error=None) -> None:
    """Resolves one future, tolerating a caller who cancelled it (their
    batch slot was already spent; the loop must not die over it).
    Every accepted request passes through here exactly once — the
    'answered' side of drain()'s accounting."""
    try:
      if error is not None:
        request.future.set_exception(error)
      else:
        request.future.set_result(result)
    except Exception:  # noqa: BLE001 — InvalidStateError on cancel
      pass
    finally:
      with self._count_lock:
        self._answered += 1

  # -- SLO reporting ---------------------------------------------------------

  def _maybe_report(self) -> None:
    if self._clock() - self._window_started >= \
        self.config.report_interval_s:
      self._report()

  def _report(self, force: bool = False) -> None:
    now = self._clock()
    window_s = now - self._window_started
    if window_s <= 0 and not force:
      return
    with self._window_lock:
      summary = self._window_hist.summary()
      self._window_hist.reset()
      batches = self._window_batches
      rows = self._window_rows
      padded = self._window_padded
      self._window_batches = self._window_rows = self._window_padded = 0
      self._window_started = now
    count = int(summary.get('count', 0))
    p99 = summary.get('p99', 0.0)
    record = {
        'window_seconds': round(window_s, 3),
        'requests': count,
        'requests_per_sec': round(count / window_s, 2) if window_s > 0
                            else 0.0,
        'p50_ms': round(summary.get('p50', 0.0), 3),
        'p95_ms': round(summary.get('p95', 0.0), 3),
        'p99_ms': round(p99, 3),
        'slo_ms': self.config.slo_ms,
        'over_slo': bool(count > 0 and p99 > self.config.slo_ms),
        'queue_depth': self._batcher.pending_count(),
        'batch_fill': round(rows / (batches * self.config.max_batch_size),
                            4) if batches else 0.0,
        'padding_waste': padded,
        'rejected_total': self._admission.rejected_total,
        'params_version': self._params.version,
    }
    if self._telemetry is not None:
      self._telemetry.log(SERVING_RECORD_KIND, **record)
      self._telemetry.heartbeat()
      self._telemetry.flush()

  # -- introspection ---------------------------------------------------------

  def stats(self) -> Dict[str, object]:
    """Cumulative serving stats (frontend /healthz + bench)."""
    return {
        'requests_total': self._requests_counter.value,
        'batches_total': self._batches_counter.value,
        'rejected_total': self._admission.rejected_total,
        'errors_total': self._errors_counter.value,
        'padding_waste_total': self._padding_counter.value,
        'swaps_total': self._swaps_counter.value,
        'queue_depth': self._batcher.pending_count(),
        'max_queue_depth': self.config.max_queue_depth,
        'params_version': self._params.version,
        'latency_ms': self._request_latency.summary(),
        'batch_size': self._batch_size_hist.summary(),
        'slo_ms': self.config.slo_ms,
    }
