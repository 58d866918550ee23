"""ReplayService: sharded experience store with a batched sampling front end
(a copy of the JAX package's ``replay/service.py``).

Records arrive as per-example replay records (``replay/wire.py``), are
routed round-robin over N :class:`ShardStore` shards where they stay as
bytes, and leave as batches in the native loader's layout.

  * A corrupt append (it fails :class:`ReplayWireError` validation) is
    charged to the receiving shard's quarantine budget and never stored;
    blowing the per-shard or the global budget raises
    ``CorruptionBudgetExceeded`` naming the shard. The ``replay.append``
    fault site corrupts arriving records to drive this path.
  * Concurrent sample requests coalesce through the port's
    :class:`DeadlineBatcher` behind depth-based admission control
    (``replay/rejected``), the policy server's machinery.
  * Per-shard occupancy, append, sample and eviction counters live in the
    registry; a ``kind="replay"`` (``t2r.replay.v1``) record lands in
    ``telemetry.jsonl`` each report window.

Append and sample are numpy and threads: the service never touches a card.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.observability import TelemetryLogger, get_registry
from tensor2robot_tpu_torch.observability.spans import SPAN_BUCKETS_MS
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.reliability.quarantine import RecordQuarantine
from tensor2robot_tpu_torch.replay import wire
from tensor2robot_tpu_torch.replay.sampling import make_policy
from tensor2robot_tpu_torch.replay.store import ShardStore
from tensor2robot_tpu_torch.serving.batching import (
    AdmissionController,
    DeadlineBatcher,
)

__all__ = ['ReplayConfig', 'ReplayService', 'ReplayEmpty', 'SampleBatch',
           'REPLAY_RECORD_KIND', 'REPLAY_RECORD_SCHEMA',
           'REPLAY_REJECTED_COUNTER']

_LOGGER = logging.getLogger(__name__)

REPLAY_RECORD_KIND = 'replay'
REPLAY_RECORD_SCHEMA = 't2r.replay.v1'
REPLAY_REJECTED_COUNTER = 'replay/rejected'

REPLAY_APPENDS_COUNTER = 'replay/appends'
REPLAY_APPEND_BYTES_COUNTER = 'replay/append_bytes'
REPLAY_CORRUPT_COUNTER = 'replay/corrupt_appends'
REPLAY_SAMPLES_COUNTER = 'replay/samples'
REPLAY_SAMPLE_BATCHES_COUNTER = 'replay/sample_batches'
REPLAY_OCCUPANCY_EXAMPLES_GAUGE = 'replay/occupancy_examples'
REPLAY_OCCUPANCY_BYTES_GAUGE = 'replay/occupancy_bytes'
REPLAY_QUEUE_DEPTH_GAUGE = 'replay/sample_queue_depth'
REPLAY_SAMPLE_MS_HISTOGRAM = 'replay/sample_ms'



class ReplayEmpty(RuntimeError):
  """No resident examples anywhere; the learner should retry shortly."""


@dataclasses.dataclass
class ReplayConfig:
  """Knobs for one ReplayService.

  Attributes:
    num_shards: independent stores appends round-robin over; sampling
      draws from every shard proportionally to its occupancy.
    batch_size: default examples per sampled megabatch.
    retention: 'ring' (FIFO window) or 'reservoir' (uniform over the
      append stream) — replay/store.py.
    policy: 'uniform' or 'prioritized' — replay/sampling.py.
    priority_alpha: the prioritized policy's exponent.
    capacity_examples_per_shard / capacity_bytes_per_shard: per-shard
      bounds (whichever trips first evicts).
    coalesce_requests: how many concurrent sample REQUESTS one serve-
      loop pass may answer together (the DeadlineBatcher's batch size).
    max_wait_ms: deadline for an under-full request batch.
    max_queue_depth: admission bound on PENDING sample requests;
      arrivals beyond it are shed with RequestRejected.
    max_corrupt_appends / max_corrupt_appends_per_shard: quarantine
      budgets for appends failing wire validation.
    report_interval_s: cadence of ``kind="replay"`` telemetry records.
    seed: deterministic sampling/reservoir randomness (tests).
  """

  num_shards: int = 4
  batch_size: int = 32
  retention: str = 'ring'
  policy: str = 'uniform'
  priority_alpha: float = 0.6
  capacity_examples_per_shard: int = 4096
  capacity_bytes_per_shard: Optional[int] = None
  coalesce_requests: int = 8
  max_wait_ms: float = 5.0
  max_queue_depth: int = 64
  max_corrupt_appends: int = 100
  max_corrupt_appends_per_shard: int = 10
  report_interval_s: float = 10.0
  seed: Optional[int] = None


class SampleBatch(NamedTuple):
  """One assembled megabatch + the stable ids that produced it."""

  features: Dict[str, np.ndarray]
  labels: Dict[str, np.ndarray]
  record_ids: List[Tuple[int, int]]  # (shard, record_id) per row


def split_sides(flat: Dict[str, np.ndarray]
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
  """``{'features/x': a, 'labels/y': b}`` -> (features, labels) dicts."""
  features: Dict[str, np.ndarray] = {}
  labels: Dict[str, np.ndarray] = {}
  for key, value in flat.items():
    side, _, rest = key.partition('/')
    (features if side == 'features' else labels)[rest] = value
  return features, labels


class ReplayService:
  """Sharded packed-record store with a batched sampling front-end."""

  def __init__(self,
               config: Optional[ReplayConfig] = None,
               model_dir: Optional[str] = None,
               registry=None,
               telemetry: Optional[TelemetryLogger] = None,
               clock=time.monotonic):
    self.config = config or ReplayConfig()
    if self.config.num_shards < 1:
      raise ValueError('num_shards must be >= 1; got {}.'.format(
          self.config.num_shards))
    self._clock = clock
    self._registry = registry or get_registry()
    seed = self.config.seed
    self._rng = np.random.RandomState(seed)
    self._shards = [
        ShardStore(capacity_examples=self.config.capacity_examples_per_shard,
                   capacity_bytes=self.config.capacity_bytes_per_shard,
                   retention=self.config.retention,
                   seed=None if seed is None else seed + 1 + i)
        for i in range(self.config.num_shards)]
    self._policy = make_policy(self.config.policy,
                               alpha=self.config.priority_alpha)
    self._quarantine = RecordQuarantine(
        max_corrupt_records=self.config.max_corrupt_appends,
        max_corrupt_records_per_file=self.config.max_corrupt_appends_per_shard)
    self._append_lock = threading.Lock()
    self._append_cursor = 0

    self._owns_telemetry = telemetry is None and model_dir is not None
    self._telemetry = telemetry
    if self._owns_telemetry:
      self._telemetry = TelemetryLogger(model_dir)

    appends = self._registry.counter_family(REPLAY_APPENDS_COUNTER,
                                            ('shard',))
    samples = self._registry.counter_family(REPLAY_SAMPLES_COUNTER,
                                            ('shard',))
    self._append_counters = [appends.series(str(i))
                             for i in range(self.config.num_shards)]
    self._sample_counters = [samples.series(str(i))
                             for i in range(self.config.num_shards)]
    self._append_bytes = self._registry.counter(REPLAY_APPEND_BYTES_COUNTER)
    self._corrupt_counter = self._registry.counter(REPLAY_CORRUPT_COUNTER)
    self._batches_counter = self._registry.counter(
        REPLAY_SAMPLE_BATCHES_COUNTER)
    self._occupancy_gauge = self._registry.gauge(
        REPLAY_OCCUPANCY_EXAMPLES_GAUGE)
    self._bytes_gauge = self._registry.gauge(REPLAY_OCCUPANCY_BYTES_GAUGE)
    self._queue_gauge = self._registry.gauge(REPLAY_QUEUE_DEPTH_GAUGE)
    self._sample_ms = self._registry.histogram(REPLAY_SAMPLE_MS_HISTOGRAM,
                                               bounds=SPAN_BUCKETS_MS)

    self._batcher = DeadlineBatcher(self.config.coalesce_requests,
                                    self.config.max_wait_ms, clock=clock)
    self._admission = AdmissionController(
        self.config.max_queue_depth, registry=self._registry,
        counter_name=REPLAY_REJECTED_COUNTER)
    self._worker: Optional[threading.Thread] = None
    self._stop = False

    # Report-window state: per-shard counter snapshots, so window rates
    # are deltas even though the registry series stay cumulative.
    self._window_lock = threading.Lock()
    self._window_started = self._clock()
    self._last_shard_counters = [s.counters() for s in self._shards]
    self._last_corrupt = 0.0
    self._last_corrupt_by_shard = [0] * self.config.num_shards

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> 'ReplayService':
    """Starts the sample serve loop (needed for ``submit_sample`` /
    the HTTP frontend; direct ``sample()`` works without it)."""
    if self._worker is not None:
      raise RuntimeError('ReplayService already started.')
    if self._telemetry is not None:
      self._telemetry.log(
          'replay_start',
          config={'num_shards': self.config.num_shards,
                  'batch_size': self.config.batch_size,
                  'retention': self.config.retention,
                  'policy': self.config.policy,
                  'capacity_examples_per_shard':
                      self.config.capacity_examples_per_shard})
    self._worker = threading.Thread(target=self._serve_loop,
                                    name='t2r-replay-service', daemon=True)
    self._worker.start()
    return self

  def __enter__(self) -> 'ReplayService':
    return self.start()

  def __exit__(self, *exc_info) -> None:
    self.close()

  def close(self) -> None:
    if self._worker is None:
      if self._owns_telemetry and self._telemetry is not None:
        self._telemetry.close()
      return
    self._stop = True
    self._batcher.close()
    self._worker.join()
    self._worker = None
    self._report(force=True)
    if self._telemetry is not None:
      self._telemetry.log('replay_stop',
                          occupancy_examples=self.occupancy_examples,
                          rejected_total=self._admission.rejected_total)
      self._telemetry.flush()
      if self._owns_telemetry:
        self._telemetry.close()
    self._queue_gauge.set(0.0)

  # -- append path -----------------------------------------------------------

  def append(self, blob: bytes, priority: float = 1.0,
             shard: Optional[int] = None) -> int:
    """Validates + stores one packed record; returns the shard index.

    Corrupt records (wire validation failure) are charged to the
    receiving shard's quarantine budget and re-raised as
    :class:`~tensor2robot_tpu_torch.replay.wire.ReplayWireError`; the record
    is NEVER stored, so sampling stays clean; exhausting a budget
    raises ``CorruptionBudgetExceeded`` naming the shard. The
    ``replay.append`` FaultInjector site deterministically corrupts the
    arriving record (truncation) to drive this path.
    """
    if fault_injection.fires(fault_injection.SITE_REPLAY_APPEND):
      blob = blob[:max(1, len(blob) // 2)]  # injected wire corruption
    if shard is None:
      with self._append_lock:
        shard = self._append_cursor % len(self._shards)
        self._append_cursor += 1
    else:
      shard = int(shard) % len(self._shards)
    try:
      wire.decode_example(blob)
    except wire.ReplayWireError as e:
      self._corrupt_counter.inc()
      # record_index=None: every corrupt arrival counts (there is no
      # multi-epoch re-read of a network append to dedupe).
      self._quarantine.record_skipped('shard{}'.format(shard),
                                      reason=str(e))
      raise
    self._shards[shard].append(blob, priority=priority)
    self._append_counters[shard].inc()
    self._append_bytes.inc(len(blob))
    # Occupancy gauges refresh at the report window, NOT here: a
    # per-append refresh would take every shard's lock twice per call
    # and serialize the per-shard-lock concurrency N writers rely on.
    return shard

  def _update_occupancy_gauges(self) -> None:
    self._occupancy_gauge.set(float(self.occupancy_examples))
    self._bytes_gauge.set(float(self.occupancy_bytes))

  # -- sample path -----------------------------------------------------------

  def sample(self, batch_size: Optional[int] = None) -> SampleBatch:
    """Draws and assembles one megabatch across shards.

    Raises :class:`ReplayEmpty` when nothing is resident anywhere. The
    ``replay.sample`` FaultInjector site stalls here.
    """
    stall_s = fault_injection.replay_sample_stall_seconds()
    if stall_s > 0.0:
      time.sleep(stall_s)
    batch_size = int(batch_size or self.config.batch_size)
    t0 = time.perf_counter()
    rows: List[Dict[str, np.ndarray]] = []
    record_ids: List[Tuple[int, int]] = []
    # Redraw loop: a draw is computed against an occupancy snapshot,
    # and concurrent byte-bounded appends can evict records between the
    # snapshot and the fetch (get_many skips dead slots). Each pass
    # re-reads occupancy and draws only the shortfall; a bounded number
    # of passes turns a pathological drain into a clean ReplayEmpty
    # instead of an infinite loop.
    for _ in range(8):
      if len(rows) >= batch_size:
        break
      need = batch_size - len(rows)
      occupancies = np.asarray(
          [shard.occupancy_examples for shard in self._shards],
          np.float64)
      total = float(occupancies.sum())
      if total <= 0.0:
        raise ReplayEmpty(
            'replay store is empty; retry after appends land')
      counts = self._rng.multinomial(need, occupancies / total)
      for shard_index, count in enumerate(counts):
        if count <= 0:
          continue
        store = self._shards[shard_index]
        # Draw against an atomic (ids, priorities) snapshot, fetch by
        # STABLE id: a ring slide between the two steps skips the dead
        # ids (redrawn next pass) instead of silently resolving a slot
        # to its neighbor — a shifted-slot fetch would bias prioritized
        # sampling in proportion to the append rate.
        ids_snapshot, priorities = store.snapshot()
        slots = self._policy.draw(priorities, int(count), self._rng)
        drawn = [ids_snapshot[slot] for slot in slots
                 if 0 <= slot < len(ids_snapshot)]
        blobs, ids = store.get_by_ids(drawn)
        self._sample_counters[shard_index].inc(len(blobs))
        for blob, record_id in zip(blobs, ids):
          rows.append(wire.decode_example(blob))
          record_ids.append((shard_index, record_id))
    if len(rows) < batch_size:
      raise ReplayEmpty('replay store drained mid-sample')
    flat = wire.assemble_batch(rows)
    features, labels = split_sides(flat)
    self._batches_counter.inc()
    self._sample_ms.record((time.perf_counter() - t0) * 1e3)
    return SampleBatch(features=features, labels=labels,
                       record_ids=record_ids)

  def update_priorities(self, record_ids: Sequence[Tuple[int, int]],
                        priorities: Sequence[float]) -> int:
    """Routes learner priority updates back to their shards by stable
    id; evicted ids are skipped. Returns how many landed."""
    by_shard: Dict[int, Tuple[List[int], List[float]]] = {}
    for (shard, record_id), priority in zip(record_ids, priorities):
      ids, values = by_shard.setdefault(int(shard), ([], []))
      ids.append(int(record_id))
      values.append(float(priority))
    landed = 0
    for shard, (ids, values) in by_shard.items():
      landed += self._shards[shard].update_priorities(ids, values)
    return landed

  # -- batched sample front-end ----------------------------------------------

  def submit_sample(self, batch_size: Optional[int] = None):
    """Enqueues one sample request; returns a Future[SampleBatch].

    Requires :meth:`start`. The depth check and the enqueue are one step
    under the batcher's lock, as in the policy server; saturation raises
    RequestRejected.
    """
    if self._worker is None:
      raise RuntimeError('ReplayService.start() the serve loop before '
                         'submit_sample().')
    request = self._batcher.submit(
        {'batch_size': int(batch_size or self.config.batch_size)},
        admission=self._admission)
    self._queue_gauge.set(float(self._batcher.pending_count()))
    return request.future

  def _serve_loop(self) -> None:
    while True:
      batch = self._batcher.next_batch(timeout=0.05)
      if batch is None:
        if self._stop:
          break  # closed AND drained
      else:
        for request in batch:
          try:
            result = self.sample(request.features.get('batch_size'))
          except Exception as e:  # noqa: BLE001 - answer THIS caller and
            # keep serving: a dead serve loop hangs every future caller.
            self._answer(request, error=e)
          else:
            self._answer(request, result=result)
        self._queue_gauge.set(float(self._batcher.pending_count()))
      try:
        self._maybe_report()
      except Exception as e:  # noqa: BLE001 — telemetry I/O must degrade
        _LOGGER.warning('ReplayService report failed (kept serving): %s', e)

  def _answer(self, request, result=None, error=None) -> None:
    try:
      if error is not None:
        request.future.set_exception(error)
      else:
        request.future.set_result(result)
    except Exception:  # noqa: BLE001 — InvalidStateError on cancel
      pass

  # -- telemetry -------------------------------------------------------------

  def shard_occupancy(self, shard: int) -> int:
    """ONE shard's resident examples (one lock, append-path cheap)."""
    return self._shards[int(shard) % len(self._shards)].occupancy_examples

  @property
  def occupancy_examples(self) -> int:
    return sum(shard.occupancy_examples for shard in self._shards)

  @property
  def occupancy_bytes(self) -> int:
    return sum(shard.occupancy_bytes for shard in self._shards)

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
      current = [shard.counters() for shard in self._shards]
      previous = self._last_shard_counters
      self._last_shard_counters = current
      corrupt_total = self._corrupt_counter.value
      corrupt_delta = corrupt_total - self._last_corrupt
      self._last_corrupt = corrupt_total
      # Per-shard corrupt counts are WINDOW DELTAS like their sibling
      # fields: a writer fixed days ago must stop tripping the
      # doctor's present-tense 'shipping damaged records' warning.
      corrupt_by_shard = [
          self._quarantine.skipped_in_file('shard{}'.format(i))
          for i in range(self.config.num_shards)]
      corrupt_shard_delta = [cur - prev for cur, prev in zip(
          corrupt_by_shard, self._last_corrupt_by_shard)]
      self._last_corrupt_by_shard = corrupt_by_shard
      self._window_started = now
    shards: Dict[str, Dict[str, float]] = {}
    appends = samples = evictions = 0
    for index, (cur, prev) in enumerate(zip(current, previous)):
      delta = {key: cur[key] - prev[key]
               for key in ('appends', 'samples', 'evictions')}
      appends += delta['appends']
      samples += delta['samples']
      evictions += delta['evictions']
      shards[str(index)] = {
          'occupancy_examples': cur['occupancy_examples'],
          'occupancy_bytes': cur['occupancy_bytes'],
          'appends': delta['appends'],
          'samples': delta['samples'],
          'evictions': delta['evictions'],
          'corrupt': corrupt_shard_delta[index],
      }
    occupancy = self.occupancy_examples
    occupancy_bytes = self.occupancy_bytes
    self._update_occupancy_gauges()
    record = {
        'schema': REPLAY_RECORD_SCHEMA,
        'window_seconds': round(window_s, 3),
        'appends': int(appends),
        'appends_per_sec': round(appends / window_s, 2) if window_s > 0
                           else 0.0,
        'samples': int(samples),
        'samples_per_sec': round(samples / window_s, 2) if window_s > 0
                           else 0.0,
        'evictions': int(evictions),
        'corrupt': int(corrupt_delta),
        'occupancy_examples': int(occupancy),
        'occupancy_bytes': int(occupancy_bytes),
        'bytes_per_example': round(occupancy_bytes / occupancy, 1)
                             if occupancy else 0.0,
        'sample_queue_depth': self._batcher.pending_count(),
        'rejected_total': self._admission.rejected_total,
        'shards': shards,
    }
    if self._telemetry is not None:
      self._telemetry.log(REPLAY_RECORD_KIND, **record)
      self._telemetry.heartbeat()
      self._telemetry.flush()

  # -- introspection ---------------------------------------------------------

  def stats(self) -> Dict[str, Any]:
    """Cumulative service stats (the HTTP door's /healthz)."""
    shards = {str(i): shard.counters()
              for i, shard in enumerate(self._shards)}
    for index, entry in shards.items():
      entry['corrupt'] = self._quarantine.skipped_in_file(
          'shard{}'.format(index))
    return {
        'occupancy_examples': self.occupancy_examples,
        'occupancy_bytes': self.occupancy_bytes,
        'corrupt_appends_total': self._corrupt_counter.value,
        'rejected_total': self._admission.rejected_total,
        'sample_queue_depth': self._batcher.pending_count(),
        'retention': self.config.retention,
        'policy': self.config.policy,
        'num_shards': self.config.num_shards,
        'shards': shards,
    }
