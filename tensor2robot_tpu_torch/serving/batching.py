"""Deadline batching + admission control for the policy server.

A copy of the JAX package's ``serving/batching.py``:

  * ``DeadlineBatcher``: concurrent requests enqueue into one
    monitor-protected queue; the serve loop pops batches. A full batch
    (``max_batch_size`` pending) dispatches at once; an under-full batch
    dispatches as soon as its oldest request has waited ``max_wait_ms``.
  * ``AdmissionController``: depth-based load shedding. Requests are
    rejected with :class:`RequestRejected` while the pending queue sits at
    ``max_queue_depth``, and each shed request is counted
    (``serving/rejected``).
  * ``pad_batch`` / ``split_outputs``: the batch program serves ONE batch
    shape, so an under-full batch is padded by replicating its last real
    row, and the responses are sliced back to the real rows, so that a
    padded row never reaches a response.

All waits use ``time.monotonic`` (the clock is injectable for tests).
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.observability import get_registry

__all__ = ['AdmissionController', 'DeadlineBatcher', 'PendingRequest',
           'RequestRejected', 'SERVING_REJECTED_COUNTER', 'pad_batch',
           'split_outputs']

SERVING_REJECTED_COUNTER = 'serving/rejected'


class PendingRequest:
  """One enqueued request: features + the future its caller waits on."""

  __slots__ = ('request_id', 'features', 'future', 'enqueued_at')

  def __init__(self, request_id: int, features: Dict[str, np.ndarray],
               enqueued_at: float):
    self.request_id = request_id
    self.features = features
    self.future: Future = Future()
    self.enqueued_at = enqueued_at


class RequestRejected(RuntimeError):
  """The server is saturated; the caller should back off / retry
  elsewhere. Maps to HTTP 503 in the frontends."""


class AdmissionController:
  """Depth-based load shedding with rejection accounting.

  A service SLO is a promise about the requests you ACCEPT. Once the
  pending queue saturates, every additional admitted request makes every
  queued request later — the p99 collapses for all callers instead of a
  few callers getting a fast, explicit rejection they can retry against
  another replica. ``counter_name`` routes the shed count to the owning
  service's namespace so capacity planning sees exactly how much demand
  each service turned away.
  """

  def __init__(self, max_queue_depth: int, registry=None,
               counter_name: str = SERVING_REJECTED_COUNTER):
    if max_queue_depth < 1:
      raise ValueError('max_queue_depth must be >= 1; got {}.'.format(
          max_queue_depth))
    self.max_queue_depth = int(max_queue_depth)
    registry = registry or get_registry()
    self._rejected = registry.counter(counter_name)

  def admit(self, queue_depth: int) -> None:
    """Raises RequestRejected (and counts it) when the queue is full."""
    if queue_depth >= self.max_queue_depth:
      self._rejected.inc()
      raise RequestRejected(
          'queue saturated ({} pending >= max_queue_depth {}); '
          'request shed'.format(queue_depth, self.max_queue_depth))

  @property
  def rejected_total(self) -> float:
    return self._rejected.value


class DeadlineBatcher:
  """Coalesces requests into dispatchable batches.

  Contract (tests/test_serving.py):
    * burst: with >= ``max_batch_size`` requests pending, ``next_batch``
      returns exactly ``max_batch_size`` of them with NO deadline wait
      (oldest first — FIFO fairness);
    * trickle: an under-full batch is returned once its OLDEST request
      has aged ``max_wait_ms``, never later (modulo scheduler jitter);
    * close(): wakes every waiter; remaining requests drain as final
      (possibly under-full, immediate) batches, then ``next_batch``
      returns None forever — zero requests dropped on shutdown.
  """

  def __init__(self, max_batch_size: int, max_wait_ms: float,
               clock: Callable[[], float] = time.monotonic):
    if max_batch_size < 1:
      raise ValueError('max_batch_size must be >= 1; got {}.'.format(
          max_batch_size))
    if max_wait_ms < 0:
      raise ValueError('max_wait_ms must be >= 0; got {}.'.format(
          max_wait_ms))
    self.max_batch_size = int(max_batch_size)
    self.max_wait_s = float(max_wait_ms) / 1e3
    self._clock = clock
    self._cond = threading.Condition()
    self._queue: List[PendingRequest] = []
    self._closed = False
    self._ids = itertools.count()

  def submit(self, features: Dict[str, np.ndarray],
             admission: Optional[AdmissionController] = None
             ) -> PendingRequest:
    """Enqueues one request; returns it (caller waits on ``.future``).

    ``admission`` is consulted UNDER the queue lock, so the depth check
    and the enqueue are one atomic step — N concurrent submitters at
    depth ``max - 1`` admit exactly one request, not N (TOCTOU-free
    load shedding).
    """
    request = PendingRequest(next(self._ids), features, self._clock())
    with self._cond:
      if self._closed:
        raise RuntimeError('DeadlineBatcher is closed.')
      if admission is not None:
        admission.admit(len(self._queue))  # raises RequestRejected
      self._queue.append(request)
      self._cond.notify_all()
    return request

  def pending_count(self) -> int:
    with self._cond:
      return len(self._queue)

  def next_batch(self, timeout: Optional[float] = None
                 ) -> Optional[List[PendingRequest]]:
    """Blocks until a batch is due (see class contract); returns it.

    Returns None when ``timeout`` seconds pass with nothing due, or —
    terminally — when the batcher is closed and drained.
    """
    deadline = None if timeout is None else self._clock() + timeout
    with self._cond:
      while True:
        if self._queue:
          if len(self._queue) >= self.max_batch_size or self._closed:
            return self._pop_locked()
          wait_left = (self._queue[0].enqueued_at + self.max_wait_s
                       - self._clock())
          if wait_left <= 0:
            return self._pop_locked()
        elif self._closed:
          return None
        else:
          wait_left = None
        if deadline is not None:
          budget = deadline - self._clock()
          if budget <= 0:
            return None
          wait_left = budget if wait_left is None else min(wait_left,
                                                           budget)
        self._cond.wait(wait_left)

  def _pop_locked(self) -> List[PendingRequest]:
    batch = self._queue[:self.max_batch_size]
    del self._queue[:self.max_batch_size]
    self._cond.notify_all()  # a second consumer may have a batch due too
    return batch

  def close(self) -> None:
    with self._cond:
      self._closed = True
      self._cond.notify_all()


def pad_batch(features_list: Sequence[Dict[str, np.ndarray]],
              pad_to: int) -> Tuple[Dict[str, np.ndarray], int]:
  """Stacks per-request feature dicts and pads to a fixed batch size.

  Each request carries ONE state: every feature array is per-request
  (no leading batch dim; scalars allowed). Returns ``(batched, n_real)``
  where every array in ``batched`` has leading dim ``pad_to`` and rows
  ``[n_real:]`` replicate row ``n_real - 1``.

  Raises ValueError on an empty list, on more requests than ``pad_to``,
  and on requests whose feature names disagree — a shape-stable
  executable needs one fixed feature set.
  """
  if not features_list:
    raise ValueError('pad_batch needs at least one request.')
  n_real = len(features_list)
  if n_real > pad_to:
    raise ValueError('Got {} requests for a batch padded to {}.'.format(
        n_real, pad_to))
  names = sorted(features_list[0])
  for features in features_list[1:]:
    if sorted(features) != names:
      raise ValueError(
          'Requests disagree on feature names: {} vs {}.'.format(
              names, sorted(features)))
  batched: Dict[str, np.ndarray] = {}
  for name in names:
    rows = [np.asarray(features[name]) for features in features_list]
    stacked = np.stack(rows, axis=0)
    if n_real < pad_to:
      pad = np.repeat(stacked[-1:], pad_to - n_real, axis=0)
      stacked = np.concatenate([stacked, pad], axis=0)
    batched[name] = stacked
  return batched, n_real


def split_outputs(outputs: Dict[str, np.ndarray], n_real: int
                  ) -> List[Dict[str, np.ndarray]]:
  """Row ``i`` of every output array becomes request ``i``'s response.

  Only rows ``[:n_real]`` are returned — padded rows are discarded here,
  by construction, before any response exists to leak them into.
  """
  per_request: List[Dict[str, np.ndarray]] = [
      {} for _ in range(n_real)]
  for name, value in outputs.items():
    array = np.asarray(value)
    if array.ndim < 1 or array.shape[0] < n_real:
      raise ValueError(
          'Output {!r} has leading dim {} < {} real requests.'.format(
              name, array.shape[:1], n_real))
    for i in range(n_real):
      per_request[i][name] = array[i]
  return per_request
