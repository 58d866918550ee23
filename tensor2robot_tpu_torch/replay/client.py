"""Replay clients: the writer's and the learner's half of the replay wire (a
copy of the JAX package's ``replay/client.py``).

  * :class:`ReplayClient`: stdlib HTTP against a replay endpoint
    (``python -m tensor2robot_tpu_torch.replay.run_replay``; the JAX
    package's door speaks the same wire). Every call goes
    through ``reliability.retry`` with exponential backoff and jitter
    (sites ``replay.append`` / ``replay.sample``); shed requests (503) and
    connection failures are transient, a 400 is not.
  * :class:`LocalReplayClient`: the same API over an in-process
    :class:`ReplayService`.

``sample`` can ``wait`` for the store to fill: a learner that starts before
its collectors is a normal boot order.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.reliability.retry import RetryPolicy, retry
from tensor2robot_tpu_torch.replay import wire
from tensor2robot_tpu_torch.replay.service import (
    ReplayEmpty,
    ReplayService,
    SampleBatch,
    split_sides,
)

__all__ = ['ReplayClient', 'LocalReplayClient', 'ReplayUnavailable']

RECORD_IDS_KEY = '__record_ids__'  # mirrors frontend.RECORD_IDS_KEY


class ReplayUnavailable(OSError):
  """Transient service failure (connection refused, shed, 5xx): an OSError,
  so that the default RetryPolicy retries it."""


def _normalize_endpoint(endpoint: str) -> str:
  if not endpoint.startswith(('http://', 'https://')):
    endpoint = 'http://' + endpoint
  return endpoint.rstrip('/')


class ReplayClient:
  """HTTP replay client with bounded retry."""

  def __init__(self, endpoint: str,
               retry_policy: Optional[RetryPolicy] = None,
               timeout_s: float = 60.0):
    self.endpoint = _normalize_endpoint(endpoint)
    self._retry_policy = retry_policy or RetryPolicy(
        max_attempts=5, base_delay_secs=0.1, max_delay_secs=2.0)
    self._timeout_s = float(timeout_s)

  def _post(self, path: str, body: bytes, content_type: str) -> bytes:
    request = urllib.request.Request(
        self.endpoint + path, data=body, method='POST',
        headers={'Content-Type': content_type})
    try:
      with urllib.request.urlopen(request,
                                  timeout=self._timeout_s) as response:
        return response.read()
    except urllib.error.HTTPError as e:
      detail = e.read().decode('utf-8', 'replace')[:500]
      if e.code == 409:
        raise ReplayEmpty(detail) from e
      if e.code in (502, 503, 504):
        raise ReplayUnavailable('{} {}: {}'.format(
            e.code, path, detail)) from e
      # 400/404/500/507: deterministic; not retried.
      raise RuntimeError('replay {} failed with {}: {}'.format(
          path, e.code, detail)) from e
    except urllib.error.URLError as e:
      raise ReplayUnavailable('{} unreachable: {}'.format(
          self.endpoint, e.reason)) from e

  def append(self, example, priority: float = 1.0) -> int:
    """Appends one example; returns the shard it landed on.

    ``example`` is either an encoded record (bytes) or a flat
    ``{key: array}`` dict to encode here.
    """
    blob = example if isinstance(example, (bytes, bytearray)) \
        else wire.encode_example(example)
    path = '/v1/append?priority={:.6g}'.format(float(priority))
    payload = retry(
        lambda: self._post(path, bytes(blob), 'application/octet-stream'),
        policy=self._retry_policy, site='replay.append')
    return int(json.loads(payload).get('shard', -1))

  def sample(self, batch_size: Optional[int] = None,
             wait: bool = False,
             wait_timeout_s: float = 60.0,
             poll_interval_s: float = 0.2) -> SampleBatch:
    """Draws one megabatch; with ``wait`` polls through ReplayEmpty."""
    body = b'' if batch_size is None else json.dumps(
        {'batch_size': int(batch_size)}).encode('utf-8')

    def _once() -> SampleBatch:
      payload = retry(
          lambda: self._post('/v1/sample', body, 'application/json'),
          policy=self._retry_policy, site='replay.sample')
      flat = dict(wire.decode_example(payload))
      ids = flat.pop(RECORD_IDS_KEY, None)
      features, labels = split_sides(flat)
      record_ids = [] if ids is None else \
          [(int(s), int(i)) for s, i in np.asarray(ids)]
      return SampleBatch(features=features, labels=labels,
                         record_ids=record_ids)

    if not wait:
      return _once()
    deadline = time.monotonic() + wait_timeout_s
    while True:
      try:
        return _once()
      except ReplayEmpty:
        if time.monotonic() >= deadline:
          raise
        time.sleep(poll_interval_s)

  def update_priorities(self, record_ids: Sequence[Tuple[int, int]],
                        priorities: Sequence[float]) -> int:
    body = json.dumps({
        'record_ids': [[int(s), int(i)] for s, i in record_ids],
        'priorities': [float(p) for p in priorities],
    }).encode('utf-8')
    payload = retry(
        lambda: self._post('/v1/update_priorities', body,
                           'application/json'),
        policy=self._retry_policy, site='replay.update_priorities')
    return int(json.loads(payload).get('landed', 0))

  def stats(self) -> Dict[str, object]:
    request = urllib.request.Request(self.endpoint + '/healthz')
    try:
      with urllib.request.urlopen(request,
                                  timeout=self._timeout_s) as response:
        return json.loads(response.read())
    except urllib.error.URLError as e:
      raise ReplayUnavailable('{} unreachable: {}'.format(
          self.endpoint, e)) from e


class LocalReplayClient:
  """The ReplayClient API over an in-process ReplayService."""

  def __init__(self, service: ReplayService):
    self._service = service

  def append(self, example, priority: float = 1.0) -> int:
    blob = example if isinstance(example, (bytes, bytearray)) \
        else wire.encode_example(example)
    return self._service.append(bytes(blob), priority=priority)

  def sample(self, batch_size: Optional[int] = None,
             wait: bool = False,
             wait_timeout_s: float = 60.0,
             poll_interval_s: float = 0.2) -> SampleBatch:
    if not wait:
      return self._service.sample(batch_size)
    deadline = time.monotonic() + wait_timeout_s
    while True:
      try:
        return self._service.sample(batch_size)
      except ReplayEmpty:
        if time.monotonic() >= deadline:
          raise
        time.sleep(poll_interval_s)

  def update_priorities(self, record_ids: Sequence[Tuple[int, int]],
                        priorities: Sequence[float]) -> int:
    return self._service.update_priorities(record_ids, priorities)

  def stats(self) -> Dict[str, object]:
    return self._service.stats()
