"""Stdlib HTTP door of a ReplayService (a copy of the JAX package's
``replay/frontend.py``; the same paths, status codes and bodies, so that
either package's client talks to either package's door).

One thread per connection (``ThreadingHTTPServer``). Request and response
bodies are replay records (``replay/wire.py``, ``application/octet-stream``).

Endpoints:
  * ``POST /v1/append[?priority=<float>]``: body, one record. 200 ->
    ``{"shard": i, "shard_occupancy_examples": n}``; 400 when the record
    fails validation (it was charged to the shard's quarantine budget and
    dropped); 507 when a quarantine budget is exhausted.
  * ``POST /v1/sample``: body ``{"batch_size": n}`` (empty: the service's
    default). 200 -> one encoded batch (keys ``features/...`` and
    ``labels/...`` plus a ``__record_ids__`` [B, 2] int64 array of (shard,
    record id)); 409 when the store is empty, 503 when admission control
    sheds the request.
  * ``POST /v1/update_priorities``: ``{"record_ids": [[shard, id], ...],
    "priorities": [...]}`` -> ``{"landed": n}``.
  * ``GET /healthz``: :meth:`ReplayService.stats` as JSON.
  * ``GET /metricz``: the registry's ``replay/`` scalars.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.reliability.errors import CorruptionBudgetExceeded
from tensor2robot_tpu_torch.replay import wire
from tensor2robot_tpu_torch.replay.service import ReplayEmpty, ReplayService
from tensor2robot_tpu_torch.serving.batching import RequestRejected

__all__ = ['build_http_server', 'RECORD_IDS_KEY']

# Rides inside the sampled megabatch record: [B, 2] int64 (shard, id).
RECORD_IDS_KEY = '__record_ids__'


class _Handler(BaseHTTPRequestHandler):
  # Set by build_http_server on the subclass.
  replay_service: ReplayService = None
  request_timeout_s: float = 60.0

  def log_message(self, *args) -> None:  # quiet: telemetry is the log
    pass

  def _reply_json(self, status: int, payload: dict) -> None:
    body = json.dumps(payload).encode('utf-8')
    self.send_response(status)
    self.send_header('Content-Type', 'application/json')
    self.send_header('Content-Length', str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def _reply_record(self, blob: bytes) -> None:
    self.send_response(200)
    self.send_header('Content-Type', 'application/octet-stream')
    self.send_header('Content-Length', str(len(blob)))
    self.end_headers()
    self.wfile.write(blob)

  def _body(self) -> bytes:
    length = int(self.headers.get('Content-Length', 0))
    return self.rfile.read(length) if length else b''

  def do_GET(self) -> None:  # noqa: N802 - http.server API
    if self.path == '/healthz':
      self._reply_json(200, self.replay_service.stats())
    elif self.path == '/metricz':
      scalars = get_registry().scalars()
      self._reply_json(200, {tag: value
                             for tag, value in sorted(scalars.items())
                             if tag.startswith('replay/')})
    else:
      self._reply_json(404, {'error': 'unknown path {}'.format(self.path)})

  def do_POST(self) -> None:  # noqa: N802 - http.server API
    parsed = urlparse(self.path)
    if parsed.path == '/v1/append':
      self._append(parsed)
    elif parsed.path == '/v1/sample':
      self._sample()
    elif parsed.path == '/v1/update_priorities':
      self._update_priorities()
    else:
      self._reply_json(404, {'error': 'unknown path {}'.format(self.path)})

  def _append(self, parsed) -> None:
    try:
      priority = float(
          parse_qs(parsed.query).get('priority', ['1.0'])[0])
    except ValueError:
      self._reply_json(400, {'error': 'priority must be a float'})
      return
    blob = self._body()
    if not blob:
      self._reply_json(400, {'error': 'empty append body'})
      return
    try:
      shard = self.replay_service.append(blob, priority=priority)
    except CorruptionBudgetExceeded as e:
      self._reply_json(507, {'error': str(e)})
      return
    except wire.ReplayWireError as e:
      self._reply_json(400, {'error': 'corrupt record (quarantined): {}'
                             .format(e), 'quarantined': True})
      return
    # The RECEIVING shard's occupancy only: reporting the service total
    # would take every shard's lock on every append, serializing the
    # per-shard concurrency N writers rely on.
    self._reply_json(200, {
        'shard': shard,
        'shard_occupancy_examples':
            self.replay_service.shard_occupancy(shard)})

  def _sample(self) -> None:
    body = self._body()
    batch_size = None
    try:
      if body:
        payload = json.loads(body)
        if not isinstance(payload, dict):
          raise ValueError('body must be a JSON object')
        batch_size = payload.get('batch_size')
        if batch_size is not None:
          # Coerced here, so that a non-integer is a 400 and not an
          # exception escaping the handler as a dropped connection.
          batch_size = int(batch_size)
          if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
    except (ValueError, TypeError) as e:
      self._reply_json(400, {'error': 'bad request: {}'.format(e)})
      return
    try:
      future = self.replay_service.submit_sample(batch_size)
    except RequestRejected as e:
      self._reply_json(503, {'error': str(e)})
      return
    except RuntimeError as e:  # racing shutdown: clean "try elsewhere"
      self._reply_json(503, {'error': str(e)})
      return
    try:
      result = future.result(timeout=self.request_timeout_s)
    except ReplayEmpty as e:
      self._reply_json(409, {'error': str(e)})
      return
    except Exception as e:  # noqa: BLE001 - surface the sample failure
      self._reply_json(500, {'error': '{}: {}'.format(type(e).__name__, e)})
      return
    flat = {}
    flat.update({'features/' + k: v for k, v in result.features.items()})
    flat.update({'labels/' + k: v for k, v in result.labels.items()})
    flat[RECORD_IDS_KEY] = np.asarray(result.record_ids, np.int64)
    self._reply_record(wire.encode_example(flat))

  def _update_priorities(self) -> None:
    try:
      payload = json.loads(self._body() or b'{}')
      record_ids = [(int(s), int(i)) for s, i in payload['record_ids']]
      priorities = [float(p) for p in payload['priorities']]
      if len(record_ids) != len(priorities):
        raise ValueError('record_ids and priorities disagree on length')
    except (ValueError, TypeError, KeyError) as e:
      self._reply_json(400, {'error': 'bad request: {}'.format(e)})
      return
    landed = self.replay_service.update_priorities(record_ids, priorities)
    self._reply_json(200, {'landed': landed})


def build_http_server(replay_service: ReplayService,
                      host: str = '127.0.0.1',
                      port: int = 0,
                      request_timeout_s: float = 60.0
                      ) -> Tuple[ThreadingHTTPServer, int]:
  """Binds the HTTP front end; returns ``(httpd, bound_port)``.

  ``port=0`` binds an ephemeral port (tests). Call
  ``httpd.serve_forever()`` (blocking) or drive it from a thread;
  ``httpd.shutdown()`` stops it — then close the ReplayService.
  """
  handler = type('ReplayHandler', (_Handler,), {
      'replay_service': replay_service,
      'request_timeout_s': request_timeout_s,
  })
  httpd = ThreadingHTTPServer((host, port), handler)
  return httpd, httpd.server_address[1]
