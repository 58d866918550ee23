"""Stdlib HTTP/JSON front door for a PolicyServer.

A copy of the JAX package's ``serving/frontend.py``, with the same
endpoints and wire format. One thread per connection
(``ThreadingHTTPServer``) feeds the shared batcher, so N concurrent HTTP
callers coalesce into batches behind one batch function. JSON arrays are
the wire format; the server's ``feature_spec`` casts them to the batch
function's dtypes, so clients send plain nested lists.

Endpoints:
  * ``POST /v1/select_action``: body ``{"features": {name: value}}``;
    200 -> ``{"outputs": {...}, "version": int, "latency_ms": float}``;
    400 on a malformed or spec-violating request, 503 when admission
    control sheds the request, 500 on a failed batch.
  * ``GET /healthz``: cumulative ``stats()`` as JSON.
  * ``GET /metricz``: the registry's ``serving/`` and ``inference/``
    scalars (flat tag -> value JSON).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np

from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.serving.batching import RequestRejected
from tensor2robot_tpu_torch.serving.server import PolicyServer

__all__ = ['build_http_server']


def _jsonable(value):
  if isinstance(value, np.ndarray):
    return value.tolist()
  if isinstance(value, (np.generic,)):
    return value.item()
  return value


class _Handler(BaseHTTPRequestHandler):
  # Set by build_http_server on the subclass. Duck-typed: anything
  # exposing submit() and stats().
  policy_server = None  # type: PolicyServer
  request_timeout_s: float = 60.0

  def log_message(self, *args) -> None:  # quiet: telemetry is the log
    pass

  def _reply(self, status: int, payload: dict) -> None:
    body = json.dumps(payload).encode('utf-8')
    self.send_response(status)
    self.send_header('Content-Type', 'application/json')
    self.send_header('Content-Length', str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def do_GET(self) -> None:  # noqa: N802 — http.server API
    if self.path == '/healthz':
      self._reply(200, {k: _jsonable(v)
                        for k, v in self.policy_server.stats().items()})
    elif self.path == '/metricz':
      scalars = get_registry().scalars()
      self._reply(200, {tag: value for tag, value in sorted(scalars.items())
                        if tag.startswith(('serving/', 'inference/'))})
    else:
      self._reply(404, {'error': 'unknown path {}'.format(self.path)})

  def do_POST(self) -> None:  # noqa: N802 — http.server API
    if self.path != '/v1/select_action':
      self._reply(404, {'error': 'unknown path {}'.format(self.path)})
      return
    try:
      length = int(self.headers.get('Content-Length', 0))
      payload = json.loads(self.rfile.read(length) or b'{}')
      if not isinstance(payload, dict):
        raise ValueError('body must be a JSON object')
      features = payload['features']
      if not isinstance(features, dict):
        raise ValueError('"features" must be an object')
    except (ValueError, KeyError, TypeError) as e:
      self._reply(400, {'error': 'bad request: {}'.format(e)})
      return
    try:
      future = self.policy_server.submit(
          {name: np.asarray(value) for name, value in features.items()})
    except RequestRejected as e:
      self._reply(503, {'error': str(e)})
      return
    except RuntimeError as e:
      # Racing shutdown (batcher closed): still a clean "try elsewhere".
      self._reply(503, {'error': str(e)})
      return
    except ValueError as e:
      self._reply(400, {'error': str(e)})
      return
    try:
      result = future.result(timeout=self.request_timeout_s)
    except Exception as e:  # noqa: BLE001 — surface the batch failure
      self._reply(500, {'error': '{}: {}'.format(type(e).__name__, e)})
      return
    self._reply(200, {
        'outputs': {k: _jsonable(v) for k, v in result.outputs.items()},
        'version': result.version,
        'latency_ms': round(result.latency_ms, 3),
    })


def build_http_server(policy_server,
                      host: str = '127.0.0.1',
                      port: int = 0,
                      request_timeout_s: float = 60.0
                      ) -> Tuple[ThreadingHTTPServer, int]:
  """Binds the HTTP front end; returns ``(httpd, bound_port)``.

  ``policy_server`` is a :class:`PolicyServer` (anything with
  ``submit``/``stats``). ``port=0`` binds an ephemeral port (tests).
  Call ``httpd.serve_forever()`` (blocking) or drive it from a thread;
  ``httpd.shutdown()`` stops it; then close the server.
  """
  handler = type('PolicyHandler', (_Handler,), {
      'policy_server': policy_server,
      'request_timeout_s': request_timeout_s,
  })
  httpd = ThreadingHTTPServer((host, port), handler)
  return httpd, httpd.server_address[1]
