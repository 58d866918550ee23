"""The port's serving layer on the CPU: PolicyServer, telemetry, HTTP door
and the serve entry point."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.observability import TelemetryRegistry
from tensor2robot_tpu_torch.observability import read_telemetry
from tensor2robot_tpu_torch.serving import PolicyServer, ServingConfig
from tensor2robot_tpu_torch.serving import RequestRejected
from tensor2robot_tpu_torch.serving import pad_batch, split_outputs
from tensor2robot_tpu_torch.serving.frontend import build_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {'x': ((3,), np.float32), 'flag': ((), np.float32)}


def _batch_fn(seen):
  """A torch batch function: y = sum(x) * w + flag; records batch sizes."""

  def batch_fn(variables, features, seed):
    x = torch.as_tensor(features['x'])
    seen.append((x.shape[0], int(seed)))
    y = x.sum(-1) * variables['w'] + torch.as_tensor(features['flag'])
    return {'y': y, 'rows': torch.arange(x.shape[0])}

  return batch_fn


def _server(seen, max_queue_depth=64, registry=None, slo_ms=50.0,
            **kwargs):
  config = ServingConfig(max_batch_size=4, max_wait_ms=2.0,
                         max_queue_depth=max_queue_depth, slo_ms=slo_ms,
                         report_interval_s=0.05)
  return PolicyServer(_batch_fn(seen), {'w': torch.tensor(2.0)}, config,
                      feature_spec=SPEC,
                      registry=registry or TelemetryRegistry(), **kwargs)


def test_concurrent_requests_are_batched_padded_and_answered():
  seen = []
  results = {}

  with _server(seen) as server:
    def client(index):
      for j in range(5):
        value = float(index * 10 + j)
        result = server.select_action(
            {'x': np.full(3, value, np.float32), 'flag': np.float32(j)},
            timeout_s=30)
        results[(index, j)] = (value, result)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    stats = server.stats()

  assert len(results) == 30
  for (_, j), (value, result) in results.items():
    assert result.outputs['y'] == pytest.approx(3 * value * 2.0 + j)
    assert result.outputs['rows'] < 4
    assert result.version == 0
  # Every batch had the one padded shape; the seeds count the batches.
  assert {size for size, _ in seen} == {4}
  assert [s for _, s in seen] == list(range(len(seen)))
  assert stats['requests_total'] == 30
  assert stats['batches_total'] == len(seen)
  assert stats['errors_total'] == 0
  assert stats['padding_waste_total'] == 4 * len(seen) - 30


def test_pad_and_split_keep_padded_rows_out_of_responses():
  rows = [{'x': np.full(3, i, np.float32)} for i in range(3)]
  batched, n_real = pad_batch(rows, 5)
  assert n_real == 3 and batched['x'].shape == (5, 3)
  np.testing.assert_array_equal(batched['x'][3:], np.full((2, 3), 2.0))
  out = split_outputs({'y': np.arange(5)}, n_real)
  assert [o['y'] for o in out] == [0, 1, 2]


def test_bad_requests_fail_their_caller_and_overload_is_shed():
  seen = []
  server = _server(seen, max_queue_depth=1)
  with pytest.raises(ValueError, match='shape'):
    server.submit({'x': np.zeros(4, np.float32), 'flag': 0.0})
  server.submit({'x': np.zeros(3, np.float32), 'flag': 0.0})
  with pytest.raises(RequestRejected):
    server.submit({'x': np.zeros(3, np.float32), 'flag': 0.0})
  server.start()
  assert server.drain(timeout_s=10)
  server.close()
  assert server.stats()['rejected_total'] == 1


def test_telemetry_keeps_the_jax_kinds_and_names(tmp_path):
  seen = []
  model_dir = str(tmp_path / 'serving')
  registry = TelemetryRegistry()
  # An SLO no loaded test machine misses, so the doctor's verdict is
  # fixed: healthy.
  with _server(seen, model_dir=model_dir, registry=registry,
               slo_ms=10_000.0) as server:
    for j in range(6):
      server.select_action({'x': np.ones(3, np.float32), 'flag': j},
                           timeout_s=30)
  registry_names = set(registry.scalars())
  kinds = [r['kind'] for r in read_telemetry(model_dir)]
  assert kinds[0] == 'serving_start' and kinds[-1] == 'serving_stop'
  assert 'serving' in kinds
  report = [r for r in read_telemetry(model_dir) if r['kind'] == 'serving'][-1]
  for key in ('p50_ms', 'p95_ms', 'p99_ms', 'slo_ms', 'requests',
              'batch_fill', 'padding_waste', 'rejected_total'):
    assert key in report
  assert os.path.exists(os.path.join(model_dir, 'heartbeat.json'))
  for name in ('serving/requests', 'serving/batches', 'serving/errors',
               'serving/rejected', 'serving/padding_waste',
               'serving/queue_depth', 'inference/latency_ms/serving_request/p99',
               'inference/latency_ms/serving_batch/p50'):
    assert name in registry_names, name

  # The JAX package's doctor reads the port's serving directory.
  from tensor2robot_tpu.observability import doctor
  messages = [f['message'] for f in doctor.diagnose(model_dir)]
  assert any(m.startswith('serving healthy') for m in messages), messages


def test_http_round_trip():
  seen = []
  with _server(seen) as server:
    httpd, port = build_http_server(server, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
      url = 'http://127.0.0.1:{}'.format(port)
      body = json.dumps({'features': {'x': [1.0, 2.0, 3.0],
                                      'flag': 0.5}}).encode()
      request = urllib.request.Request(url + '/v1/select_action', body,
                                       {'Content-Type': 'application/json'})
      with urllib.request.urlopen(request, timeout=30) as response:
        reply = json.loads(response.read())
      assert reply['outputs']['y'] == pytest.approx(12.5)
      assert reply['version'] == 0
      with urllib.request.urlopen(url + '/healthz', timeout=30) as response:
        assert json.loads(response.read())['requests_total'] == 1
      # /metricz reads the process-wide registry (this server has its own).
      with urllib.request.urlopen(url + '/metricz', timeout=30) as response:
        scalars = json.loads(response.read())
      assert all(tag.startswith(('serving/', 'inference/'))
                 for tag in scalars)
      bad = urllib.request.Request(url + '/v1/select_action', b'[1]')
      with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(bad, timeout=30)
      assert err.value.code == 400
    finally:
      httpd.shutdown()
      httpd.server_close()
      thread.join(timeout=10)


def test_serve_entry_point_prints_its_stats_line():
  args = [sys.executable, '-m', 'tensor2robot_tpu_torch.serving.serve',
          '--device', 'cpu', '--init_randomly', '--synthetic_load', '2',
          '--duration', '2', '--num_convs', '1,1,1', '--cem_samples', '4',
          '--cem_iters', '2', '--num_elites', '2', '--max_batch_size', '2']
  result = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
  assert result.returncode == 0, result.stderr
  stats = json.loads(result.stdout.strip().splitlines()[-1])
  assert stats['device'] == 'cpu'
  assert stats['completed'] > 0 and stats['failed'] == 0
  assert stats['errors_total'] == 0
  assert stats['requests_total'] >= stats['completed']


def test_serve_requires_random_init_until_restore_is_ported():
  from tensor2robot_tpu_torch.serving import serve
  with pytest.raises(SystemExit):
    serve.main(['--device', 'cpu'])
