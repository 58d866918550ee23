"""The port's serving layer on the CPU: PolicyServer, telemetry, HTTP door,
the serve entry point, and the operator's path from records on disk
through the trainer and its checkpoints to serve.py (with hot swap) and
the critic's CEMPolicy, against the JAX package."""

import json
import os
import subprocess
import sys
import threading
import time
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
# The JAX critic's import shim (a module fixture) and its weight draws.
from test_torch_qtopt import _flax_variables, ref  # noqa: F401

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


# -- records -> trainer -> checkpoint -> serve.py, against the JAX critic --
#
# The JAX package writes critic records with its own writer and specs; the
# port's loader reads them into the port critic's batch, its trainer trains
# a tiny critic (num_convs 1, 1, 1) from them, and serve.py serves the
# checkpoint. The JAX critic, given the trained weights converted back to
# flax, scores the served action as the server did. Tolerance: 1e-5 on q in
# [0, 1], as tests/test_torch_qtopt.py holds the two packages' critics.

TINY = (1, 1, 1)
TINY_CEM = ['--cem_samples', '4', '--cem_iters', '2', '--num_elites', '2']


def _jpeg_frame(rng, index):
  """A 512x640 camera-like frame (smooth ramps and noise) as JPEG."""
  import cv2
  yy, xx = np.mgrid[0:512, 0:640]
  image = np.stack([xx, yy, xx + yy], -1) * (index + 1) % 256
  image = np.clip(image + rng.randint(-8, 8, image.shape), 0, 255)
  ok, encoded = cv2.imencode('.jpg', image.astype(np.uint8)[..., ::-1])
  assert ok
  return encoded.tobytes()


def _jax_critic(ref):
  return ref.t2r_models.\
      Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device_type='cpu', network_kwargs={'num_convs': TINY})


def _port_critic():
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': TINY})


@pytest.fixture(scope='module')
def critic_records(ref, tmp_path_factory):
  """8 critic examples in 2 files, written by the JAX package's writer
  with the JAX critic's in-specifications."""
  from tensor2robot_tpu.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu.specs.struct import SpecStruct

  jax_model = _jax_critic(ref)
  features = jax_model.preprocessor.get_in_feature_specification('train')
  labels = jax_model.preprocessor.get_in_label_specification('train')
  spec = SpecStruct()
  for key in features:
    spec['features/' + key] = features[key]
  for key in labels:
    spec['labels/' + key] = labels[key]
  directory = tmp_path_factory.mktemp('critic_records')
  rng = np.random.RandomState(0)
  for f in range(2):
    with TFRecordReplayWriter() as writer:
      writer.open(str(directory / 'train-{}.tfrecord'.format(f)))
      for i in range(4):
        example = SpecStruct()
        for key in spec:
          shape = spec[key].shape
          if key == 'features/state/image':
            example[key] = _jpeg_frame(rng, 4 * f + i)
          elif key == 'labels/reward':
            example[key] = np.asarray([i % 2], np.float32)
          else:
            example[key] = rng.uniform(-1, 1, shape).astype(np.float32)
        writer.write_numpy(spec, example)
  return str(directory / 'train-*.tfrecord'), features, labels


@pytest.mark.parametrize('use_native', [True, False])
def test_jax_written_critic_records_parse_into_the_port_critics_batch(
    critic_records, use_native):
  from tensor2robot_tpu.data.input_generators import (
      DefaultRecordInputGenerator as JaxRecordInputGenerator)
  from tensor2robot_tpu_torch.data.input_generators import (
      DefaultRecordInputGenerator)
  from tensor2robot_tpu_torch.modes import ModeKeys

  pattern, jax_features, jax_labels = critic_records
  port = DefaultRecordInputGenerator(file_patterns=pattern, batch_size=4,
                                     use_native=use_native)
  port.set_specification_from_model(_port_critic(), ModeKeys.TRAIN)
  for key in jax_features:   # the same on-disk layout, field for field
    want = jax_features[key]
    got = port.feature_spec[key]
    assert (got.name, got.data_format, got.shape, got.dtype) == (
        want.name, want.data_format, want.shape, want.dtype), key
  assert port.label_spec['reward'].name == jax_labels['reward'].name
  jax = JaxRecordInputGenerator(file_patterns=pattern, batch_size=4,
                                use_native=use_native)
  jax.set_specification(jax_features, jax_labels)
  got = list(port.create_dataset_iterator(ModeKeys.TRAIN, num_epochs=1,
                                          seed=3))
  want = list(jax.create_dataset_iterator(ModeKeys.TRAIN, num_epochs=1,
                                          seed=3))
  assert len(got) == len(want) == 2
  for (gf, gl), (wf, wl) in zip(got, want):
    for g, w in ((gf, wf), (gl, wl)):
      assert sorted(g) == sorted(w)
      for key in w:
        assert g[key].dtype == np.asarray(w[key]).dtype, key
        np.testing.assert_array_equal(g[key], np.asarray(w[key]),
                                      err_msg=key)


@pytest.fixture(scope='module')
def trained(critic_records, tmp_path_factory):
  """The tiny critic trained 2 steps from the records by train_eval.main;
  (model_dir, the command's JSON line)."""
  import contextlib
  import io

  from tensor2robot_tpu_torch.trainer import train_eval

  model_dir = str(tmp_path_factory.mktemp('trained'))
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main([
        '--device', 'cpu', '--num_convs', '1,1,1', '--batch_size', '2',
        '--max_train_steps', '2', '--log_every_n_steps', '1',
        '--model_dir', model_dir, '--train_data', critic_records[0],
        '--eval_data', critic_records[0], '--eval_steps', '1',
        '--eval_throttle_steps', '2']) == 0
  return model_dir, json.loads(out.getvalue().strip().splitlines()[-1])


def test_train_eval_trains_the_critic_from_records(trained):
  from tensor2robot_tpu_torch.trainer import checkpointing

  model_dir, line = trained
  assert line['data'] == 'native' and line['step'] == 2
  assert line['checkpoint_step'] == 2
  assert np.isfinite(line['metrics']['loss'])
  assert np.isfinite(line['eval_metrics']['loss'])
  assert line['data_wait_sec'] >= 0
  assert checkpointing.all_checkpoint_steps(model_dir) == [2]


def _serve_args(model_dir, *extra):
  from tensor2robot_tpu_torch.serving import serve
  return serve.make_parser().parse_args(
      ['--device', 'cpu', '--checkpoint_dir', model_dir, '--num_convs',
       '1,1,1', '--max_batch_size', '2', '--max_wait_ms', '1'] + TINY_CEM +
      list(extra))


def test_serve_main_serves_the_trainers_checkpoint(trained, capsys):
  from tensor2robot_tpu_torch.serving import serve

  model_dir, _ = trained
  assert serve.main(['--device', 'cpu', '--checkpoint_dir', model_dir,
                     '--synthetic_load', '2', '--duration', '1',
                     '--num_convs', '1,1,1', '--max_batch_size', '2'] +
                    TINY_CEM) == 0
  stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert stats['params_version'] == 2 and stats['failed'] == 0
  assert stats['completed'] > 0 and stats['versions_served'] == {
      '2': stats['completed']}
  # Telemetry goes beside the checkpoints, in a directory of its own.
  assert os.path.exists(os.path.join(model_dir, 'serving',
                                     'telemetry.jsonl'))


def test_served_q_is_the_jax_critics_on_the_trained_weights(ref, trained):
  from tensor2robot_tpu.specs.struct import SpecStruct
  from tensor2robot_tpu_torch.serving import serve
  from tensor2robot_tpu_torch.trainer import checkpointing

  model_dir, _ = trained
  serving = serve.start(_serve_args(model_dir, '--poll_secs', '60'))
  rng = np.random.RandomState(5)
  state = serve.synthetic_state(serving.feature_spec, rng)
  try:
    result = serving.service.select_action(state, timeout_s=60)
  finally:
    serving.stop()
  assert result.version == 2

  # The trained weights, back to flax, through the JAX critic's PREDICT
  # path (center crop, / 255, the network) on the served action.
  jax_model = _jax_critic(ref)
  features = SpecStruct()
  features['state/image'] = state['image'][None]
  action = np.asarray(result.outputs['action'], np.float32)[None]
  offset = 0
  for key, size in ref.t2r_models.ACTION_DIM_LAYOUT:
    features['action/' + key] = action[:, offset:offset + size]
    offset += size
  for key in ('gripper_closed', 'height_to_bottom'):
    features['action/' + key] = np.full((1, 1), state[key], np.float32)
  template = _flax_variables(jax_model.create_network(),
                             (_init_features(ref),), 0, mode='predict',
                             train=False)
  trained_state = checkpointing.CheckpointManager(model_dir).restore()
  variables = {'params': _to_flax(trained_state.avg_params,
                                  template['params']),
               'batch_stats': _to_flax(trained_state.model_state,
                                       template['batch_stats'])}
  processed, _ = jax_model.preprocessor.preprocess(features, None,
                                                   'predict', rng=None)
  outputs, _ = jax_model.inference_network_fn(variables, processed, None,
                                              'predict', None)
  np.testing.assert_allclose(float(result.outputs['q']),
                             float(outputs['q_predicted'][0]), atol=1e-5)


def _init_features(ref):
  features = {'state/image': np.zeros((1, 472, 472, 3), np.float32)}
  for key, size in ref.t2r_models.ACTION_DIM_LAYOUT + (
      ('gripper_closed', 1), ('height_to_bottom', 1)):
    features['action/' + key] = np.zeros((1, size), np.float32)
  return features


def _to_flax(state_dict, template, path=()):
  """The port's state dict as a flax tree shaped like ``template``
  (``convert.from_flax`` backwards)."""
  out = {}
  for key, value in template.items():
    if hasattr(value, 'items'):
      out[key] = _to_flax(state_dict, value, path + (key,))
      continue
    name = '.'.join(path + ('weight' if key == 'kernel' else key,))
    array = state_dict[name].detach().cpu().numpy()
    if key == 'kernel':
      array = array.transpose(2, 3, 1, 0) if array.ndim == 4 else array.T
    assert array.shape == np.shape(value), name
    out[key] = np.ascontiguousarray(array)
  return out


def test_a_newer_checkpoint_is_hot_swapped_while_requests_go_on(trained,
                                                                tmp_path):
  import shutil

  from tensor2robot_tpu_torch.serving import serve
  from tensor2robot_tpu_torch.trainer import checkpointing

  model_dir = str(tmp_path / 'model')
  shutil.copytree(trained[0], model_dir)
  serving = serve.start(_serve_args(model_dir, '--poll_secs', '0.1'))
  results = {}

  def drive():
    results.update(serve.run_synthetic_load(serving.service,
                                            serving.feature_spec, 2, 3.0))

  client = threading.Thread(target=drive)
  request = serve.synthetic_state(serving.feature_spec,
                                  np.random.RandomState(0))
  try:
    assert serving.service.select_action(request, timeout_s=60).version == 2
    client.start()
    state = checkpointing.CheckpointManager(model_dir).restore()
    state.step = 7
    state.avg_params = {k: v * 1.5 for k, v in state.avg_params.items()}
    checkpointing.CheckpointManager(model_dir).save(state)
    client.join(timeout=60)
    assert serving.service.select_action(request, timeout_s=60).version == 7
  finally:
    serving.stop()
  assert results['failed'] == 0
  assert '7' in results['versions_served']
  assert set(results['versions_served']) <= {'2', '7'}
  assert [version for version, _ in serving.swaps] == [7]
  assert results['first_answer_monotonic']['7'] >= serving.swaps[0][1]


def test_restore_timeout_without_a_checkpoint_exits_with_the_message(
    tmp_path):
  from tensor2robot_tpu_torch.serving import serve
  with pytest.raises(SystemExit, match='no checkpoint appeared'):
    serve.main(['--device', 'cpu', '--checkpoint_dir', str(tmp_path),
                '--restore_timeout', '0.2', '--num_convs', '1,1,1'])


def test_a_failed_poll_keeps_the_old_weights(trained, tmp_path, capsys):
  import shutil

  from tensor2robot_tpu_torch.serving import serve

  model_dir = str(tmp_path / 'model')
  shutil.copytree(trained[0], model_dir)
  serving = serve.start(_serve_args(model_dir, '--poll_secs', '0.05'))
  try:
    with open(os.path.join(model_dir, 'checkpoint_9.pt'), 'wb') as f:
      f.write(b'half written')
    os.remove(os.path.join(model_dir, 'checkpoint_2.pt'))
    deadline = time.monotonic() + 30
    while 'hot-swap poll failed' not in capsys.readouterr().err:
      assert time.monotonic() < deadline
      time.sleep(0.05)
    state = serve.synthetic_state(serving.feature_spec,
                                  np.random.RandomState(0))
    assert serving.service.select_action(state, timeout_s=60).version == 2
  finally:
    serving.stop()


def test_cem_policy_picks_the_jax_cem_policys_action(ref, tmp_path):
  import jax
  from tensor2robot_tpu.policies.policies import CEMPolicy as JaxCEMPolicy
  from tensor2robot_tpu_torch import convert
  from tensor2robot_tpu_torch.models.abstract_model import TrainState
  from tensor2robot_tpu_torch.policies import CEMPolicy
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor)
  from tensor2robot_tpu_torch.trainer import checkpointing

  jax_model = _jax_critic(ref)
  variables = _flax_variables(jax_model.create_network(),
                              (_init_features(ref),), 7, avg=True,
                              mode='predict', train=False)
  for name in ('params', 'avg_params'):   # scores out of saturation
    variables[name]['grasping44']['logit']['kernel'] *= 0.1
  port_variables = convert.from_flax(variables)
  checkpointing.CheckpointManager(str(tmp_path)).save(TrainState(
      step=1, params=port_variables['params'], model_state={},
      opt_state=None, avg_params=port_variables['avg_params']))
  predictor = CheckpointPredictor(_port_critic(), str(tmp_path), timeout=5)
  assert predictor.restore()

  class JaxPredictor:
    """The JAX critic's PREDICT path on the flax weights (avg_params)."""

    def predict(self, features):
      processed, _ = jax_model.preprocessor.preprocess(
          _spec_struct(features), None, 'predict', rng=None)
      outputs, _ = jax_model.inference_network_fn(
          {'params': variables['avg_params'],
           'batch_stats': variables['batch_stats']}, processed, None,
          'predict', None)
      return jax.tree_util.tree_map(np.asarray, dict(outputs))

  state = {'image': np.random.RandomState(1).randint(
      0, 256, (512, 640, 3)).astype(np.uint8),
           'gripper_closed': np.float32(1.0),
           'height_to_bottom': np.float32(0.25)}
  kwargs = dict(action_size=8, cem_iters=2, cem_samples=16, num_elites=4)
  np.random.seed(3)
  want, want_debug = JaxCEMPolicy(
      jax_model, predictor=JaxPredictor(), **kwargs).sample_action(state, 0)
  np.random.seed(3)
  policy = CEMPolicy(_port_critic(), predictor=predictor, **kwargs)
  got, got_debug = policy.sample_action(state, 0)
  assert got.shape == (8,)
  np.testing.assert_allclose(got, want, atol=1e-6)
  np.testing.assert_allclose(got_debug['q'], want_debug['q'], atol=1e-5)
  np.random.seed(3)
  np.testing.assert_array_equal(policy.SelectAction(state, None, 0), got)


def _spec_struct(features):
  from tensor2robot_tpu.specs.struct import SpecStruct
  out = SpecStruct()
  for key, value in features.items():
    out[key] = value
  return out
