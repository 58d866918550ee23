"""The port's replay (``tensor2robot_tpu_torch/replay``) against the JAX
package's, on the CPU.

Both are numpy and threads, so the comparisons are exact: the same dict
encodes to the same bytes, the same seed draws the same slots and ids, and
either package's HTTP client talks to the other's door.
"""

import threading

import numpy as np
import pytest

from _torch_jax_qtopt import jax_qtopt_fixture, jax_qtopt_modules
from tensor2robot_tpu_torch import observability as obs
from tensor2robot_tpu_torch.data import native_loader
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data.wire import build_example
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.reliability.errors import (
    CorruptionBudgetExceeded,
    RetryError,
)
from tensor2robot_tpu_torch.reliability.retry import RetryPolicy, retry
from tensor2robot_tpu_torch.replay import client as client_lib
from tensor2robot_tpu_torch.replay import frontend
from tensor2robot_tpu_torch.replay import sampling
from tensor2robot_tpu_torch.replay import service as service_lib
from tensor2robot_tpu_torch.replay import store as store_lib
from tensor2robot_tpu_torch.replay import wire
from tensor2robot_tpu_torch.serving.batching import RequestRejected
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.utils.image import numpy_to_image_string


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture('replay.wire', 'replay.sampling',
                               'replay.store', 'replay.service',
                               'replay.client', 'replay.frontend')


@pytest.fixture(autouse=True)
def fresh_state():
  previous = obs.set_registry(obs.TelemetryRegistry())
  fault_injection.set_injector(None)
  yield
  fault_injection.set_injector(None)
  obs.set_registry(previous)


def _entries(seed):
  """A dict of every dtype the wire allows, a 0-d array and an empty one."""
  rng = np.random.RandomState(seed)
  return {
      'features/state/image': rng.randint(0, 255, (6, 5, 3)).astype(
          np.uint8),
      'features/action/world_vector': rng.randn(3).astype(np.float32),
      'features/done': np.asarray([1.0], np.float32),
      'features/wide': rng.randn(2, 2).astype(np.float64),
      'features/half': rng.randn(4).astype(np.float16),
      'features/ids': rng.randint(-9, 9, (3,)).astype(np.int64),
      'features/small': rng.randint(-9, 9, (3,)).astype(np.int16),
      'features/mask': rng.rand(4) > 0.5,
      'features/scalar': np.float32(seed),
      'features/empty': np.zeros((0, 3), np.int32),
      'labels/reward': np.asarray([0.5 * seed], np.float32),
  }


def _transition(i, rng):
  """A transition record's arrays (the loop's keys), with a height tag."""
  return {
      'features/state/image': rng.randint(0, 255, (8, 10, 3)).astype(
          np.uint8),
      'features/action/height_to_bottom': np.asarray([0.25 + i],
                                                     np.float32),
      'features/done': np.asarray([float(i % 2)], np.float32),
      'labels/reward': np.asarray([float(i % 3 == 0)], np.float32),
  }


def _blobs(n, seed=0):
  rng = np.random.RandomState(seed)
  return [wire.encode_example(_transition(i, rng)) for i in range(n)]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_encode_example_bytes_equal_jax_and_decode_across(ref, seed):
  entries = _entries(seed)
  got, want = wire.encode_example(entries), ref.wire.encode_example(entries)
  assert got == want
  for blob, decode in ((want, wire.decode_example),
                       (got, ref.wire.decode_example)):
    decoded = decode(blob)
    assert sorted(decoded) == sorted(entries)
    for key, value in entries.items():
      value = np.asarray(value)
      assert decoded[key].dtype == value.dtype, key
      assert decoded[key].shape == value.shape, key
      np.testing.assert_array_equal(decoded[key], value)


@pytest.mark.parametrize('mutate', [
    lambda b: b[:10], lambda b: b'XXXX' + b[4:], lambda b: b + b'\x00',
    lambda b: b[:4] + b'\x07' + b[5:]])
def test_corrupt_records_raise_as_jax(ref, mutate):
  blob = mutate(wire.encode_example(_entries(0)))
  with pytest.raises(wire.ReplayWireError):
    wire.decode_example(blob)
  with pytest.raises(ref.wire.ReplayWireError):
    ref.wire.decode_example(blob)


def _coef_packed_batch(tmp_path, n=6, h=64, w=96):
  """A native-loader ``coef_packed`` batch of the off-policy shape: state
  and next-state JPEG frames, float riders, a varlen and an optional one."""
  rng = np.random.RandomState(7)
  features = {
      'image': TensorSpec((h, w, 3), np.uint8, name='image_1',
                          data_format='jpeg'),
      'next_image': TensorSpec((h, w, 3), np.uint8, name='next/image_1',
                               data_format='jpeg'),
      'close': TensorSpec((1,), np.float32, name='gripper_closed'),
      'tags': TensorSpec((5,), np.float32, name='tags',
                         varlen_default_value=-1.0),
      'aux': TensorSpec((2,), np.float32, name='aux', is_optional=True),
  }
  labels = {'reward': TensorSpec((1,), np.float32, name='grasp_success')}
  records = []
  for i in range(n):
    img = (np.outer(np.linspace(0, 1, h), np.linspace(0, 1, w))[..., None]
           * rng.randint(120, 255, 3)).astype(np.uint8)
    nxt = np.clip(img.astype(np.int16) + 12, 0, 255).astype(np.uint8)
    records.append(build_example({
        'image_1': numpy_to_image_string(img),
        'next/image_1': numpy_to_image_string(nxt),
        'gripper_closed': np.asarray([float(i % 2)], np.float32),
        'tags': rng.rand(3 + i % 4).astype(np.float32),
        'aux': rng.rand(2).astype(np.float32),
        'grasp_success': np.asarray([0.5 * i], np.float32),
    }))
  path = str(tmp_path / 'qtopt.tfrecord')
  tfrecord.write_records(path, records)
  plan = native_loader.plan_for_specs(features, labels,
                                      image_mode='coef_packed')
  assert plan is not None
  stream = native_loader.NativeBatchedStream(
      plan, [path], batch_size=n, num_epochs=1, validate=False)
  try:
    (feats, labs), = list(stream)
  finally:
    stream.close()
  return ({k: np.asarray(v) for k, v in feats.items()},
          {k: np.asarray(v) for k, v in labs.items()})


def test_split_and_assemble_a_coef_packed_batch_equal_jax(ref, tmp_path):
  features, labels = _coef_packed_batch(tmp_path)
  assert wire.packed_group_keys(['features/' + k for k in features])
  got = wire.split_batch(features, labels)
  assert got == ref.wire.split_batch(features, labels)
  rows = [wire.decode_example(blob) for blob in got]
  assembled = wire.assemble_batch(rows)
  want = ref.wire.assemble_batch([ref.wire.decode_example(b) for b in got])
  assert sorted(assembled) == sorted(want)
  for key, value in want.items():
    assert assembled[key].dtype == value.dtype, key
    np.testing.assert_array_equal(assembled[key], value)
  # And the assembled batch is the loader's, byte for byte.
  for side, part in (('features/', features), ('labels/', labels)):
    for key, value in part.items():
      np.testing.assert_array_equal(assembled[side + key], value)


def _drive_store(make, blobs, priorities):
  store = make()
  kept = [store.append(blob, priority=p)
          for blob, p in zip(blobs, priorities)]
  ids, prios = store.snapshot()
  fetched, live = store.get_by_ids(ids[::2] + [10**6])
  landed = store.update_priorities(ids[:3], [5.0, 6.0, 7.0])
  return kept, ids, prios, fetched, live, landed, store.counters()


@pytest.mark.parametrize('retention,capacity_bytes', [
    ('ring', None), ('ring', 9000), ('reservoir', None),
    ('reservoir', 9000)])
def test_stores_equal_jax_under_one_seed(ref, retention, capacity_bytes):
  blobs = _blobs(60)
  priorities = list(np.random.RandomState(3).rand(60))

  def maker(module):
    return lambda: module.ShardStore(capacity_examples=16,
                                     capacity_bytes=capacity_bytes,
                                     retention=retention, seed=5)

  got = _drive_store(maker(store_lib), blobs, priorities)
  want = _drive_store(maker(ref.store), blobs, priorities)
  assert got[0] == want[0] and got[1] == want[1]
  np.testing.assert_array_equal(got[2], want[2])
  assert got[3] == want[3] and got[4:] == want[4:]


@pytest.mark.parametrize('policy,alpha', [('uniform', 0.6),
                                          ('prioritized', 0.6),
                                          ('prioritized', 0.0)])
def test_policies_draw_jax_slots_under_one_seed(ref, policy, alpha):
  priorities = np.random.RandomState(1).rand(40) ** 3
  got = sampling.make_policy(policy, alpha).draw(
      priorities, 64, np.random.RandomState(9))
  want = ref.sampling.make_policy(policy, alpha).draw(
      priorities, 64, np.random.RandomState(9))
  assert got == want
  assert sampling.make_policy(policy, alpha).draw(
      np.zeros(0), 4, np.random.RandomState(0)) == []


@pytest.mark.parametrize('retention,policy', [('ring', 'uniform'),
                                              ('reservoir', 'prioritized')])
def test_seeded_service_samples_jax_ids_and_bytes(ref, retention, policy):
  blobs = _blobs(40)

  def run(module):
    service = module.ReplayService(module.ReplayConfig(
        num_shards=3, batch_size=8, retention=retention, policy=policy,
        capacity_examples_per_shard=10, seed=4))
    shards = [service.append(blob, priority=1.0 + i % 3)
              for i, blob in enumerate(blobs)]
    batches = [service.sample() for _ in range(3)]
    stats = service.stats()
    service.close()
    return shards, batches, stats

  got_shards, got, got_stats = run(service_lib)
  want_shards, want, want_stats = run(ref.service)
  assert got_shards == want_shards
  assert got_stats == want_stats
  for g, w in zip(got, want):
    assert g.record_ids == w.record_ids
    for side in ('features', 'labels'):
      g_side, w_side = getattr(g, side), getattr(w, side)
      assert sorted(g_side) == sorted(w_side)
      for key in w_side:
        assert g_side[key].dtype == w_side[key].dtype
        np.testing.assert_array_equal(g_side[key], w_side[key])


def _serve(module, frontend_module):
  service = module.ReplayService(module.ReplayConfig(
      num_shards=2, batch_size=4, seed=0)).start()
  httpd, port = frontend_module.build_http_server(service)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  return service, httpd, port


@pytest.mark.parametrize('door', ['jax_door_port_client',
                                  'port_door_jax_client'])
def test_http_clients_talk_to_the_other_packages_door(ref, door):
  if door == 'jax_door_port_client':
    service, httpd, port = _serve(ref.service, ref.frontend)
    client = client_lib.ReplayClient('127.0.0.1:{}'.format(port))
    empty = service_lib.ReplayEmpty
  else:
    service, httpd, port = _serve(service_lib, frontend)
    client = ref.client.ReplayClient('127.0.0.1:{}'.format(port))
    empty = ref.service.ReplayEmpty
  try:
    with pytest.raises(empty):
      client.sample(4)
    rng = np.random.RandomState(0)
    records = [_transition(i, rng) for i in range(8)]
    shards = [client.append(record) for record in records]
    assert shards == [0, 1] * 4
    batch = client.sample(4)
    by_tag = {float(r['features/action/height_to_bottom'][0]): r
              for r in records}
    assert len(batch.record_ids) == 4
    for row in range(4):
      tag = float(batch.features['action/height_to_bottom'][row][0])
      for key, value in by_tag[tag].items():
        side, _, rest = key.partition('/')
        got = (batch.features if side == 'features'
               else batch.labels)[rest][row]
        assert got.dtype == value.dtype
        np.testing.assert_array_equal(got, value)
    assert client.update_priorities(batch.record_ids, [2.0] * 4) == 4
    assert client.stats()['occupancy_examples'] == 8
  finally:
    httpd.shutdown()
    service.close()


def test_corrupt_http_append_is_400_and_quarantined():
  service, httpd, port = _serve(service_lib, frontend)
  try:
    client = client_lib.ReplayClient('127.0.0.1:{}'.format(port))
    with pytest.raises(RuntimeError, match='400'):
      client.append(b'T2RX\x01\x05garbage')
    assert service.stats()['corrupt_appends_total'] == 1
  finally:
    httpd.shutdown()
    service.close()


def test_quarantine_exhaustion_names_the_shard():
  service = service_lib.ReplayService(service_lib.ReplayConfig(
      num_shards=2, max_corrupt_appends_per_shard=1, seed=0))
  injector = fault_injection.FaultInjector().fail('replay.append', times=4)
  fault_injection.set_injector(injector)
  blobs = _blobs(4)
  # Round robin: shard 0, 1, 0 (its second: over its budget of 1).
  for blob in blobs[:2]:
    with pytest.raises(wire.ReplayWireError):
      service.append(blob)
  with pytest.raises(CorruptionBudgetExceeded, match='shard0'):
    service.append(blobs[2])
  assert service.occupancy_examples == 0
  stats = service.stats()
  assert stats['shards']['0']['corrupt'] == 2
  assert stats['shards']['1']['corrupt'] == 1
  assert injector.fired_count('replay.append') == 3
  service.close()


def test_admission_sheds_beyond_the_queue_depth():
  service = service_lib.ReplayService(service_lib.ReplayConfig(
      num_shards=1, batch_size=4, seed=0, coalesce_requests=64,
      max_wait_ms=500.0, max_queue_depth=4)).start()
  for blob in _blobs(8):
    service.append(blob)
  futures = [service.submit_sample(4) for _ in range(4)]
  with pytest.raises(RequestRejected):
    for _ in range(64):  # the serve loop may pop a few meanwhile
      service.submit_sample(4)
  assert obs.get_registry().scalars()['replay/rejected'] >= 1
  for future in futures:
    assert future.result(timeout=10).features['done'].shape == (4, 1)
  service.close()


def test_sample_stall_site_sleeps_and_counts(monkeypatch):
  monkeypatch.setattr(fault_injection, 'REPLAY_SAMPLE_STALL_SECONDS', 0.0)
  injector = fault_injection.FaultInjector().fail('replay.sample', times=1)
  fault_injection.set_injector(injector)
  service = service_lib.ReplayService(service_lib.ReplayConfig(
      num_shards=1, batch_size=2, seed=0))
  with pytest.raises(service_lib.ReplayEmpty):
    service.sample()
  for blob in _blobs(4):
    service.append(blob)
  assert service.sample().record_ids
  assert injector.call_count('replay.sample') == 2
  assert injector.fired_count('replay.sample') == 1
  service.close()


def test_retry_backs_off_as_jax_and_counts_each_retry():
  kwargs = dict(base_delay_secs=0.01, backoff=3.0, max_delay_secs=0.05,
                jitter=0.0)
  with jax_qtopt_modules('reliability.retry') as jax_ref:
    want = [jax_ref.retry.RetryPolicy(**kwargs).delay_secs(i)
            for i in range(4)]
  assert [RetryPolicy(**kwargs).delay_secs(i) for i in range(4)] == want
  calls = []

  def flaky():
    calls.append(1)
    if len(calls) < 3:
      raise ConnectionError('transient')
    return 'ok'

  policy = RetryPolicy(max_attempts=3, base_delay_secs=0.0, jitter=0.0)
  assert retry(flaky, policy, site='replay.sample') == 'ok'
  assert len(calls) == 3
  retries = obs.get_registry().counter_family(
      'reliability/io_retries', ('site',)).series('replay.sample')
  assert retries.value == 2
  with pytest.raises(RetryError, match='replay.sample') as raised:
    retry(lambda: (_ for _ in ()).throw(TimeoutError('slow')), policy,
          site='replay.sample')
  assert isinstance(raised.value.last, TimeoutError)
  calls.clear()
  with pytest.raises(ValueError):  # not retryable: raised at once
    retry(lambda: calls.append(1) or int('x'), policy, site='replay.sample')
  assert len(calls) == 1


def test_feed_iterates_and_validates_against_the_specs():
  from tensor2robot_tpu_torch.replay.feed import ReplayInputGenerator

  service = service_lib.ReplayService(service_lib.ReplayConfig(
      num_shards=2, batch_size=4, seed=0))
  for blob in _blobs(8):
    service.append(blob)
  generator = ReplayInputGenerator(service, batch_size=4, prefetch=0)
  generator.set_specification(
      {'state/image': ((8, 10, 3), np.uint8),
       'action/height_to_bottom': ((1,), np.float32)},
      {'reward': ((1,), np.float32)})
  batches = list(generator.create_dataset_iterator('train', num_epochs=2))
  assert len(batches) == 2
  features, labels = batches[0]
  assert sorted(features) == ['action/height_to_bottom', 'state/image']
  assert features['state/image'].shape == (4, 8, 10, 3)
  assert labels['reward'].shape == (4, 1)
  service.close()


def test_selfcheck_entry_point_prints_stats(capsys):
  from tensor2robot_tpu_torch.replay import run_replay

  assert run_replay.main(['--selfcheck', '0.3', '--seed', '0']) == 0
  import json
  stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert stats['occupancy_examples'] > 0
  assert stats['append_examples_per_sec'] > 0
