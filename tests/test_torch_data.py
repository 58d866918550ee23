"""The port's record path against the JAX package's, on the CPU.

The same records (written by one package, read by the other, or by both)
go through the wire codec, the TFRecord framing, the Python parser, the
native loader and the record input generator of each package. Both sides
decode JPEG with the same library here (OpenCV in the Python parsers,
libjpeg in the native loaders), so every comparison is exact: ints and
decoded uint8 pixels bit-equal, floats equal.
"""

import os

import cv2
import numpy as np
import pytest

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.data import native_loader as jax_native
from tensor2robot_tpu.data import parser as jax_parser
from tensor2robot_tpu.data import pipeline as jax_pipeline
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.data import wire as jax_wire
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.data import native_loader
from tensor2robot_tpu_torch.data import parser
from tensor2robot_tpu_torch.data import pipeline
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec


def _jpeg(rng, h, w, c=3):
  image = rng.randint(0, 256, (h, w, c), dtype=np.uint8)
  ok, encoded = cv2.imencode('.jpg', image if c == 1 else image[..., ::-1])
  assert ok
  return encoded.tobytes()


def _both(rows):
  """(port specs, JAX specs) from rows of (key, shape, dtype, fields)."""
  port = {key: TensorSpec(shape, dtype, **fields)
          for key, shape, dtype, fields in rows}
  ref = SpecStruct()
  for key, shape, dtype, fields in rows:
    ref[key] = jax_specs.TensorSpec(shape, dtype, **fields)
  return port, ref


def _equal(got, want):
  got, want = dict(got), {k: want[k] for k in want}
  assert sorted(got) == sorted(want)
  for key in want:
    g, w = np.asarray(got[key]), np.asarray(want[key])
    assert g.dtype == w.dtype and g.shape == w.shape, key
    np.testing.assert_array_equal(g, w, err_msg=key)


# -- specs -----------------------------------------------------------------


def test_tensor_spec_is_a_pair_with_the_jax_fields():
  spec = TensorSpec((2, 3), np.float32, name='x', is_optional=True,
                    dataset_key='aux')
  shape, dtype = spec
  assert (shape, dtype) == ((2, 3), np.float32) and spec == ((2, 3),
                                                             np.float32)
  ref = jax_specs.TensorSpec((2, 3), np.float32, name='x', is_optional=True,
                             dataset_key='aux')
  for field, value in spec.fields().items():
    assert getattr(ref, field) == value, field
  import pickle
  again = pickle.loads(pickle.dumps(spec))
  assert again == spec and again.fields() == spec.fields()
  with pytest.raises(ValueError, match='rank-1'):
    TensorSpec((2, 3), np.float32, varlen_default_value=0.0)
  with pytest.raises(ValueError, match='conflicting'):
    algebra.assert_valid_spec_structure({
        'a': TensorSpec((1,), np.float32, name='n'),
        'b': TensorSpec((1,), np.float32, name='n', is_optional=True)})


@pytest.mark.parametrize('target', [2, 4, 6])
def test_pad_or_clip_matches_jax(target):
  spec, ref = _both([('v', (target,), np.float32,
                      {'varlen_default_value': -1.0})])
  array = np.arange(4, dtype=np.float32)
  np.testing.assert_array_equal(
      algebra.pad_or_clip_tensor_to_spec_shape(array, spec['v']),
      jax_specs.pad_or_clip_tensor_to_spec_shape(array, ref['v']))


# -- wire format and framing -----------------------------------------------

_FEATURES = {
    'f': np.asarray([1.5, -2.5, 3.0], np.float32),
    'i': np.asarray([7, -9, 1 << 40], np.int64),
    'b': [b'abc', b''],
    's': b'raw',
}


@pytest.mark.parametrize('kind', ['example', 'sequence_example'])
def test_wire_codec_is_byte_equal_to_jax(kind):
  if kind == 'example':
    ours, theirs = wire.build_example(_FEATURES), jax_wire.build_example(
        _FEATURES)
    parsed = [wire.parse_example(theirs), jax_wire.parse_example(ours)]
  else:
    lists = {'obs': [np.asarray([1., 2.], np.float32)] * 3,
             'done': [np.asarray([0], np.int64), np.asarray([1], np.int64)]}
    context = {'ctx': np.asarray([9.], np.float32)}
    ours = wire.build_sequence_example(context, lists)
    theirs = jax_wire.build_sequence_example(context, lists)
    parsed = [wire.parse_sequence_example(theirs),
              jax_wire.parse_sequence_example(ours)]
  assert ours == theirs
  got, want = parsed
  assert repr(got) == repr(want)


@pytest.mark.parametrize('writer,reader', [('port', 'jax'), ('jax', 'port')])
def test_tfrecord_files_are_byte_equal_and_read_both_ways(tmp_path, writer,
                                                          reader):
  records = [b'hello', b'', b'x' * 1000, wire.build_example(_FEATURES)]
  paths = {name: str(tmp_path / (name + '.tfrecord'))
           for name in ('port', 'jax')}
  tfrecord.write_records(paths['port'], records)
  jax_tfrecord.write_records(paths['jax'], records)
  with open(paths['port'], 'rb') as a, open(paths['jax'], 'rb') as b:
    assert a.read() == b.read()
  read = (tfrecord.tfrecord_iterator if reader == 'port'
          else jax_tfrecord.tfrecord_iterator)
  assert list(read(paths[writer], verify_crc=True)) == records


def test_corrupt_records_raise_or_are_skipped_within_budget(tmp_path):
  path = str(tmp_path / 'bad.tfrecord')
  tfrecord.write_records(path, [b'a' * 10, b'b' * 10, b'c' * 10])
  with open(path, 'r+b') as f:   # damage the second record's payload
    f.seek(16 + 10 + 12 + 2)
    f.write(b'Z')
  with pytest.raises(tfrecord.CorruptRecordError, match='data CRC'):
    list(tfrecord.tfrecord_iterator(path, verify_crc=True))
  quarantine = tfrecord.RecordQuarantine(max_corrupt_records=1)
  assert list(tfrecord.tfrecord_iterator(
      path, verify_crc=True, skip_corrupt=True,
      quarantine=quarantine)) == [b'a' * 10, b'c' * 10]
  assert quarantine.records_skipped == 1
  with pytest.raises(tfrecord.CorruptionBudgetExceeded):
    list(tfrecord.tfrecord_iterator(
        path, verify_crc=True, skip_corrupt=True,
        quarantine=tfrecord.RecordQuarantine(max_corrupt_records=0)))


def test_replay_writer_matches_jax(tmp_path):
  spec, ref = _both([('x', (2,), np.float32, {'name': 'x'}),
                     ('im', (8, 8, 3), np.uint8,
                      {'name': 'im', 'data_format': 'jpeg'})])
  image = _jpeg(np.random.RandomState(0), 8, 8)
  paths = [str(tmp_path / 'port.tfrecord'), str(tmp_path / 'jax.tfrecord')]
  with TFRecordReplayWriter() as writer:
    writer.open(paths[0])
    writer.write_numpy(spec, {'x': np.asarray([1., 2.], np.float32),
                              'im': image})
  from tensor2robot_tpu.data.writer import TFRecordReplayWriter as JaxWriter
  with JaxWriter() as writer:
    writer.open(paths[1])
    writer.write_numpy(ref, SpecStruct(x=np.asarray([1., 2.], np.float32),
                                       im=image))
  assert (tfrecord.read_all_records(paths[0]) ==
          jax_tfrecord.read_all_records(paths[1]))


# -- the Python parser -----------------------------------------------------


def _parser_case(name, rng):
  """(feature rows, label rows, records) of one parser case."""
  if name == 'plain':
    features = [('image', (16, 24, 3), np.uint8,
                 {'name': 'state/image', 'data_format': 'jpeg'}),
                ('pose', (2,), np.float32, {'name': 'pose'}),
                ('idx', (2,), np.int64, {'name': 'idx'}),
                ('unnamed', (1,), np.float32, {})]
    labels = [('target', (1,), np.float32, {'name': 'target'})]
    records = [jax_wire.build_example({
        'state/image': _jpeg(rng, 16, 24),
        'pose': rng.rand(2).astype(np.float32),
        'idx': np.asarray([i, -i], np.int64),
        'target': np.asarray([i * .5], np.float32)}) for i in range(4)]
    # The unnamed spec is not parsed: the batch has no tensor for it, and
    # validation names it missing in both packages.
    features = features[:3]
  elif name == 'image_list':
    features = [('frames', (3, 16, 24, 3), np.uint8,
                 {'name': 'ep/frames', 'data_format': 'jpeg'}),
                ('gray', (16, 24, 1), np.uint8,
                 {'name': 'gray', 'data_format': 'jpeg'})]
    labels = []
    records = [jax_wire.build_example({
        'ep/frames': [_jpeg(rng, 16, 24) for _ in range(3)],
        'gray': _jpeg(rng, 16, 24, 1)}) for _ in range(3)]
  elif name == 'varlen':
    features = [('v', (4,), np.float32, {'name': 'v',
                                        'varlen_default_value': 7.0}),
                ('i', (3,), np.int64, {'name': 'i',
                                       'varlen_default_value': -1}),
                ('clips', (3, 16, 24, 3), np.uint8,
                 {'name': 'clips', 'data_format': 'jpeg',
                  'varlen_default_value': 0.0})]
    labels = []
    records = [jax_wire.build_example({
        'v': rng.rand(n).astype(np.float32),
        'i': np.arange(n, dtype=np.int64),
        'clips': [_jpeg(rng, 16, 24) for _ in range(n)]})
               for n in (2, 3, 5, 0)]
  elif name == 'sequence':
    features = [('obs', (2,), np.float32, {'name': 'pose_t',
                                           'is_sequence': True}),
                ('done', (1,), np.int64, {'name': 'done',
                                          'is_sequence': True}),
                ('is_demo', (1,), np.int64, {'name': 'is_demo'})]
    labels = [('reward', (1,), np.float32, {'name': 'reward',
                                            'is_sequence': True})]
    records = []
    for i, t in enumerate((2, 5, 3)):
      records.append(jax_wire.build_sequence_example(
          {'is_demo': np.asarray([i % 2], np.int64)},
          {'pose_t': [rng.randn(2).astype(np.float32) for _ in range(t)],
           'done': [np.asarray([int(s == t - 1)], np.int64)
                    for s in range(t)],
           'reward': [np.asarray([rng.rand()], np.float32)
                      for _ in range(t)]}))
  else:   # 'zip': two datasets, one record of each a row
    features = [('a', (1,), np.float32, {'name': 'a', 'dataset_key': 'd1'}),
                ('im', (16, 24, 3), np.uint8,
                 {'name': 'im', 'data_format': 'jpeg', 'dataset_key': 'd1'}),
                ('b', (2,), np.float32, {'name': 'b', 'dataset_key': 'd2'})]
    labels = []
    records = {
        'd1': [jax_wire.build_example({'a': rng.rand(1).astype(np.float32),
                                       'im': _jpeg(rng, 16, 24)})
               for _ in range(3)],
        'd2': [jax_wire.build_example({'b': rng.rand(2).astype(np.float32)})
               for _ in range(3)]}
  return features, labels, records


@pytest.mark.parametrize('case', ['plain', 'image_list', 'varlen',
                                  'sequence', 'zip'])
def test_example_parser_matches_jax(case):
  feature_rows, label_rows, records = _parser_case(
      case, np.random.RandomState(len(case)))
  features, ref_features = _both(feature_rows)
  labels, ref_labels = _both(label_rows)
  got = parser.ExampleParser(features, labels).parse_batch(records)
  want = jax_parser.ExampleParser(ref_features, ref_labels).parse_batch(
      records)
  for g, w in zip(got, want):
    _equal(g, w)
  if case == 'sequence':
    assert got[0]['obs'].shape == (3, 5, 2)
    np.testing.assert_array_equal(got[0]['obs_length'], [2, 5, 3])


def test_example_parser_raises_as_jax_on_a_missing_feature():
  features, ref = _both([('a', (1,), np.float32, {'name': 'missing'})])
  record = jax_wire.build_example({'a': np.asarray([1.], np.float32)})
  for make in (parser.ExampleParser, jax_parser.ExampleParser):
    with pytest.raises(ValueError, match='missing'):
      make(features if make is parser.ExampleParser else ref).parse_batch(
          [record])


def test_build_example_for_specs_is_byte_equal_to_jax():
  features, ref = _both([
      ('image', (16, 24, 3), np.uint8, {'name': 'image_1',
                                        'data_format': 'jpeg'}),
      ('pose', (2,), np.float32, {'name': 'pose'}),
      ('steps', (2,), np.int64, {'name': 'steps', 'is_sequence': True})])
  rng = np.random.RandomState(3)
  values = {'image': _jpeg(rng, 16, 24),
            'pose': rng.rand(2).astype(np.float32),
            'steps': np.arange(6, dtype=np.int64).reshape(3, 2)}
  assert parser.build_example_for_specs(features, values) == \
      jax_parser.build_example_for_specs(ref, SpecStruct(**values))


# -- the native loader -----------------------------------------------------


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
  """4 files of 8 records: a JPEG frame, floats, ints and a label."""
  directory = tmp_path_factory.mktemp('shards')
  rng = np.random.RandomState(0)
  uid = 0
  for f in range(4):
    records = []
    for _ in range(8):
      records.append(jax_wire.build_example({
          'img/encoded': _jpeg(rng, 24, 32),
          'vec': rng.rand(3).astype(np.float32),
          'uid': np.asarray([uid], np.int64),
          'target': np.asarray([uid * .5], np.float32)}))
      uid += 1
    jax_tfrecord.write_records(str(directory / 'f{}.tfrecord'.format(f)),
                               records)
  return sorted(str(p) for p in directory.glob('*.tfrecord'))


def _shard_specs():
  features, ref_features = _both([
      ('image', (24, 32, 3), np.uint8, {'name': 'img/encoded',
                                        'data_format': 'jpeg'}),
      ('vec', (3,), np.float32, {'name': 'vec'}),
      ('uid', (1,), np.int64, {'name': 'uid'})])
  labels, ref_labels = _both([('target', (1,), np.float32,
                               {'name': 'target'})])
  return features, labels, ref_features, ref_labels


def _stream_batches(module, plan, files, **kwargs):
  stream = module.NativeBatchedStream(plan, files, **kwargs)
  try:
    return list(stream)
  finally:
    stream.close()


@pytest.mark.parametrize('kwargs', [
    dict(batch_size=4, num_epochs=1),
    dict(batch_size=4, num_epochs=2, shuffle=True, seed=7, shuffle_buffer=8,
         num_threads=3),
    dict(batch_size=6, num_epochs=1, shuffle=True, seed=11,
         shuffle_buffer=50, num_threads=4, verify_crc=True),
], ids=['in_order', 'shuffled_two_epochs', 'shuffled_crc'])
def test_native_loader_is_bit_identical_to_jax(shards, kwargs):
  features, labels, ref_features, ref_labels = _shard_specs()
  got = _stream_batches(native_loader,
                        native_loader.plan_for_specs(features, labels),
                        shards, **kwargs)
  want = _stream_batches(jax_native,
                         jax_native.plan_for_specs(ref_features, ref_labels),
                         shards, **kwargs)
  assert len(got) == len(want) == 32 * kwargs['num_epochs'] // kwargs[
      'batch_size']
  for (gf, gl), (wf, wl) in zip(got, want):
    _equal(gf, wf)
    _equal(gl, wl)
  if kwargs.get('shuffle'):   # the order did change
    uids = np.concatenate([f['uid'].ravel() for f, _ in got[:2]])
    assert not np.array_equal(uids, np.arange(len(uids)))


@pytest.mark.parametrize('case', ['image_list', 'varlen', 'sequence', 'zip',
                                  'optional'])
def test_native_loader_matches_jax_on_every_planned_kind(tmp_path, case):
  rng = np.random.RandomState(len(case))
  if case == 'optional':
    feature_rows = [('vec', (3,), np.float32, {'name': 'vec'}),
                    ('opt', (2,), np.float32, {'name': 'opt',
                                               'is_optional': True})]
    label_rows = []
    records = [jax_wire.build_example(
        {'vec': rng.rand(3).astype(np.float32),
         **({'opt': rng.rand(2).astype(np.float32)} if keep else {})})
               for keep in (True, True, True, False, True, True)]
  else:
    feature_rows, label_rows, records = _parser_case(case, rng)
  features, ref_features = _both(feature_rows)
  labels, ref_labels = _both(label_rows)
  if isinstance(records, dict):
    files = {}
    for key, group in records.items():
      files[key] = [str(tmp_path / (key + '.tfrecord'))]
      jax_tfrecord.write_records(files[key][0], group)
  else:
    files = [str(tmp_path / 'data.tfrecord')]
    jax_tfrecord.write_records(files[0], records)
  kwargs = dict(sequence_max_len=8) if case == 'sequence' else {}
  plan = native_loader.plan_for_specs(features, labels, **kwargs)
  ref_plan = jax_native.plan_for_specs(ref_features, ref_labels, **kwargs)
  assert plan is not None and plan.dataset_keys == ref_plan.dataset_keys
  got = _stream_batches(native_loader, plan, files, batch_size=3,
                        num_epochs=1)
  want = _stream_batches(jax_native, ref_plan, files, batch_size=3,
                         num_epochs=1)
  assert len(got) == len(want) > 0
  for (gf, gl), (wf, wl) in zip(got, want):
    _equal(gf, wf)
    _equal(gl, wl)
  if case == 'optional':   # the batch with an omitted record drops 'opt'
    assert 'opt' in got[0][0] and 'opt' not in got[1][0]


@pytest.mark.parametrize('record,match', [
    ({'vec': np.zeros(3, np.float32)}, 'missing'),
    ({'img/encoded': b'not a jpeg', 'vec': np.zeros(3, np.float32),
      'uid': np.zeros(1, np.int64), 'target': np.zeros(1, np.float32)},
     'jpeg'),
    ({'img/encoded': None, 'vec': np.zeros(3, np.float32),
      'uid': np.zeros(1, np.int64), 'target': np.zeros(1, np.float32)},
     'dims'),
], ids=['missing_feature', 'bad_jpeg', 'wrong_dims'])
def test_native_loader_raises_on_bad_records(tmp_path, record, match):
  if record.get('img/encoded', b'') is None:
    record['img/encoded'] = _jpeg(np.random.RandomState(0), 8, 8)
  path = str(tmp_path / 'bad.tfrecord')
  tfrecord.write_records(path, [wire.build_example(record)])
  features, labels, _, _ = _shard_specs()
  with pytest.raises(RuntimeError, match=match):
    _stream_batches(native_loader,
                    native_loader.plan_for_specs(features, labels), [path],
                    batch_size=1, num_epochs=1)


def test_native_plan_leaves_the_python_parsers_specs_and_refuses_coef():
  png, _ = _both([('im', (8, 8, 3), np.uint8, {'name': 'im',
                                               'data_format': 'png'})])
  sequence, _ = _both([('s', (2,), np.float32, {'name': 's',
                                                'is_sequence': True})])
  unnamed, _ = _both([('x', (2,), np.float32, {})])
  for specs in (png, sequence, unnamed):
    assert native_loader.plan_for_specs(specs, {}) is None
  assert native_loader.plan_for_specs(sequence, {},
                                      sequence_max_len=4) is not None
  # An image that the coefficient modes cannot ship (a PNG, a JPEG whose
  # dims are not multiples of 16) is not planned in them, as in JAX.
  odd, ref_odd = _both([('im', (24, 32, 3), np.uint8,
                         {'name': 'im', 'data_format': 'jpeg'})])
  _, ref_png = _both([('im', (8, 8, 3), np.uint8, {'name': 'im',
                                                   'data_format': 'png'})])
  for specs, ref in ((png, ref_png), (odd, ref_odd)):
    for mode in ('coef', 'coef_sparse', 'coef_packed'):
      assert jax_native.plan_for_specs(ref, SpecStruct(),
                                       image_mode=mode) is None
      assert native_loader.plan_for_specs(specs, {}, image_mode=mode) is None
  assert native_loader.plan_for_specs(odd, {}) is not None


@pytest.mark.parametrize('argument', ['source', 'compiler'])
def test_a_loader_that_cannot_build_raises(tmp_path, argument):
  kwargs = {'source': str(tmp_path / 'missing.cc')} if argument == 'source' \
      else {'compiler': str(tmp_path / 'no-such-g++')}
  with pytest.raises(RuntimeError, match='native loader'):
    native_loader.build_native(**kwargs)


def test_the_loader_decodes_with_libjpeg_where_the_host_has_it():
  assert native_loader.jpeg_decoder() == 'libjpeg'
  assert native_loader.decoder() == 'libjpeg'


# -- the record input generator --------------------------------------------


@pytest.mark.parametrize('use_native', [False, True, 'auto'])
@pytest.mark.parametrize('mode', [ModeKeys.TRAIN, ModeKeys.EVAL])
def test_record_generator_matches_jax(shards, use_native, mode):
  features, labels, ref_features, ref_labels = _shard_specs()
  pattern = os.path.join(os.path.dirname(shards[0]), '*.tfrecord')
  generator = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=4, shuffle_buffer_size=16,
      use_native=use_native)
  generator.set_specification(features, labels)
  ref = jax_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=4, shuffle_buffer_size=16,
      use_native=use_native)
  ref.set_specification(ref_features, ref_labels)
  got = list(generator.create_dataset_iterator(mode, num_epochs=1, seed=5))
  want = list(ref.create_dataset_iterator(mode, num_epochs=1, seed=5))
  assert generator.reader == ('python' if use_native is False else 'native')
  assert len(got) == len(want) == 8
  for (gf, gl), (wf, wl) in zip(got, want):
    _equal(gf, wf)
    _equal(gl, wl)


def test_record_generator_shards_files_and_chooses_by_the_rule(shards):
  features, labels, _, _ = _shard_specs()
  pattern = os.path.join(os.path.dirname(shards[0]), '*.tfrecord')
  uids = []
  for shard in range(2):
    generator = input_generators.DefaultRecordInputGenerator(
        file_patterns=pattern, batch_size=8)
    generator.set_specification(features, labels)
    uids.append(sorted(int(u) for f, _ in generator.create_dataset_iterator(
        ModeKeys.EVAL, num_epochs=1, shard_index=shard, num_shards=2)
                       for u in f['uid'].ravel()))
  # Files 0 and 2 to reader 0, files 1 and 3 to reader 1.
  assert uids == [list(range(0, 8)) + list(range(16, 24)),
                  list(range(8, 16)) + list(range(24, 32))]
  skipping = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=8, skip_corrupt_records=True)
  skipping.set_specification(features, labels)
  assert skipping.native_plan() is None   # only the parser skips
  png, _ = _both([('im', (8, 8, 3), np.uint8, {'name': 'im',
                                               'data_format': 'png'})])
  native = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, use_native=True)
  native.set_specification(png, {})
  with pytest.raises(ValueError, match='native loader'):
    native.native_plan()
  with pytest.raises(ValueError, match='Python parser'):
    input_generators.DefaultRecordInputGenerator(
        file_patterns=pattern, use_native=True, skip_corrupt_records=True)


def test_fractional_and_multi_eval_generators_choose_files(shards,
                                                           monkeypatch):
  features, labels, _, _ = _shard_specs()
  pattern = os.path.join(os.path.dirname(shards[0]), '*.tfrecord')
  half = input_generators.FractionalRecordInputGenerator(
      file_fraction=0.5, file_patterns=pattern, batch_size=8)
  half.set_specification(features, labels)
  assert sorted(int(u) for f, _ in half.create_dataset_iterator(
      ModeKeys.EVAL, num_epochs=1) for u in f['uid'].ravel()) == list(
          range(16))
  monkeypatch.setenv('TF_CONFIG', '{"multi_eval_name": "second"}')
  assert input_generators.get_multi_eval_name() == 'second'
  multi = input_generators.MultiEvalRecordInputGenerator(
      eval_map={'first': shards[0], 'second': shards[1]}, batch_size=8)
  multi.set_specification(features, labels)
  (batch, _), = list(multi.create_dataset_iterator(ModeKeys.EVAL,
                                                   num_epochs=1))
  np.testing.assert_array_equal(batch['uid'].ravel(), np.arange(8, 16))
  monkeypatch.setenv('TF_CONFIG', '{"multi_eval_name": "third"}')
  with pytest.raises(ValueError, match='third'):
    input_generators.MultiEvalRecordInputGenerator(eval_map={'first': 'x'})


def test_python_pipeline_matches_jax_with_corrupt_records_skipped(tmp_path):
  features, labels, ref_features, ref_labels = _shard_specs()
  rng = np.random.RandomState(4)
  path = str(tmp_path / 'data.tfrecord')
  records = [jax_wire.build_example({
      'img/encoded': _jpeg(rng, 24, 32), 'vec': rng.rand(3).astype(
          np.float32), 'uid': np.asarray([i], np.int64),
      'target': np.asarray([i], np.float32)}) for i in range(6)]
  tfrecord.write_records(path, records)
  with open(path, 'r+b') as f:   # damage record 1's payload
    f.seek(len(records[0]) + 16 + 12 + 5)
    f.write(b'\x00\x01')
  got = list(pipeline.BatchedExampleStream(
      pipeline.RecordDataset(path, skip_corrupt_records=True),
      parser.ExampleParser(features, labels), batch_size=2, num_epochs=1))
  want = list(jax_pipeline.BatchedExampleStream(
      jax_pipeline.RecordDataset(path, skip_corrupt_records=True),
      jax_parser.ExampleParser(ref_features, ref_labels), batch_size=2,
      num_epochs=1, prefetch=0))
  assert len(got) == len(want) == 2
  for (gf, gl), (wf, wl) in zip(got, want):
    _equal(gf, wf)
    _equal(gl, wl)


@pytest.mark.parametrize('sampling', ['444', '422', '420', '440', 'gray'])
@pytest.mark.parametrize('shape', [(512, 640, 3), (37, 53, 3), (16, 1, 3),
                                   (10, 4, 3), (24, 32, 1)])
def test_the_planes_path_is_libjpegs_decode_bit_for_bit(sampling, shape):
  """The nvJPEG build upsamples and converts the decoded planes itself;
  given libjpeg's planes, that conversion must be libjpeg's to the bit, so
  that only nvJPEG's IDCT can differ from libjpeg on the card."""
  rng = np.random.RandomState(sum(shape))
  h, w, c = shape
  yy, xx = np.mgrid[0:h, 0:w]
  image = np.clip(np.stack([xx * 3, yy * 2, xx + yy], -1) % 256 +
                  rng.randint(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
  if sampling == 'gray':
    ok, encoded = cv2.imencode('.jpg', image[..., 0])
  else:
    factor = getattr(cv2, 'IMWRITE_JPEG_SAMPLING_FACTOR_' + sampling)
    ok, encoded = cv2.imencode('.jpg', image, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
  assert ok
  encoded = encoded.tobytes()
  spec = TensorSpec(shape, np.uint8, name='im', data_format='jpeg')
  np.testing.assert_array_equal(
      native_loader.decode_jpeg_planes(encoded, shape),
      parser.decode_image(encoded, spec))
