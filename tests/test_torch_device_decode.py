"""The split decode of the port against the JAX package's, on the CPU.

The port's loader decodes the entropy stage with its own baseline Huffman
decoder; the JAX loader reads the coefficients with libjpeg's
``jpeg_read_coefficients``. On the same records, at the same seed and
batch, their 'coef', 'coef_sparse' and 'coef_packed' batches must be equal
bit for bit: frames by cv2 at quality 50, 75 and 95 and by PIL at 95, with
optimized Huffman tables and with restart intervals, at 16x16, 48x64, 64x96
and one 512x640. The refusals and the wire's capacity errors must read as
JAX's; the port alone refuses a progressive JPEG. The device half
(``jpeg_device``): the unpacks bit-exact with JAX's; the finish equal to
JAX's on at least 99.9% of the values, and within 1 level of JAX's own
functions with libjpeg's range limit on the IDCT output (the IDCT sums
float32 products in another order than XLA's einsum). JAX's finish omits
that limit and misses libjpeg by 5 on a critic frame, where the port's is
within 4. The wrapper, the record generator, the feeds and a train step
on coefficients follow.
"""

import io
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.data import jpeg_device as jax_jpeg_device
from tensor2robot_tpu.data import native_loader as jax_native
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.data import wire as jax_wire
from tensor2robot_tpu.preprocessors import device_decode as jax_device_decode
from tensor2robot_tpu.preprocessors.noop_preprocessor import NoOpPreprocessor
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch.data import device_feed
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.data import jpeg_device
from tensor2robot_tpu_torch.data import native_loader
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.preprocessors import device_decode
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

MODES = ('coef', 'coef_sparse', 'coef_packed')

# name -> (encoder, quality, options)
ENCODINGS = {
    'cv2_q50': ('cv2', 50, ()),
    'cv2_q75': ('cv2', 75, ()),
    'cv2_q95': ('cv2', 95, ()),
    'pil_q95': ('PIL', 95, ()),
    'cv2_optimized': ('cv2', 90, ('optimize',)),
    'pil_optimized': ('PIL', 85, ('optimize',)),
    'cv2_restarts': ('cv2', 80, ('restarts',)),
    'cv2_optimized_restarts': ('cv2', 95, ('optimize', 'restarts')),
}
SIZES = ((16, 16), (48, 64), (64, 96))


def _frame(rng, h, w, noise=30):
  """A camera-like RGB frame: ramps and sensor noise."""
  yy, xx = np.mgrid[0:h, 0:w]
  image = np.stack([xx * 3 + yy, yy * 2, (xx + yy) // 2], -1) % 256
  return np.clip(image + rng.randint(-noise, noise + 1, image.shape), 0,
                 255).astype(np.uint8)


def _encode(image, encoding='cv2_q95', **cv2_params):
  encoder, quality, options = ENCODINGS[encoding]
  if encoder == 'cv2':
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if 'optimize' in options:
      params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if 'restarts' in options:
      params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    for key, value in cv2_params.items():
      params += [getattr(cv2, key), value]
    pixels = image if image.ndim == 2 else image[..., ::-1]
    ok, encoded = cv2.imencode('.jpg', pixels, params)
    assert ok
    return encoded.tobytes()
  out = io.BytesIO()
  Image.fromarray(image).save(out, format='JPEG', quality=quality,
                              optimize='optimize' in options)
  return out.getvalue()


def _specs(h, w, name='im'):
  """(port, JAX) feature specs: one JPEG frame and a float."""
  port = {'im': TensorSpec((h, w, 3), np.uint8, name=name,
                           data_format='jpeg'),
          'x': TensorSpec((1,), np.float32, name='x')}
  ref = SpecStruct()
  ref['im'] = jax_specs.TensorSpec((h, w, 3), np.uint8, name=name,
                                   data_format='jpeg')
  ref['x'] = jax_specs.TensorSpec((1,), np.float32, name='x')
  return port, ref


def _write(path, frames, name='im'):
  jax_tfrecord.write_records(path, [
      jax_wire.build_example({name: frame,
                              'x': np.asarray([i], np.float32)})
      for i, frame in enumerate(frames)])
  return [path]


def _batches(module, spec, files, mode, **kwargs):
  """All batches of one stream, or the text of its error."""
  labels = SpecStruct() if module is jax_native else {}
  plan = module.plan_for_specs(spec, labels, image_mode=mode,
                               sparse_density=kwargs.pop('density', 0.5))
  extra = {'validate': False} if module is jax_native else {}
  stream = module.NativeBatchedStream(plan, files, **kwargs, **extra)
  try:
    return [features for features, _ in stream]
  except RuntimeError as e:
    return str(e)
  finally:
    stream.close()


def _assert_batches_equal(got, want):
  assert not isinstance(want, str), want
  assert not isinstance(got, str), got
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for key in w:
      assert g[key].dtype == w[key].dtype, key
      assert g[key].shape == w[key].shape, key
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# -- the Huffman decoder and the wires against libjpeg's -------------------


@pytest.mark.parametrize('size', SIZES, ids=lambda s: '{}x{}'.format(*s))
@pytest.mark.parametrize('encoding', sorted(ENCODINGS))
def test_coefficient_batches_equal_jax_bit_for_bit(tmp_path, encoding, size):
  h, w = size
  rng = np.random.RandomState(len(encoding) + h)
  files = _write(str(tmp_path / 'r.tfrecord'),
                 [_encode(_frame(rng, h, w), encoding) for _ in range(6)])
  port, ref = _specs(h, w)
  for mode in MODES:
    kwargs = dict(batch_size=3, num_epochs=2, shuffle=True, seed=5,
                  num_threads=2)
    _assert_batches_equal(_batches(native_loader, port, files, mode,
                                   **kwargs),
                          _batches(jax_native, ref, files, mode, **kwargs))


@pytest.mark.parametrize('mode', MODES)
def test_a_critic_frame_equals_jax_bit_for_bit(tmp_path, mode):
  rng = np.random.RandomState(7)
  frames = [_encode(_frame(rng, 512, 640, noise=6), 'cv2_q95'),
            _encode(_frame(rng, 512, 640, noise=6), 'cv2_optimized_restarts')]
  files = _write(str(tmp_path / 'r.tfrecord'), frames, name='image_1')
  port, ref = _specs(512, 640, name='image_1')
  kwargs = dict(batch_size=2, num_epochs=1)
  got = _batches(native_loader, port, files, mode, **kwargs)
  _assert_batches_equal(got, _batches(jax_native, ref, files, mode, **kwargs))
  if mode == 'coef_sparse':   # a bucket of the stream, not its capacity
    assert got[0]['im/sd'].shape[1] % native_loader.SPARSE_BUCKET == 0
    assert got[0]['im/sd'].shape[1] < native_loader.sparse_capacity(
        port['im'], 0.5)


def test_empty_frames_give_jax_zeros_and_ones(tmp_path):
  rng = np.random.RandomState(1)
  files = _write(str(tmp_path / 'r.tfrecord'),
                 [b'', _encode(_frame(rng, 48, 64)), b'', b''])
  port, ref = _specs(48, 64)
  for mode in MODES:
    got = _batches(native_loader, port, files, mode, batch_size=2,
                   num_epochs=1)
    _assert_batches_equal(got, _batches(jax_native, ref, files, mode,
                                        batch_size=2, num_epochs=1))
  # The all-empty batch: zero planes and all-ones tables.
  dense = _batches(native_loader, port, files, 'coef', batch_size=2,
                   num_epochs=1)[1]
  assert not dense['im/y'].any() and (dense['im/qt'] == 1).all()


@pytest.mark.parametrize('restarts', [False, True])
def test_a_truncated_scan_decodes_as_libjpeg_does(tmp_path, restarts):
  """libjpeg warns and reads zeros past the data: the MCU that runs out is
  decoded from zero bits and the rest of its restart interval stays 0.
  The port's decoder does the same, bit for bit, wherever the scan is
  cut (its EOI included)."""
  rng = np.random.RandomState(2)
  data = _encode(_frame(rng, 64, 96), 'cv2_restarts' if restarts
                 else 'cv2_q75')
  scan = data.find(b'\xff\xda')
  cuts = list(range(scan + 20, len(data), (len(data) - scan) // 12))
  cuts += [len(data) - 2, len(data) - 1]
  port, ref = _specs(64, 96)
  for i, cut in enumerate(cuts):
    files = _write(str(tmp_path / 'r{}.tfrecord'.format(i)), [data[:cut]])
    for mode in MODES:
      _assert_batches_equal(
          _batches(native_loader, port, files, mode, batch_size=1,
                   num_epochs=1),
          _batches(jax_native, ref, files, mode, batch_size=1,
                   num_epochs=1))


def _refused(kind, rng):
  image = _frame(rng, 48, 64)
  if kind == 'progressive':
    return _encode(image, IMWRITE_JPEG_PROGRESSIVE=1)
  if kind == '444':
    return _encode(image, IMWRITE_JPEG_SAMPLING_FACTOR=(
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444))
  if kind == 'grayscale':
    return _encode(image[..., 0])
  if kind == 'dims':
    return _encode(_frame(rng, 64, 64))
  return b'not a jpeg'


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kind', ['444', 'grayscale', 'dims', 'not_jpeg',
                                  'progressive'])
def test_refusals(tmp_path, kind, mode):
  files = _write(str(tmp_path / 'r.tfrecord'),
                 [_refused(kind, np.random.RandomState(3))])
  port, ref = _specs(48, 64)
  got = _batches(native_loader, port, files, mode, batch_size=1,
                 num_epochs=1)
  want = _batches(jax_native, ref, files, mode, batch_size=1, num_epochs=1)
  assert isinstance(got, str), got
  prefix = 'native loader: image_{}: '.format(mode)
  if kind == 'progressive':
    # libjpeg decodes a progressive JPEG's coefficients; the port's
    # baseline decoder refuses it, naming the field (a deviation).
    assert not isinstance(want, str)
    assert got == prefix + ('progressive JPEG (SOF2) is not decoded by the '
                            "port's baseline decoder: im")
  elif kind == 'not_jpeg':
    assert 'jpeg' in got and 'jpeg' in want
  else:
    assert got == want, (got, want)
    assert got.startswith(prefix)


@pytest.mark.parametrize('mode', ['coef_sparse', 'coef_packed'])
def test_capacity_overflow_raises_as_jax(tmp_path, mode):
  rng = np.random.RandomState(4)
  noise = rng.randint(0, 256, (64, 96, 3), dtype=np.uint8)
  files = _write(str(tmp_path / 'r.tfrecord'), [_encode(noise)])
  port, ref = _specs(64, 96)
  got = _batches(native_loader, port, files, mode, batch_size=1,
                 num_epochs=1, density=0.01)
  want = _batches(jax_native, ref, files, mode, batch_size=1, num_epochs=1,
                  density=0.01)
  assert isinstance(got, str) and got == want
  assert 'capacity' in got and 'raise sparse_density' in got


def test_packed_wire_refuses_mixed_tables_as_jax(tmp_path):
  rng = np.random.RandomState(5)
  files = _write(str(tmp_path / 'r.tfrecord'),
                 [_encode(_frame(rng, 48, 64), 'cv2_q50'),
                  _encode(_frame(rng, 48, 64), 'cv2_q95')])
  port, ref = _specs(48, 64)
  got = _batches(native_loader, port, files, 'coef_packed', batch_size=2,
                 num_epochs=1)
  want = _batches(jax_native, ref, files, 'coef_packed', batch_size=2,
                  num_epochs=1)
  assert isinstance(got, str) and got == want
  assert 'coef_sparse' in got


def test_coefficient_plans_refuse_as_jax():
  bad = [
      ('rank4', (2, 48, 64, 3), {}),
      ('odd', (40, 64, 3), {}),
      ('optional', (48, 64, 3), {'is_optional': True}),
      ('gray', (48, 64, 1), {}),
  ]
  for name, shape, fields in bad:
    port = {'im': TensorSpec(shape, np.uint8, name='im', data_format='jpeg',
                             **fields)}
    ref = SpecStruct()
    ref['im'] = jax_specs.TensorSpec(shape, np.uint8, name='im',
                                     data_format='jpeg', **fields)
    for mode in MODES:
      assert jax_native.plan_for_specs(ref, SpecStruct(),
                                       image_mode=mode) is None, name
      assert native_loader.plan_for_specs(port, {}, image_mode=mode) is None
  port, ref = _specs(48, 64)
  assert native_loader.coef_eligible(port['im'])
  for density in (0.01, 0.5, 1.0):
    assert native_loader.sparse_capacity(port['im'], density) == (
        jax_native.sparse_capacity(ref['im'], density))
    assert native_loader.packed_capacity(port['im'], density) == (
        jax_native.packed_capacity(ref['im'], density))
  assert native_loader.packed_dc_count(port['im']) == (
      jax_native.packed_dc_count(ref['im']))
  assert native_loader.total_coefficients(port['im']) == (
      jax_native.total_coefficients(ref['im']))
  with pytest.raises(ValueError, match='image_mode'):
    native_loader.plan_for_specs(port, {}, image_mode='planes')


# -- the device half ---------------------------------------------------------


@pytest.fixture(scope='module')
def coefficient_batches(tmp_path_factory):
  """One batch of each mode of the same six 64x96 frames, an empty one
  among them (a row with no entries)."""
  rng = np.random.RandomState(6)
  frames = [_encode(_frame(rng, 64, 96), 'cv2_q95') for _ in range(5)]
  files = _write(str(tmp_path_factory.mktemp('coef') / 'r.tfrecord'),
                 frames[:2] + [b''] + frames[2:])
  port, _ = _specs(64, 96)
  return {mode: _batches(native_loader, port, files, mode, batch_size=6,
                         num_epochs=1)[0] for mode in MODES}


def _torch(batch):
  return {key: torch.from_numpy(value) for key, value in batch.items()}


def test_unpacks_are_bit_exact_with_jax(coefficient_batches):
  dense = coefficient_batches['coef']
  sparse = coefficient_batches['coef_sparse']
  packed = coefficient_batches['coef_packed']
  assert not sparse['im/n'][2] and not dense['im/y'][2].any()
  got_sparse = jpeg_device.unpack_sparse_coefficients(
      torch.from_numpy(sparse['im/sd']), torch.from_numpy(sparse['im/sv']),
      64, 96)
  want_sparse = jax_jpeg_device.unpack_sparse_coefficients(
      jnp.asarray(sparse['im/sd']), jnp.asarray(sparse['im/sv']), 64, 96)
  got_packed = jpeg_device.unpack_packed_coefficients(
      *(torch.from_numpy(packed['im/' + k]) for k in ('pw', 'se', 'dcn')),
      64, 96)
  want_packed = jax_jpeg_device.unpack_packed_coefficients(
      *(jnp.asarray(packed['im/' + k]) for k in ('pw', 'se', 'dcn')), 64, 96)
  for got, want in ((got_sparse, want_sparse), (got_packed, want_packed)):
    for g, w, plane in zip(got, want, ('y', 'cb', 'cr')):
      assert g.dtype == torch.int16
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
      np.testing.assert_array_equal(g.numpy(), dense['im/' + plane])


def _jax_range_limited(y, cb, cr, qt, fancy=True):
  """JAX's finish, from its own functions, with libjpeg's range limit on
  each plane's IDCT output."""
  upsample = (jax_jpeg_device._upsample2x_triangle if fancy
              else jax_jpeg_device._upsample2x_nearest)

  def plane(coef, table):
    return jnp.clip(jax_jpeg_device._idct_plane(jnp.asarray(coef),
                                                jnp.asarray(table)), 0, 255)

  luma = plane(y, qt[:, 0])
  cb_c = upsample(plane(cb, qt[:, 1])) - 128.0
  cr_c = upsample(plane(cr, qt[:, 2])) - 128.0
  rgb = jnp.stack([luma + 1.402 * cr_c,
                   luma - 0.344136 * cb_c - 0.714136 * cr_c,
                   luma + 1.772 * cb_c], axis=-1)
  return np.asarray(jnp.clip(jnp.round(rgb), 0.0, 255.0))


def _assert_near_jax(got, planes, jax_finish, fancy=True):
  """Within 1 level of JAX's range-limited finish, and equal to JAX's own
  on at least 99.9% of the values."""
  got = np.asarray(got, np.int32)
  limited = _jax_range_limited(*planes, fancy=fancy).astype(np.int32)
  assert np.abs(got - limited).max() <= 1
  assert (got == limited).mean() >= 0.999
  assert (got == np.asarray(jax_finish, np.int32)).mean() >= 0.999


@pytest.mark.parametrize('fancy', [True, False], ids=['triangle', 'nearest'])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_the_finish_is_within_one_level_of_jax(coefficient_batches, fancy,
                                               dtype):
  dense = coefficient_batches['coef']
  planes = [dense['im/' + k] for k in ('y', 'cb', 'cr', 'qt')]
  got = jpeg_device.decode_jpeg_coefficients(
      *(torch.from_numpy(p) for p in planes), dtype=getattr(torch, dtype),
      fancy_upsample=fancy).numpy()
  want = np.asarray(jax_jpeg_device.decode_jpeg_coefficients(
      *(jnp.asarray(p) for p in planes), dtype=getattr(jnp, dtype),
      fancy_upsample=fancy))
  assert got.shape == want.shape == (6, 64, 96, 3)
  assert got.dtype == want.dtype
  _assert_near_jax(got, planes, want, fancy)


def test_the_range_limit_keeps_a_critic_frame_within_four_of_libjpeg(
    tmp_path):
  """Frame 25 of chip_smoke.py's critic records: a luma sample of 258.9
  leaves [0, 255]. libjpeg limits it; JAX's finish does not, and its blue
  lands 5 levels off libjpeg's (OpenCV's). The port's, limited, is within
  4 of libjpeg on every frame."""
  from unittest import mock

  import chip_smoke
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.data import wire
  from tensor2robot_tpu_torch.research.qtopt import t2r_models

  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu')
  features = model.preprocessor.get_in_feature_specification('train')
  labels = model.preprocessor.get_in_label_specification('train')
  with mock.patch.object(chip_smoke, 'RECORDS', 26), mock.patch.object(
      chip_smoke, 'RECORD_FILES', 1):
    files, _ = chip_smoke.write_critic_records(str(tmp_path), features,
                                               labels, 'cv2')
  stream = native_loader.NativeBatchedStream(
      native_loader.plan_for_specs(features, labels, image_mode='coef'),
      files, batch_size=26, num_epochs=1)
  try:
    batch = next(iter(stream))[0]
  finally:
    stream.close()
  planes = [batch['state/image/' + k] for k in ('y', 'cb', 'cr', 'qt')]
  host = np.stack([cv2.imdecode(np.frombuffer(
      wire.parse_example(record)['image_1'][1][0], np.uint8),
                                cv2.IMREAD_COLOR)[..., ::-1]
                   for record in tfrecord.read_all_records(files[0])])
  got = jpeg_device.decode_jpeg_coefficients(
      *(torch.from_numpy(p) for p in planes)).numpy().astype(int)
  want = np.asarray(jax_jpeg_device.decode_jpeg_coefficients(
      *(jnp.asarray(p) for p in planes))).astype(int)
  assert np.abs(got - host).max() <= 4
  assert np.abs(want - host).max() == 5
  assert np.abs(want - host)[25, 434, 587, 2] == 5
  _assert_near_jax(got, planes, want)


def test_the_finish_is_near_a_host_decode(tmp_path):
  """Within 4 levels of libjpeg's (OpenCV's) pixels, most within 1."""
  rng = np.random.RandomState(8)
  frames = [_encode(_frame(rng, 64, 96, noise=6)) for _ in range(4)]
  files = _write(str(tmp_path / 'r.tfrecord'), frames)
  port, _ = _specs(64, 96)
  batch = _batches(native_loader, port, files, 'coef', batch_size=4,
                   num_epochs=1)[0]
  got = jpeg_device.decode_coef_features(_torch(batch), ['im'])['im']
  want = np.stack([cv2.imdecode(np.frombuffer(f, np.uint8),
                                cv2.IMREAD_COLOR)[..., ::-1] for f in frames])
  diff = np.abs(got.numpy().astype(int) - want.astype(int))
  assert diff.max() <= 4 and (diff <= 1).mean() >= 0.98


# -- the wrapper -------------------------------------------------------------


class _PortNoOp:
  """The port's preprocessor protocol around spec functions, the identity
  (as the JAX NoOpPreprocessor)."""

  def __init__(self, feature_spec_fn, label_spec_fn):
    self._feature_spec_fn = feature_spec_fn
    self._label_spec_fn = label_spec_fn

  def get_in_feature_specification(self, mode):
    return dict(self._feature_spec_fn(mode))

  def get_in_label_specification(self, mode):
    return dict(self._label_spec_fn(mode))

  def preprocess(self, features, labels, mode, **kwargs):
    del mode, kwargs
    return features, labels

  def preprocess_images(self, images, *args, **kwargs):
    del args, kwargs
    return images


def _critic_like_specs(h=64, w=96):
  """(port, JAX) feature specs as the critic's in-specs lay them out: the
  JPEG frame under its on-disk name and an action feature."""
  rows = [('state/image', (h, w, 3), np.uint8,
           {'name': 'image_1', 'data_format': 'jpeg'}),
          ('action/world_vector', (3,), np.float32,
           {'name': 'world_vector'})]
  port = {k: TensorSpec(shape, dtype, **fields)
          for k, shape, dtype, fields in rows}
  ref = SpecStruct()
  for k, shape, dtype, fields in rows:
    ref[k] = jax_specs.TensorSpec(shape, dtype, **fields)
  labels = {'reward': TensorSpec((1,), np.float32, name='grasp_success')}
  ref_labels = SpecStruct()
  ref_labels['reward'] = jax_specs.TensorSpec((1,), np.float32,
                                              name='grasp_success')
  return port, ref, labels, ref_labels


def _wrappers(wire_format, h=64, w=96):
  port, ref, labels, ref_labels = _critic_like_specs(h, w)
  ours = device_decode.DeviceDecodePreprocessor(
      _PortNoOp(lambda mode: port, lambda mode: labels),
      wire_format=wire_format)
  theirs = jax_device_decode.DeviceDecodePreprocessor(
      NoOpPreprocessor(lambda mode: ref, lambda mode: ref_labels),
      wire_format=wire_format)
  return ours, theirs


@pytest.mark.parametrize('wire_format', ['dense', 'sparse', 'packed'])
def test_wrapper_in_specs_equal_jax(wire_format):
  ours, theirs = _wrappers(wire_format, 512, 640)
  got = ours.get_in_feature_specification(ModeKeys.TRAIN)
  want = jax_specs.flatten_spec_structure(
      theirs.get_in_feature_specification(ModeKeys.TRAIN))
  assert sorted(got) == sorted(want)
  for key in want:
    assert tuple(got[key].shape) == tuple(want[key].shape), key
    assert got[key].dtype == np.dtype(want[key].dtype), key
    assert got[key].name == want[key].name, key
  assert ours.image_keys(ModeKeys.TRAIN) == theirs.image_keys(ModeKeys.TRAIN)
  assert ours.image_mode == {'dense': 'coef', 'sparse': 'coef_sparse',
                             'packed': 'coef_packed'}[wire_format]


@pytest.mark.parametrize('shapes', [[(136, 168, 3)],
                                    [(64, 96, 3), (136, 168, 3)]],
                         ids=['none_eligible', 'mixed'])
def test_wrapper_refuses_ineligible_images_as_jax(shapes):
  port, ref = {}, SpecStruct()
  for i, shape in enumerate(shapes):
    name = 'image{}'.format(i)
    port[name] = TensorSpec(shape, np.uint8, name=name, data_format='jpeg')
    ref[name] = jax_specs.TensorSpec(shape, np.uint8, name=name,
                                     data_format='jpeg')
  with pytest.raises(ValueError) as ours:
    device_decode.DeviceDecodePreprocessor(
        _PortNoOp(lambda mode: port, lambda mode: {}), sparse=True)
  with pytest.raises(ValueError) as theirs:
    jax_device_decode.DeviceDecodePreprocessor(
        NoOpPreprocessor(lambda mode: ref, lambda mode: SpecStruct()),
        sparse=True)
  assert str(ours.value) == str(theirs.value)
  with pytest.raises(ValueError, match='wire_format'):
    device_decode.DeviceDecodePreprocessor(
        _PortNoOp(lambda mode: port, lambda mode: {}), wire_format='planes')


@pytest.mark.parametrize('wire_format', ['dense', 'sparse', 'packed'])
def test_wrapper_preprocess_matches_jax(coefficient_batches, wire_format):
  ours, theirs = _wrappers(wire_format)
  mode = {'dense': 'coef', 'sparse': 'coef_sparse',
          'packed': 'coef_packed'}[wire_format]
  batch = {'state/image/' + k.split('/', 1)[1]: v
           for k, v in coefficient_batches[mode].items()
           if k.startswith('im/')}
  batch['action/world_vector'] = np.zeros((6, 3), np.float32)
  got, _ = ours.preprocess(_torch(batch), None, ModeKeys.TRAIN)
  want, _ = theirs.preprocess(SpecStruct(**{k: jnp.asarray(v)
                                            for k, v in batch.items()}),
                              None, ModeKeys.TRAIN)
  assert sorted(got) == sorted(want.keys())
  _assert_near_jax(got['state/image'].numpy(),
                   [coefficient_batches['coef']['im/' + k]
                    for k in ('y', 'cb', 'cr', 'qt')],
                   want['state/image'])


# -- the record generator ----------------------------------------------------


class _Model:
  """What a generator reads of a model: its preprocessor."""

  def __init__(self, preprocessor):
    self.preprocessor = preprocessor


@pytest.fixture(scope='module')
def critic_records(tmp_path_factory):
  directory = tmp_path_factory.mktemp('critic')
  rng = np.random.RandomState(9)
  for f in range(2):
    jax_tfrecord.write_records(str(directory / 'r{}.tfrecord'.format(f)), [
        jax_wire.build_example({
            'image_1': _encode(_frame(rng, 64, 96)),
            'world_vector': rng.rand(3).astype(np.float32),
            'grasp_success': np.asarray([i % 2], np.float32)})
        for i in range(6)])
  return str(directory / 'r*.tfrecord')


@pytest.mark.parametrize('wire_format', ['dense', 'sparse', 'packed'])
def test_record_generator_plans_the_wrappers_mode_as_jax(critic_records,
                                                         wire_format):
  ours, theirs = _wrappers(wire_format)
  got_gen = input_generators.DefaultRecordInputGenerator(
      file_patterns=critic_records, batch_size=4)
  want_gen = jax_generators.DefaultRecordInputGenerator(
      file_patterns=critic_records, batch_size=4)
  got_gen.set_specification_from_model(_Model(ours), ModeKeys.TRAIN)
  want_gen.set_specification_from_model(_Model(theirs), ModeKeys.TRAIN)
  got = got_gen.create_dataset_iterator(ModeKeys.TRAIN, num_epochs=1,
                                        seed=3)
  want = want_gen.create_dataset_iterator(ModeKeys.TRAIN, num_epochs=1,
                                          seed=3)
  pairs = list(zip(got, want))
  assert len(pairs) == 3 and got_gen.reader == 'native'
  for (gf, gl), (wf, wl) in pairs:
    _assert_batches_equal([gf], [dict(wf.items())])
    _assert_batches_equal([gl], [dict(wl.items())])
  # Planning pixels again after plain specs.
  got_gen.set_specification(ours.raw_in_feature_specification('train'),
                            ours.get_in_label_specification('train'))
  assert got_gen.native_plan().fields[0].kind == 2


@pytest.mark.parametrize('case', ['skip_corrupt', 'python_parser', 'zip',
                                  'no_plan'])
def test_record_generator_refuses_as_jax(critic_records, case):
  ours, theirs = _wrappers('sparse')
  kwargs = {'batch_size': 2}
  if case == 'skip_corrupt':
    kwargs['skip_corrupt_records'] = True
  elif case == 'python_parser':
    kwargs['use_native'] = False
  if case == 'zip':
    kwargs['dataset_map'] = {'': critic_records}
  else:
    kwargs['file_patterns'] = critic_records
  if case == 'no_plan':
    # An optional frame: the coefficient modes plan none.
    port, ref, labels, ref_labels = _critic_like_specs()
    port['state/image'] = TensorSpec((64, 96, 3), np.uint8, name='image_1',
                                     data_format='jpeg', is_optional=True)
    ref['state/image'] = jax_specs.TensorSpec(
        (64, 96, 3), np.uint8, name='image_1', data_format='jpeg',
        is_optional=True)
    ours = device_decode.DeviceDecodePreprocessor(
        _PortNoOp(lambda mode: port, lambda mode: labels), sparse=True)
    theirs = jax_device_decode.DeviceDecodePreprocessor(
        NoOpPreprocessor(lambda mode: ref, lambda mode: ref_labels),
        sparse=True)
  errors = []
  for module, wrapper in ((input_generators, ours),
                          (jax_generators, theirs)):
    generator = module.DefaultRecordInputGenerator(**kwargs)
    generator.set_specification_from_model(_Model(wrapper), ModeKeys.TRAIN)
    with pytest.raises(ValueError) as error:
      next(iter(generator.create_dataset_iterator(ModeKeys.TRAIN,
                                                  num_epochs=1)))
    errors.append(str(error.value))
  if case == 'python_parser':
    # (JAX's also names its T2R_NATIVE_LOADER switch, which the port has
    # not.)
    assert errors[1].startswith(errors[0][:-2])
  else:
    assert errors[0] == errors[1]


# -- the feeds ---------------------------------------------------------------


def _feed_batches(coefficient_batches, mode, count):
  batch = coefficient_batches[mode]
  return [({**batch, 'tag': np.full((6,), i, np.int32)},
           {'label': np.full((6, 1), i, np.float32)}) for i in range(count)]


@pytest.mark.parametrize('depth', [1, 3])
def test_pipelined_feed_is_fifo_and_unpacks(coefficient_batches, depth):
  feed = device_feed.SparseCoefFeed({'im': (64, 96)}, 'cpu')
  batches = _feed_batches(coefficient_batches, 'coef_sparse', 7)
  pipelined = device_feed.PipelinedFeed(iter(batches), feed, depth=depth)
  got = list(pipelined)
  assert pipelined.close()
  assert [int(f['tag'][0]) for f, _ in got] == list(range(7))
  assert [float(l['label'][0, 0]) for _, l in got] == list(range(7))
  dense = coefficient_batches['coef']
  for features, _ in got:
    assert 'im/sd' not in features and 'im/n' not in features
    for part in ('y', 'cb', 'cr', 'qt'):
      np.testing.assert_array_equal(features['im/' + part].numpy(),
                                    dense['im/' + part])
  assert feed.transfer_ms() is not None


def test_feed_signature_gauge_stays_one_across_buckets(coefficient_batches):
  feed = device_feed.SparseCoefFeed({'im': (64, 96)}, 'cpu')
  dense = coefficient_batches['coef']
  for mode in ('coef_sparse', 'coef_packed'):
    batch = dict(coefficient_batches[mode])
    # Two buckets of the same wire: the stream cut to its entries, and
    # padded out with no-op entries.
    stream = 'im/sd' if mode == 'coef_sparse' else 'im/pw'
    wider = dict(batch)
    wider[stream] = np.pad(batch[stream], ((0, 0), (0, 4096)))
    if mode == 'coef_sparse':
      wider['im/sv'] = np.pad(batch['im/sv'], ((0, 0), (0, 4096)))
    for one in (batch, wider):
      features, _ = feed.put_batch((one, None))
      # (The packed wire's one table stands in for the empty frame's ones.)
      for part in ('y', 'cb', 'cr') + (('qt',) if stream == 'im/sd' else ()):
        np.testing.assert_array_equal(features['im/' + part].numpy(),
                                      dense['im/' + part])
      assert features['im/qt'].shape == (6, 3, 64)
  assert get_registry().gauge(device_feed.FEED_SHAPES_GAUGE).value == 1
  feed.put_batch(({k: v[:2] for k, v in dense.items()}, None), 'eval')
  assert get_registry().gauge(device_feed.FEED_SHAPES_GAUGE).value == 1


def test_pipelined_feed_raises_the_producers_error():
  def broken():
    yield {'x': np.zeros(2, np.float32)}, None
    raise RuntimeError('the loader failed')

  pipelined = device_feed.PipelinedFeed(broken(), device_feed.HostDeviceFeed(
      'cpu'), depth=2)
  next(pipelined)
  with pytest.raises(RuntimeError, match='the loader failed'):
    next(pipelined)
  pipelined.close()


# -- training on coefficients --------------------------------------------------


def _write_critic_records(directory, count=6):
  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu_torch.research.qtopt import t2r_models

  model = (t2r_models.
           Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
               device='cpu'))
  pre = model.preprocessor
  spec = {**{'f/' + k: v for k, v in
             pre.get_in_feature_specification('train').items()},
          **{'l/' + k: v for k, v in
             pre.get_in_label_specification('train').items()}}
  rng = np.random.RandomState(10)
  os.makedirs(directory, exist_ok=True)
  with TFRecordReplayWriter() as writer:
    writer.open(os.path.join(directory, 'train-00000-of-00001.tfrecord'))
    for _ in range(count):
      example = {k: rng.uniform(-1, 1, shape).astype(dtype)
                 for k, (shape, dtype) in spec.items()
                 if k.startswith('f/action')}
      example['f/state/image'] = _encode(_frame(rng, 512, 640, noise=6))
      example['l/reward'] = np.float32([rng.rand() < 0.5])
      writer.write_numpy(spec, example)
  return os.path.join(directory, 'train-*')


def test_train_eval_trains_the_critic_from_coefficients(tmp_path):
  import json

  from tensor2robot_tpu_torch.trainer import train_eval

  pattern = _write_critic_records(str(tmp_path / 'data'))
  lines = []
  for wire, depth in (('sparse', '1'), ('packed', '2')):
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
      assert train_eval.main([
          '--device', 'cpu', '--num_convs', '1,1,1', '--batch_size', '2',
          '--max_train_steps', '2', '--log_every_n_steps', '1',
          '--model_dir', str(tmp_path / wire), '--train_data', pattern,
          '--device_decode', wire, '--feed_depth', depth]) == 0
    lines.append(json.loads(out.getvalue().strip().splitlines()[-1]))
  for line in lines:
    assert line['data'] == 'native' and line['step'] == 2
    assert np.isfinite(line['metrics']['loss'])
  # The same records, order and frames: the same training.
  assert lines[0]['metrics'] == lines[1]['metrics']
  with pytest.raises(SystemExit):
    train_eval.main(['--device', 'cpu', '--model_dir', str(tmp_path / 'x'),
                     '--device_decode', 'sparse'])
  with pytest.raises(ValueError, match='coef-eligible'):
    train_eval.main(['--device', 'cpu', '--model', 'seq2act',
                     '--model_dir', str(tmp_path / 'y'), '--train_data',
                     pattern, '--device_decode', 'sparse'])


def test_a_step_on_coefficients_equals_the_step_on_its_pixels(tmp_path):
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer import train_eval

  pattern = _write_critic_records(str(tmp_path / 'data'), count=2)

  def critic():
    return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
        device='cpu', network_kwargs={'num_convs': (1, 1, 1)})

  wrapped = device_decode.wrap_model_with_device_decode(critic())
  plain = critic()
  generator = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=2)
  generator.set_specification_from_model(wrapped, ModeKeys.TRAIN)
  batch = next(iter(generator.create_dataset_iterator(ModeKeys.TRAIN,
                                                      seed=0, prefetch=0)))
  assert 'state/image/sd' in batch[0]
  trainer = train_eval.Trainer(wrapped, str(tmp_path / 'wrapped'))
  plain_trainer = train_eval.Trainer(plain, str(tmp_path / 'plain'))
  state = wrapped.create_train_state(torch.Generator().manual_seed(0))
  plain_state = plain.create_train_state(torch.Generator().manual_seed(0))
  coefficients = trainer.feed.put_batch(batch)
  # The finish's frames, fed as pixels to the unwrapped critic.
  pixels = wrapped.preprocessor.decode(coefficients[0], ModeKeys.TRAIN)
  assert pixels['state/image'].dtype == torch.uint8
  got, got_metrics = trainer._step(state, coefficients)
  want, want_metrics = plain_trainer._step(plain_state,
                                           (pixels, coefficients[1]))
  assert got_metrics['loss'].item() == want_metrics['loss'].item()
  for name, value in want.params.items():
    assert torch.equal(got.params[name], value), name
