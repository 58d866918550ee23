"""The native record loader (the JAX package's ``data/native_loader.py``,
full image decode).

The C++ side (``native/record_loader.cc``, the port's own copy) reads
TFRecords, walks the Example wire format, decodes JPEG frames and
assembles batches on a pool of worker threads, into a ring of
preallocated buffers, outside the GIL. This module:

  * builds the library at first use with ``g++`` into ``_build/`` (a
    directory git ignores; the name carries a hash of the source and the
    flags), choosing its JPEG decoder by what the host has: libjpeg where
    ``jpeglib.h`` is found (the JAX loader's decoder), else NVIDIA's
    nvJPEG from the CUDA toolkit (``$CUDA_HOME/include/nvjpeg.h``),
    which decodes the Y, Cb and Cr planes on the CUDA device that the
    stream is given (``device``; an index the host lacks raises at the
    first batch), upsampled and converted to RGB on the host as libjpeg
    does (so only nvJPEG's IDCT differs from libjpeg's). A host with
    neither, or a failed build, raises; ``decoder()`` names the one built;
  * plans a feature/label spec pair for the loader (``plan_for_specs``):
    fixed-shape float, int and JPEG image specs, sequences given a step
    bound, varlen, optional and zipped datasets, and a frame range of
    [T, ...] specs (a rank's frames of each episode: the loader decodes
    and copies no frame outside it). It returns None where the Python
    parser is needed instead (PNG images, sequences without a bound,
    unnamed or shared names, a frame range of a varlen or sequence spec)
    and in the DCT coefficient modes where an image is not
    coefficient-eligible (``coef_eligible``);
  * ``NativeBatchedStream`` yields ``(features, labels)`` batches, as the
    Python ``BatchedExampleStream`` does.

The coefficient modes are the split decode of the device-side JPEG
decode (``data/jpeg_device.py``): the loader stops after the entropy
(Huffman) stage, with the port's own baseline decoder in both builds (no
card: a plan of coefficient images binds none), and ships each frame's
quantized DCT coefficients as dense planes (``'coef'``: ``key/{y, cb, cr,
qt}``), as the sparse (delta, value) stream (``'coef_sparse'``:
``key/{sd, sv, qt, n}``, bucketed a batch) or as the packed wire
(``'coef_packed'``: ``key/{pw, se, dcn}`` and one ``[1, 3, 64]`` quant
table a batch), each bit for bit the JAX loader's. A progressive JPEG is
refused, naming the field.

Creating a stream checks its configuration only: the reader and worker
threads start at the first ``next()``, where every data error (a missing
file, a corrupt record, an image that does not decode) is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['COEF_MODES', 'DECODERS', 'NativeBatchedStream',
           'NativeLoaderPlan', 'build_native', 'coef_eligible',
           'decode_jpeg_planes', 'decoder', 'jpeg_decoder', 'packed_capacity',
           'packed_dc_count', 'plan_for_specs', 'sparse_capacity',
           'total_coefficients']

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / 'native' / 'record_loader.cc'
BUILD_DIR = _PACKAGE_DIR / '_build'
DECODERS = ('libjpeg', 'nvjpeg')
JPEGLIB_HEADERS = ('/usr/include/jpeglib.h', '/usr/local/include/jpeglib.h',
                    '/usr/include/x86_64-linux-gnu/jpeglib.h')

_BUILD_LOCK = threading.Lock()
_LIB = None

# Field kinds, as record_loader.cc's FieldKind.
_KIND_FLOAT = 0
_KIND_INT = 1
_KIND_IMAGE_FULL = 2
_KIND_IMAGE_COEF = 3
_KIND_IMAGE_COEF_SPARSE = 4
_KIND_IMAGE_COEF_PACKED = 5
_IMAGE_KINDS = (_KIND_IMAGE_FULL, _KIND_IMAGE_COEF, _KIND_IMAGE_COEF_SPARSE,
                _KIND_IMAGE_COEF_PACKED)
# The image modes of a plan and their field kinds.
COEF_MODES = {'coef': _KIND_IMAGE_COEF, 'coef_sparse': _KIND_IMAGE_COEF_SPARSE,
              'coef_packed': _KIND_IMAGE_COEF_PACKED}
# A batch's sparse streams are cut to its largest entry count rounded up to
# this (few distinct shapes for the device's unpack, little padding).
SPARSE_BUCKET = 4096
# The packed wire's buckets: its nibble stream spends about one byte an AC
# nonzero, its escape stream far fewer.
PACKED_BUCKET = 2048
ESCAPE_BUCKET = 256
_INT_SIZES = {np.dtype(np.int64): 8, np.dtype(np.int32): 4,
              np.dtype(np.uint8): 1, np.dtype(np.bool_): 1}


def _cuda_home() -> str:
  return os.environ.get('CUDA_HOME', '/usr/local/cuda')


def jpeg_decoder() -> str:
  """The decoder this host builds with: 'libjpeg' where its header is
  found, else 'nvjpeg' where the CUDA toolkit has nvJPEG; raises if
  neither."""
  if any(os.path.exists(path) for path in JPEGLIB_HEADERS):
    return 'libjpeg'
  if os.path.exists(os.path.join(_cuda_home(), 'include', 'nvjpeg.h')):
    return 'nvjpeg'
  raise RuntimeError(
      'native loader: no JPEG decoder to build with: neither libjpeg '
      '({}) nor nvJPEG ({}/include/nvjpeg.h) is installed.'.format(
          ', '.join(JPEGLIB_HEADERS), _cuda_home()))


def _flags(jpeg: str) -> List[str]:
  flags = ['-O2', '-fPIC', '-shared', '-std=c++17', '-msse4.2']
  if jpeg == 'libjpeg':
    return flags + ['-DT2R_JPEG_LIBJPEG']
  lib = os.path.join(_cuda_home(), 'lib64')
  return flags + ['-DT2R_JPEG_NVJPEG', '-I' + os.path.join(_cuda_home(),
                                                           'include'),
                  '-L' + lib, '-Wl,-rpath,' + lib]


def _libraries(jpeg: str) -> List[str]:
  return (['-ljpeg'] if jpeg == 'libjpeg' else ['-lnvjpeg', '-lcudart']) + [
      '-lpthread']


def build_native(source: Optional[str] = None, compiler: str = 'g++',
                 jpeg: Optional[str] = None) -> str:
  """Compiles the loader (once per source and flags); returns its path.

  ``source``, ``compiler`` and ``jpeg`` (a decoder of ``DECODERS``) are
  for tests; by default the package's source, ``g++`` and
  ``jpeg_decoder()``. A failed build raises ``RuntimeError`` with the
  compiler's output.
  """
  source = Path(source) if source is not None else SOURCE
  jpeg = jpeg or jpeg_decoder()
  if jpeg not in DECODERS:
    raise ValueError('jpeg must be one of {}; got {!r}.'.format(DECODERS,
                                                                 jpeg))
  if not source.exists():
    raise RuntimeError('native loader: no source at {}.'.format(source))
  command_tail = _flags(jpeg) + _libraries(jpeg)
  digest = hashlib.sha256(source.read_bytes())
  digest.update(' '.join([compiler] + command_tail).encode())
  target = BUILD_DIR / 'record_loader-{}-{}.so'.format(
      jpeg, digest.hexdigest()[:16])
  with _BUILD_LOCK:
    if target.exists():
      return str(target)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix('.so.tmp{}'.format(os.getpid()))
    command = ([compiler] + _flags(jpeg) + ['-o', str(tmp), str(source)] +
               _libraries(jpeg))
    try:
      result = subprocess.run(command, capture_output=True, text=True)
    except OSError as e:
      raise RuntimeError('native loader: cannot run {!r}: {}'.format(
          compiler, e)) from e
    if result.returncode != 0:
      raise RuntimeError('native loader build failed ({}):\n{}'.format(
          ' '.join(command), result.stderr))
    os.replace(tmp, target)   # a reader never loads a half-written file
  return str(target)


def _lib():
  global _LIB
  if _LIB is None:
    lib = ctypes.CDLL(build_native())
    lib.t2r_loader_create.restype = ctypes.c_void_p
    lib.t2r_loader_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.t2r_loader_last_error.restype = ctypes.c_char_p
    lib.t2r_loader_last_error.argtypes = [ctypes.c_void_p]
    lib.t2r_loader_num_buffers.restype = ctypes.c_int
    lib.t2r_loader_num_buffers.argtypes = [ctypes.c_void_p]
    lib.t2r_loader_buffer_size.restype = ctypes.c_longlong
    lib.t2r_loader_buffer_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.t2r_loader_buffer_ptr.restype = ctypes.c_void_p
    lib.t2r_loader_buffer_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
    lib.t2r_loader_ring_size.restype = ctypes.c_int
    lib.t2r_loader_ring_size.argtypes = [ctypes.c_void_p]
    lib.t2r_loader_next.restype = ctypes.c_int
    lib.t2r_loader_next.argtypes = [ctypes.c_void_p]
    lib.t2r_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.t2r_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.t2r_loader_stats.restype = ctypes.c_longlong
    lib.t2r_loader_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.c_int]
    lib.t2r_loader_decoder.restype = ctypes.c_char_p
    lib.t2r_loader_decoder.argtypes = []
    lib.t2r_decode_jpeg_planes.restype = ctypes.c_char_p
    lib.t2r_decode_jpeg_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _LIB = lib
  return _LIB


def decoder() -> str:
  """The JPEG decoder of the loaded library (builds it if need be)."""
  return _lib().t2r_loader_decoder().decode()


def decode_jpeg_planes(data: bytes, shape,
                       device: Optional[int] = None) -> np.ndarray:
  """One JPEG as a uint8 ``shape`` (H, W, C) array through the loader's
  planes path: the Y, Cb and Cr planes (nvJPEG's on CUDA ``device`` in the
  nvJPEG build, None being the caller's current device, which stays
  current; libjpeg's raw ones in the libjpeg build, which uses no card)
  upsampled and converted as libjpeg does. In the libjpeg build it must
  equal the loader's decode bit for bit; in the nvJPEG build it is the
  loader's decode."""
  h, w, c = (int(d) for d in shape)
  out = np.empty((h, w, c), np.uint8)
  error = _lib().t2r_decode_jpeg_planes(data, len(data), h, w, c,
                                        _decode_device(device),
                                        out.ctypes.data)
  if error:
    raise RuntimeError('native loader: ' + error.decode('utf-8', 'replace'))
  return out


def _decode_device(device: Optional[int]) -> int:
  """The CUDA device index that nvJPEG decodes on: ``device``, or for None
  the caller's current device; -1 in the libjpeg build, which uses no
  card."""
  if decoder() != 'nvjpeg':
    return -1
  if device is None:
    import torch  # the nvJPEG build runs beside a CUDA PyTorch

    device = torch.cuda.current_device()
  return int(device)


# t2r_loader_stats slot order (record_loader.cc stats_snapshot);
# 'decode_device' is the CUDA device the workers bound for nvJPEG (-1
# before the first batch, and always in the libjpeg build).
STAT_NAMES = ('records_read', 'bytes_read', 'reader_busy_us',
              'reader_wait_us', 'rows_parsed', 'parse_bytes',
              'worker_busy_us', 'worker_idle_us', 'n_workers',
              'completed_batches', 'min_worker_busy_us', 'max_worker_busy_us',
              'decode_device')


class _Field:
  """One parsed field: its configuration line and numpy view."""

  def __init__(self, key: str, spec: TensorSpec, kind: int, dtype_size: int,
               shape: Tuple[int, ...], view_dtype, count: int = 0,
               seq_cap: int = 0, varlen: bool = False,
               optional: bool = False, dsi: int = 0, pad_value: float = 0.0,
               items: Optional[Tuple[int, int]] = None):
    self.key = key            # 'features/<spec key>' or 'labels/...'
    self.spec = spec
    self.kind = kind
    self.dtype_size = dtype_size
    # A row's shape as the batch holds it (a step's, for sequences; the
    # kept frames', under a frame range).
    self.shape = shape
    self.view_dtype = view_dtype
    # Values a row (a step) on disk; an image list's frame count on disk
    # (0: one image).
    self.count = count
    # The items of the on-disk list kept, [lo, hi): frames of an image
    # list, elements of a float or int list. None keeps them all.
    self.items = items
    # > 0: a sequence with this step capacity; rows come back [seq_cap,
    # *shape], zero past the record's steps, with a length per row.
    self.seq_cap = seq_cap
    # The on-disk list is clipped to count or padded with pad_value.
    self.varlen = varlen
    # Records may omit it; a presence flag a row rides along.
    self.optional = optional
    self.dsi = dsi            # which zipped dataset it is read from
    self.pad_value = pad_value
    self.h, self.w, self.c = shape[-3:] if kind in _IMAGE_KINDS else (
        0, 0, 0)

  def config_line(self) -> str:
    name = self.spec.name.encode('utf-8')
    lo, hi = self.items or (0, -1)
    return '{} {} {} {} {} {} {} {} {} {} {} {:.17g} {} {} {}'.format(
        len(name), self.kind, self.dtype_size, self.h, self.w, self.c,
        self.count, self.seq_cap, int(self.varlen), int(self.optional),
        self.dsi, float(self.pad_value), lo, hi, self.spec.name)


class NativeLoaderPlan:
  """The fields of a (feature_spec, label_spec) pair, and the order of
  their datasets: a stream takes one file list per ``dataset_keys`` entry
  (a plain list when the only key is '')."""

  def __init__(self, fields: List[_Field], feature_spec, label_spec,
               dataset_keys: List[str]):
    self.fields = fields
    self.feature_spec = feature_spec
    self.label_spec = label_spec
    self.dataset_keys = list(dataset_keys)


def coef_eligible(spec) -> bool:
  """Whether an image spec can ship as DCT coefficients (the split
  decode): a rank-3 uint8 3-channel JPEG with both dims divisible by 16
  (baseline 4:2:0)."""
  shape = tuple(getattr(spec, 'shape', None) or ())
  return (getattr(spec, 'is_encoded_image', False) and
          spec.data_format.lower() in ('jpeg', 'jpg') and len(shape) == 3 and
          shape[-1] == 3 and spec.dtype == np.uint8 and
          shape[0] % 16 == 0 and shape[1] % 16 == 0)


def total_coefficients(spec) -> int:
  """The DCT coefficients of one 4:2:0 frame (y, cb and cr blocks)."""
  return packed_dc_count(spec) * 64


def sparse_capacity(spec, density: float) -> int:
  """A frame's entry capacity of the sparse stream at ``density`` (a
  fraction of its coefficients), in whole buckets."""
  cap = int(np.ceil(total_coefficients(spec) * density / SPARSE_BUCKET)
            ) * SPARSE_BUCKET
  return max(cap, SPARSE_BUCKET)


def packed_capacity(spec, density: float) -> int:
  """A frame's byte capacity of the packed nibble stream: the sparse
  stream's entry capacity taken as bytes (the packed wire spends fewer; a
  multiple of 8, so that its escape capacity, a quarter of it in int16
  entries, is exact)."""
  return sparse_capacity(spec, density)


def packed_dc_count(spec) -> int:
  """The blocks (DC coefficients) of one 4:2:0 frame; always even."""
  h, w = spec.shape[0], spec.shape[1]
  return (h // 8) * (w // 8) + 2 * (h // 16) * (w // 16)


def plan_for_specs(feature_spec, label_spec, image_mode: str = 'full',
                   sparse_density: float = 0.5,
                   sequence_max_len: Optional[int] = None,
                   frames=None) -> Optional[NativeLoaderPlan]:
  """A plan if the loader reads these specs, else None (see the module's
  note). ``image_mode``: 'full' decodes JPEGs to pixels; 'coef',
  'coef_sparse' and 'coef_packed' ship their DCT coefficients, and plan
  only specs whose every JPEG is ``coef_eligible``, none optional or
  varlen. ``sparse_density``: the sparse and packed streams' capacity a
  frame, as a fraction of its coefficients (a denser frame raises at the
  batch, naming the remedy). ``sequence_max_len`` bounds the steps of
  sequence specs (numeric ones only), without which they are the Python
  parser's. Derived ``<key>_length`` specs are made by the stream, not
  read.

  ``frames`` (an ``input_generators.FrameShard``) keeps frames
  ``[start, stop)`` of the specs it keys, whose first axis is the
  episode's frames: the loader checks each record's whole frame count but
  decodes (or copies) only those frames, and the batches hold
  ``stop - start`` of them. The plan's specs are the cut ones."""
  if image_mode != 'full' and image_mode not in COEF_MODES:
    raise ValueError("image_mode must be 'full' or one of {}; got {!r}."
                     .format(sorted(COEF_MODES), image_mode))
  feature_spec = algebra.flat_specs(feature_spec)
  label_spec = algebra.flat_specs(label_spec)
  frame_keys = () if frames is None else tuple(frames.keys)
  sides = (('features', feature_spec), ('labels', label_spec))
  dataset_keys = sorted({spec.dataset_key for _, specs in sides
                         for spec in specs.values() if spec.name is not None})
  if not dataset_keys:
    return None
  key_to_dsi = {k: i for i, k in enumerate(dataset_keys)}
  fields: List[_Field] = []
  seen_names = set()
  for side, specs in sides:
    for key, spec in specs.items():
      base = key[:-len('_length')]
      if (key.endswith('_length') and base in specs and
          specs[base].is_sequence):
        continue   # made by the stream from the step counts
      if spec.name is None or spec.name in seen_names:
        return None  # the Python parser skips or fans these out
      shape = tuple(spec.shape)
      if any(s is None for s in shape):
        return None
      varlen = spec.varlen_default_value is not None
      common = dict(optional=spec.is_optional,
                    dsi=key_to_dsi[spec.dataset_key])
      full_key = side + '/' + key
      count = int(np.prod(shape)) if shape else 1
      if key in frame_keys:
        if (spec.is_sequence or varlen or not shape or
            frames.stop > shape[0] or
            (spec.is_encoded_image and len(shape) != 4)):
          return None   # the Python parser reads it whole; it is cut after
        per_frame = 1 if spec.is_encoded_image else count // shape[0]
        common['items'] = (frames.start * per_frame, frames.stop * per_frame)
        row_shape = (frames.stop - frames.start,) + shape[1:]
      else:
        row_shape = shape
      if spec.is_sequence:
        if not sequence_max_len or spec.is_encoded_image or varlen:
          return None
        if spec.dtype == np.float32:
          fields.append(_Field(full_key, spec, _KIND_FLOAT, 4, shape,
                               np.float32, count,
                               seq_cap=int(sequence_max_len), **common))
        elif spec.dtype in _INT_SIZES:
          fields.append(_Field(full_key, spec, _KIND_INT,
                               _INT_SIZES[spec.dtype], shape, spec.dtype,
                               count, seq_cap=int(sequence_max_len),
                               **common))
        else:
          return None
      elif spec.is_encoded_image:
        if (spec.data_format.lower() not in ('jpeg', 'jpg') or
            len(shape) not in (3, 4) or spec.dtype != np.uint8 or
            shape[-1] not in (1, 3) or (varlen and len(shape) != 4)):
          return None
        if image_mode != 'full':
          # One frame a record, its coefficients: no frame lists, and no
          # presence or padding on the coefficient buffers.
          if not coef_eligible(spec) or spec.is_optional or varlen:
            return None
          kind = COEF_MODES[image_mode]
          count = (0 if kind == _KIND_IMAGE_COEF else
                   sparse_capacity(spec, sparse_density))
          fields.append(_Field(full_key, spec, kind, 1, shape, np.uint8,
                               count=count, **common))
          seen_names.add(spec.name)
          continue
        # A rank-4 [T, H, W, C] spec is a list of T encoded frames: count
        # carries T, strict unless varlen (clip or pad).
        fields.append(_Field(full_key, spec, _KIND_IMAGE_FULL, 1, row_shape,
                             np.uint8, count=shape[0] if len(shape) == 4
                             else 0, varlen=varlen,
                             pad_value=float(spec.varlen_default_value or 0),
                             **common))
      elif spec.dtype == np.float32 or spec.dtype in _INT_SIZES:
        if varlen and len(shape) != 1:
          return None
        is_float = spec.dtype == np.float32
        fields.append(_Field(
            full_key, spec, _KIND_FLOAT if is_float else _KIND_INT,
            4 if is_float else _INT_SIZES[spec.dtype], row_shape,
            np.float32 if is_float else spec.dtype, count, varlen=varlen,
            pad_value=float(spec.varlen_default_value or 0), **common))
      else:
        return None
      seen_names.add(spec.name)
  if not fields:
    return None
  if frames is not None:
    feature_spec, label_spec = frames.spec(feature_spec), frames.spec(
        label_spec)
  return NativeLoaderPlan(fields,
                          algebra.add_sequence_length_specs(feature_spec),
                          algebra.add_sequence_length_specs(label_spec),
                          dataset_keys)


class NativeBatchedStream:
  """An iterator of ``(features, labels)`` batches from the loader.

  With ``copy=False`` the arrays are views into the loader's ring of
  buffers, valid until the next batch is drawn; by default they are the
  caller's own.
  """

  def __init__(self, plan: NativeLoaderPlan, filenames, batch_size: int,
               shuffle: bool = False, shuffle_buffer: int = 500,
               num_epochs: Optional[int] = None, seed: Optional[int] = None,
               num_threads: Optional[int] = None, ring: int = 3,
               verify_crc: bool = False, copy: bool = True,
               validate: bool = True, device: Optional[int] = None):
    """``filenames``: a list of record paths, or, for a plan that zips
    datasets, a dict of one list per ``plan.dataset_keys`` entry; row r of
    a batch is then made of one record of each (the zip ends with the
    shortest). ``device``: the index of the CUDA device that the nvJPEG
    build decodes pixels on (None: the caller's current device); the
    libjpeg build, and a plan without pixel images, use no card. The
    order of the records is a function of ``seed`` alone, whatever the
    thread count and the frames kept. ``num_threads`` None takes the
    host's cores, up to 16."""
    self._plan = plan
    self._batch_size = int(batch_size)
    self._copy = copy
    self._validate = validate
    self._coef = any(f.kind in COEF_MODES.values() for f in plan.fields)
    self._lib = _lib()
    self.num_threads = num_threads or max(1, min(16, os.cpu_count() or 2))
    if isinstance(filenames, dict):
      missing = [k for k in plan.dataset_keys if k not in filenames]
      if missing:
        raise ValueError('filenames has no files for the dataset keys {} '
                         '(the plan zips {}).'.format(missing,
                                                      plan.dataset_keys))
      groups = [list(filenames[k]) for k in plan.dataset_keys]
    else:
      if len(plan.dataset_keys) > 1:
        raise ValueError('The plan zips datasets {}; pass filenames as a '
                         'dict keyed by dataset key.'.format(
                             plan.dataset_keys))
      groups = [list(filenames)]
    lines = ['batch_size {}'.format(self._batch_size),
             'ring {}'.format(ring), 'threads {}'.format(self.num_threads),
             'device {}'.format(_decode_device(device) if any(
                 f.kind == _KIND_IMAGE_FULL for f in plan.fields) else -1),
             'shuffle {}'.format(int(bool(shuffle))),
             'shuffle_buffer {}'.format(shuffle_buffer),
             'seed {}'.format(-1 if seed is None else seed),
             'epochs {}'.format(-1 if num_epochs is None else num_epochs),
             'verify_crc {}'.format(int(bool(verify_crc)))]
    for group in groups:
      lines.append('group {}'.format(len(group)))
      lines.extend(group)
    lines.append('fields {}'.format(len(plan.fields)))
    lines.extend(f.config_line() for f in plan.fields)
    config = '\n'.join(lines).encode('utf-8')
    self._handle = self._lib.t2r_loader_create(config, len(config))
    if not self._handle:
      raise RuntimeError('native loader creation failed')
    error = self._lib.t2r_loader_last_error(self._handle)
    if error:
      self._lib.t2r_loader_destroy(self._handle)
      self._handle = None
      raise RuntimeError('native loader: ' + error.decode('utf-8',
                                                          'replace'))
    self._layout = self._buffer_layout()
    self._views = self._build_views()
    self._held_slot = -1
    self._closed_stats = None

  def stats(self) -> Dict[str, int]:
    """The loader's cumulative counts (``STAT_NAMES``): zeros (and
    ``decode_device`` -1) before the first batch, those at ``close``
    after it."""
    if not self._handle:
      return dict(self._closed_stats or dict.fromkeys(STAT_NAMES, 0))
    buf = (ctypes.c_longlong * len(STAT_NAMES))()
    n = int(self._lib.t2r_loader_stats(self._handle, buf, len(STAT_NAMES)))
    return {name: int(buf[i]) for i, name in enumerate(STAT_NAMES[:n])}

  def _buffer_layout(self):
    """(field, part) per buffer, in record_loader.cc's order: the values
    (a coefficient field's parts), then a sequence's lengths ('len'), then
    an optional field's presence flags ('p')."""
    layout = []
    for f in self._plan.fields:
      if f.kind == _KIND_IMAGE_COEF:
        layout.extend((f, part) for part in ('y', 'cb', 'cr', 'qt'))
      elif f.kind == _KIND_IMAGE_COEF_SPARSE:
        layout.extend((f, part) for part in ('sd', 'sv', 'qt', 'n'))
      elif f.kind == _KIND_IMAGE_COEF_PACKED:
        layout.extend((f, part) for part in ('pw', 'se', 'dcn', 'qt', 'n',
                                             'ne'))
      else:
        layout.append((f, ''))
      if f.seq_cap > 0:
        layout.append((f, 'len'))
      if f.optional:
        layout.append((f, 'p'))
    return layout

  @staticmethod
  def _part_shape(f: _Field, part: str):
    """(row shape, dtype) of a coefficient field's part."""
    return {'y': ((f.h // 8, f.w // 8, 64), np.int16),
            'cb': ((f.h // 16, f.w // 16, 64), np.int16),
            'cr': ((f.h // 16, f.w // 16, 64), np.int16),
            'qt': ((3, 64), np.uint16),
            'sd': ((f.count,), np.uint8), 'sv': ((f.count,), np.int8),
            'pw': ((f.count,), np.uint8), 'se': ((f.count // 4,), np.int16),
            'dcn': ((packed_dc_count(f.spec) // 2,), np.uint8),
            'n': ((), np.int32), 'ne': ((), np.int32)}[part]

  def _build_views(self):
    n_buffers = self._lib.t2r_loader_num_buffers(self._handle)
    if n_buffers != len(self._layout):
      raise RuntimeError('buffer layout mismatch: {} vs {}'.format(
          n_buffers, len(self._layout)))
    batch = self._batch_size
    views = []
    for slot in range(self._lib.t2r_loader_ring_size(self._handle)):
      slot_views = []
      for index, (f, part) in enumerate(self._layout):
        if part == 'len':
          shape, dtype = (batch,), np.int32
        elif part == 'p':
          shape, dtype = (batch,), np.uint8
        elif part:
          row, dtype = self._part_shape(f, part)
          shape = (batch,) + row
        elif f.seq_cap > 0:
          shape, dtype = (batch, f.seq_cap) + f.shape, f.view_dtype
        else:
          shape, dtype = (batch,) + f.shape, f.view_dtype
        size = self._lib.t2r_loader_buffer_size(self._handle, index)
        if int(np.prod(shape)) * np.dtype(dtype).itemsize != size:
          raise RuntimeError('buffer {} holds {} bytes, not the {} of '
                             '{}'.format(index, size, shape, dtype))
        pointer = self._lib.t2r_loader_buffer_ptr(self._handle, slot, index)
        slot_views.append(np.ctypeslib.as_array(
            ctypes.cast(pointer, ctypes.POINTER(ctypes.c_uint8)),
            shape=(size,)).view(dtype).reshape(shape))
      views.append(slot_views)
    return views

  @staticmethod
  def _bucket(counts: np.ndarray, bucket: int, capacity: int) -> int:
    """The width a batch's stream is cut to: its largest row in whole
    buckets, at most ``capacity``."""
    return min(max(bucket, -(-int(counts.max()) // bucket) * bucket),
               capacity)

  def _pack(self, slot: int):
    views = self._views[slot]
    lengths = {f.key: views[i] for i, (f, part) in enumerate(self._layout)
               if part == 'len'}
    # The sparse and packed streams leave cut to the batch's bucket: the
    # host-to-device copy pays for the entries, not the capacity.
    widths = {}
    for i, (f, part) in enumerate(self._layout):
      if part == 'n':
        bucket = (SPARSE_BUCKET if f.kind == _KIND_IMAGE_COEF_SPARSE else
                  PACKED_BUCKET)
        widths[(f.key, 'sd' if f.kind == _KIND_IMAGE_COEF_SPARSE
                else 'pw')] = self._bucket(views[i], bucket, f.count)
        if f.kind == _KIND_IMAGE_COEF_SPARSE:
          widths[(f.key, 'sv')] = widths[(f.key, 'sd')]
      elif part == 'ne':
        widths[(f.key, 'se')] = self._bucket(views[i], ESCAPE_BUCKET,
                                             f.count // 4)
    # An optional field that some record of the batch omits is dropped
    # from the batch, as the Python parser does.
    dropped = {f.key for i, (f, part) in enumerate(self._layout)
               if part == 'p' and not views[i].all()}
    features, labels = {}, {}
    for i, (f, part) in enumerate(self._layout):
      if part in ('len', 'p') or f.key in dropped:
        continue
      if f.kind == _KIND_IMAGE_COEF_PACKED and part in ('n', 'ne'):
        continue   # the bucketing's alone: padding bytes are no-ops
      array = views[i]
      side, key = f.key.split('/', 1)
      out = features if side == 'features' else labels
      if (f.key, part) in widths:
        # .copy(): a cut as wide as the buffer would still be a view.
        out[key + '/' + part] = array[:, :widths[(f.key, part)]].copy()
      elif part == 'qt' and f.kind == _KIND_IMAGE_COEF_PACKED:
        out[key + '/qt'] = self._hoisted_quant_table(f, array)
      elif part:
        out[key + '/' + part] = array.copy() if self._copy else array
      elif f.seq_cap > 0:
        # The steps up to the batch's longest, as the Python parser pads.
        out[key] = array[:, :max(1, int(lengths[f.key].max()))].copy()
        out[key + '_length'] = lengths[f.key].astype(np.int64)
      else:
        out[key] = array.copy() if self._copy else array
    if self._validate and not self._coef:
      # (Coefficient parts are not the image specs that they stand for.)
      features = algebra.validate_and_pack(self._plan.feature_spec, features,
                                           ignore_batch=True)
      if self._plan.label_spec:
        labels = algebra.validate_and_pack(self._plan.label_spec, labels,
                                           ignore_batch=True)
    return features, labels

  @staticmethod
  def _hoisted_quant_table(f: _Field, qt: np.ndarray) -> np.ndarray:
    """The packed wire's one ``[1, 3, 64]`` quant table a batch. Rows of
    empty payloads (zero tables) are skipped; an all-empty batch ships
    ones. Tables that differ within the batch raise: the packed wire needs
    one quality a batch, and 'coef_sparse' ships a table a frame."""
    flat = qt.reshape(qt.shape[0], -1)
    present = flat.any(axis=1)
    if not present.any():
      return np.ones((1,) + qt.shape[1:], np.uint16)
    first = int(np.argmax(present))
    if not (flat[present] == flat[first]).all():
      raise RuntimeError(
          "native loader: image_coef_packed requires batch-uniform JPEG "
          "quantization tables for '{}' (the packed wire ships ONE table "
          "per batch); this dataset mixes qualities — use "
          "image_mode='coef_sparse' instead.".format(f.key))
    return qt[first:first + 1].copy()

  def __iter__(self):
    while True:
      slot = self._lib.t2r_loader_next(self._handle)
      if slot == -1:
        self._release_held()
        return
      if slot < 0:
        error = self._lib.t2r_loader_last_error(self._handle)
        raise RuntimeError('native loader: ' + (error or b'?').decode(
            'utf-8', 'replace'))
      try:
        batch = self._pack(slot)
      finally:
        if self._copy:
          self._lib.t2r_loader_release(self._handle, slot)
        else:
          # Views: the slot is held until the next batch is drawn.
          self._release_held()
          self._held_slot = slot
      yield batch

  def _release_held(self):
    if self._held_slot >= 0:
      self._lib.t2r_loader_release(self._handle, self._held_slot)
      self._held_slot = -1

  def close(self):
    if self._handle:
      self._closed_stats = self.stats()
      self._lib.t2r_loader_destroy(self._handle)
      self._handle = None

  def __del__(self):
    try:
      self.close()
    except Exception:  # noqa: BLE001 — interpreter teardown
      pass
