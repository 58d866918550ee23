"""Protobuf wire format of tf.Example and tf.SequenceExample (a copy of
the JAX package's ``data/wire.py``).

A numpy-first encoder and decoder of the public Example schema
(tensorflow/core/example/{example,feature}.proto):

  Example         { Features features = 1; }
  Features        { map<string, Feature> feature = 1; }
  Feature         { oneof: BytesList=1 | FloatList=2 | Int64List=3 }
  BytesList       { repeated bytes value = 1; }
  FloatList       { repeated float value = 1 [packed]; }
  Int64List       { repeated int64 value = 1 [packed]; }
  SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
  FeatureLists    { map<string, FeatureList> feature_list = 1; }
  FeatureList     { repeated Feature feature = 1; }

No TensorFlow or protobuf package is needed. Packed float lists decode
with ``np.frombuffer`` (views onto the record). The native loader
(``native/record_loader.cc``) walks the same format in C++.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np

# Feature payload: ('bytes', [bytes]) | ('float', f32 array) | ('int64', i64 array)
FeatureValue = Tuple[str, Union[List[bytes], np.ndarray]]

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_BYTES = 2
_WIRE_FIXED32 = 5


# -- varint primitives -------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7
    if shift > 63:
      raise ValueError('Malformed varint')


def write_varint(out: bytearray, value: int) -> None:
  value &= 0xFFFFFFFFFFFFFFFF
  while True:
    bits = value & 0x7F
    value >>= 7
    if value:
      out.append(bits | 0x80)
    else:
      out.append(bits)
      return


def _iter_fields(buf, start: int, end: int):
  """Yields (field_number, wire_type, value). BYTES fields yield (s, e) spans."""
  pos = start
  while pos < end:
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 0x7
    if wire == _WIRE_VARINT:
      value, pos = _read_varint(buf, pos)
    elif wire == _WIRE_BYTES:
      length, pos = _read_varint(buf, pos)
      value = (pos, pos + length)
      pos += length
    elif wire == _WIRE_FIXED32:
      value = (pos, pos + 4)
      pos += 4
    elif wire == _WIRE_FIXED64:
      value = (pos, pos + 8)
      pos += 8
    else:
      raise ValueError('Unsupported wire type {}'.format(wire))
    yield field, wire, value


# -- Feature decode ----------------------------------------------------------

def _decode_varint_list(buf, start: int, end: int) -> np.ndarray:
  values = []
  pos = start
  while pos < end:
    v, pos = _read_varint(buf, pos)
    # Interpret as signed int64 (two's complement).
    if v >= 1 << 63:
      v -= 1 << 64
    values.append(v)
  return np.asarray(values, dtype=np.int64)


def _decode_feature(buf, start: int, end: int) -> FeatureValue:
  kind = None
  payload = None
  for field, wire, value in _iter_fields(buf, start, end):
    s, e = value
    if field == 1:  # BytesList
      items = []
      for f2, _, v2 in _iter_fields(buf, s, e):
        if f2 == 1:
          items.append(bytes(buf[v2[0]:v2[1]]))
      kind, payload = 'bytes', items
    elif field == 2:  # FloatList
      if wire == _WIRE_BYTES:
        chunks = []
        floats = None
        for f2, w2, v2 in _iter_fields(buf, s, e):
          if f2 == 1 and w2 == _WIRE_BYTES:  # packed
            chunks.append(np.frombuffer(buf, dtype='<f4', count=(v2[1] - v2[0]) // 4, offset=v2[0]))
          elif f2 == 1 and w2 == _WIRE_FIXED32:  # unpacked
            chunks.append(np.frombuffer(buf, dtype='<f4', count=1, offset=v2[0]))
        floats = np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
        kind, payload = 'float', floats
    elif field == 3:  # Int64List
      chunks = []
      for f2, w2, v2 in _iter_fields(buf, s, e):
        if f2 == 1 and w2 == _WIRE_BYTES:  # packed varints
          chunks.append(_decode_varint_list(buf, v2[0], v2[1]))
        elif f2 == 1 and w2 == _WIRE_VARINT:  # unpacked
          v = v2 if isinstance(v2, int) else 0
          if v >= 1 << 63:
            v -= 1 << 64
          chunks.append(np.asarray([v], dtype=np.int64))
      ints = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
      kind, payload = 'int64', ints
  if kind is None:
    return 'bytes', []
  return kind, payload


def _decode_features_message(buf, start: int, end: int) -> Dict[str, FeatureValue]:
  """Decodes a Features message (map<string, Feature>)."""
  out = {}
  for field, _, value in _iter_fields(buf, start, end):
    if field != 1:
      continue
    s, e = value
    key = None
    feat = None
    for f2, _, v2 in _iter_fields(buf, s, e):
      if f2 == 1:
        key = bytes(buf[v2[0]:v2[1]]).decode('utf-8')
      elif f2 == 2:
        feat = v2
    if key is not None and feat is not None:
      out[key] = _decode_feature(buf, feat[0], feat[1])
  return out


def parse_example(serialized: bytes) -> Dict[str, FeatureValue]:
  """Decodes a tf.Example into {feature_name: (kind, values)}."""
  buf = memoryview(serialized)
  for field, _, value in _iter_fields(buf, 0, len(buf)):
    if field == 1:
      return _decode_features_message(buf, value[0], value[1])
  return {}


def parse_sequence_example(serialized: bytes):
  """Decodes a tf.SequenceExample.

  Returns:
    (context, feature_lists): context is {name: (kind, values)};
    feature_lists is {name: [(kind, values), ...]} one entry per step.
  """
  buf = memoryview(serialized)
  context: Dict[str, FeatureValue] = {}
  feature_lists: Dict[str, List[FeatureValue]] = {}
  for field, _, value in _iter_fields(buf, 0, len(buf)):
    if field == 1:
      context = _decode_features_message(buf, value[0], value[1])
    elif field == 2:
      s, e = value
      for f2, _, v2 in _iter_fields(buf, s, e):
        if f2 != 1:
          continue
        ks, ke = v2
        key = None
        steps: List[FeatureValue] = []
        for f3, _, v3 in _iter_fields(buf, ks, ke):
          if f3 == 1:
            key = bytes(buf[v3[0]:v3[1]]).decode('utf-8')
          elif f3 == 2:  # FeatureList
            for f4, _, v4 in _iter_fields(buf, v3[0], v3[1]):
              if f4 == 1:
                steps.append(_decode_feature(buf, v4[0], v4[1]))
        if key is not None:
          feature_lists[key] = steps
  return context, feature_lists


# -- encode ------------------------------------------------------------------

def _emit_bytes_field(out: bytearray, field: int, data: bytes) -> None:
  write_varint(out, (field << 3) | _WIRE_BYTES)
  write_varint(out, len(data))
  out.extend(data)


def encode_feature(value) -> bytes:
  """Encodes one Feature from numpy array / bytes / str / list thereof."""
  out = bytearray()
  if isinstance(value, (bytes, str)):
    value = [value]
  if isinstance(value, (list, tuple)) and value and isinstance(value[0], (bytes, str)):
    inner = bytearray()
    for item in value:
      if isinstance(item, str):
        item = item.encode('utf-8')
      _emit_bytes_field(inner, 1, item)
    _emit_bytes_field(out, 1, bytes(inner))
    return bytes(out)
  if isinstance(value, (list, tuple)) and not value:
    _emit_bytes_field(out, 1, b'')  # empty BytesList
    return bytes(out)
  arr = np.asarray(value)
  if arr.dtype.kind == 'f':
    data = arr.astype('<f4').ravel().tobytes()
    inner = bytearray()
    _emit_bytes_field(inner, 1, data)  # packed floats
    _emit_bytes_field(out, 2, bytes(inner))
  elif arr.dtype.kind in 'uib':
    inner = bytearray()
    packed = bytearray()
    for v in arr.ravel().tolist():
      write_varint(packed, int(v))
    _emit_bytes_field(inner, 1, bytes(packed))
    _emit_bytes_field(out, 3, bytes(inner))
  else:
    raise ValueError('Cannot encode feature of dtype {}'.format(arr.dtype))
  return bytes(out)


def _encode_features(features: Dict[str, object]) -> bytes:
  out = bytearray()
  for name, value in features.items():
    entry = bytearray()
    _emit_bytes_field(entry, 1, name.encode('utf-8'))
    _emit_bytes_field(entry, 2, encode_feature(value))
    _emit_bytes_field(out, 1, bytes(entry))
  return bytes(out)


def build_example(features: Dict[str, object]) -> bytes:
  """Encodes {name: array|bytes|list} into a serialized tf.Example."""
  out = bytearray()
  _emit_bytes_field(out, 1, _encode_features(features))
  return bytes(out)


def build_sequence_example(context: Dict[str, object],
                           feature_lists: Dict[str, List[object]]) -> bytes:
  """Encodes a serialized tf.SequenceExample.

  ``feature_lists`` maps name -> list of per-step values.
  """
  out = bytearray()
  if context:
    _emit_bytes_field(out, 1, _encode_features(context))
  lists = bytearray()
  for name, steps in feature_lists.items():
    entry = bytearray()
    _emit_bytes_field(entry, 1, name.encode('utf-8'))
    fl = bytearray()
    for step in steps:
      _emit_bytes_field(fl, 1, encode_feature(step))
    _emit_bytes_field(entry, 2, bytes(fl))
    _emit_bytes_field(lists, 1, bytes(entry))
  _emit_bytes_field(out, 2, bytes(lists))
  return bytes(out)
