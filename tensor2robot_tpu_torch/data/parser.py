"""Spec-driven parsing of serialized Examples into numpy batches (the JAX
package's ``data/parser.py``).

Given feature and label specs, an ``ExampleParser`` decodes serialized
tf.Example or tf.SequenceExample records into spec-conforming numpy:

  * features are read by ``spec.name`` (specs without a name are not
    parsed);
  * JPEG and PNG images decode with OpenCV, else with Pillow (an empty
    string decodes to zeros);
  * fixed lists of images (rank-4 specs) and varlen image lists;
  * varlen specs are padded (with ``varlen_default_value``) or clipped;
  * sequence specs come from the SequenceExample's feature lists, padded
    to the batch's longest with a ``<key>_length`` beside them;
  * several datasets zip: a dict of records keyed by ``dataset_key``;
  * every batch is validated against the specs.

This is the loader's pure-Python path: the native loader
(``native_loader.py``) gives the same batches for the specs it plans, and
this path also takes sequences without a step bound and corrupt-record
skipping. ``build_example_for_specs`` is the inverse, for writers.
"""

from __future__ import annotations

import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['ExampleParser', 'build_example_for_specs', 'decode_image']

_POOL = None
_POOL_LOCK = threading.Lock()


def _decode_pool() -> ThreadPoolExecutor:
  """The decode threads, one a core up to 16 (made at first use)."""
  global _POOL
  with _POOL_LOCK:
    if _POOL is None:
      _POOL = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4),
                                 thread_name_prefix='t2r-torch-decode')
    return _POOL


def decode_image(data: bytes, spec: TensorSpec) -> np.ndarray:
  """One encoded image as ``spec``'s dtype [H, W, C]; empty bytes decode
  to zeros."""
  channels = spec.shape[-1] if len(spec.shape) >= 3 else 3
  height, width = spec.shape[-3], spec.shape[-2]
  if not data:
    return np.zeros((height or 1, width or 1, channels), dtype=spec.dtype)
  try:
    import cv2
  except ImportError:
    from PIL import Image
    image = np.asarray(Image.open(io.BytesIO(data)))
    if image.ndim == 2:
      image = image[..., None]
    return image.astype(spec.dtype, copy=False)
  flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
  if spec.dtype == np.uint16:
    flag |= cv2.IMREAD_ANYDEPTH
  image = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), flag)
  if image is None:
    raise ValueError('cv2 could not decode an image for {!r}.'.format(
        spec.name))
  if channels == 3:
    image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
  elif image.ndim == 2:
    image = image[..., None]
  return image.astype(spec.dtype, copy=False)


def _object_array(values) -> np.ndarray:
  """``values`` as a 1-D object array (np.stack would make fixed-width
  bytes of them and strip trailing NULs)."""
  out = np.empty(len(values), dtype=object)
  out[:] = values
  return out


class ExampleParser:
  """Parses serialized records according to feature and label specs."""

  def __init__(self, feature_spec, label_spec=None):
    self._feature_spec = algebra.flat_specs(feature_spec)
    self._label_spec = algebra.flat_specs(label_spec)
    algebra.assert_valid_spec_structure(self._feature_spec)
    algebra.assert_valid_spec_structure(self._label_spec)
    merged = {**{'features/' + k: v for k, v in self._feature_spec.items()},
              **{'labels/' + k: v for k, v in self._label_spec.items()}}
    self._by_name: Dict[str, TensorSpec] = {
        spec.name: spec for spec in merged.values() if spec.name is not None}
    self._dataset_keys = sorted({s.dataset_key
                                 for s in self._by_name.values()})
    self._has_sequence = any(s.is_sequence for s in self._by_name.values())

  @property
  def dataset_keys(self) -> List[str]:
    return self._dataset_keys

  def _decode_value(self, spec: TensorSpec, kind_values,
                    is_step: bool = False):
    """One Feature's payload as a numpy array of ``spec``."""
    kind, values = kind_values
    shape = spec.shape
    if spec.is_encoded_image:
      if kind != 'bytes':
        raise ValueError('Encoded image {} stored as {}.'.format(spec.name,
                                                                 kind))
      if spec.varlen_default_value is not None:
        images = [decode_image(v, spec) for v in values]
        if not images:
          images = [np.zeros(tuple(s or 1 for s in shape[1:]), spec.dtype)]
        return algebra.pad_or_clip_tensor_to_spec_shape(np.stack(images),
                                                        spec)
      if len(shape) > 3 and not is_step:  # a fixed list of images
        return np.stack([decode_image(v, spec) for v in values])
      return decode_image(values[0], spec)
    if kind == 'bytes':
      if spec.dtype == np.dtype(object):
        out = _object_array(values)
        return out[0] if shape == () else out
      raise ValueError('Spec {} has dtype {} but on-disk bytes.'.format(
          spec.name, spec.dtype))
    array = np.asarray(values).astype(spec.dtype, copy=False)
    if spec.varlen_default_value is not None:
      return algebra.pad_or_clip_tensor_to_spec_shape(array, spec)
    wanted = tuple(s for s in shape if s is not None)
    expected = int(np.prod(wanted)) if wanted else 1
    if array.size != expected and not spec.is_sequence:
      raise ValueError('Feature {!r}: got {} values, spec {} expects '
                       '{}.'.format(spec.name, array.size, spec, expected))
    return array.reshape(tuple(s or 1 for s in shape))

  def parse_single(self, serialized) -> Dict[str, np.ndarray]:
    """One record (or one record a dataset key) as ``{name: array}``."""
    if not isinstance(serialized, dict):
      serialized = {key: serialized for key in self._dataset_keys}
    out: Dict[str, np.ndarray] = {}
    for dataset_key, record in serialized.items():
      names = [n for n, s in self._by_name.items()
               if s.dataset_key == dataset_key]
      if not names:
        continue
      if self._has_sequence:
        context, feature_lists = wire.parse_sequence_example(record)
      else:
        context, feature_lists = wire.parse_example(record), {}
      for name in names:
        spec = self._by_name[name]
        source = feature_lists if spec.is_sequence else context
        if name not in source:
          if spec.is_optional:
            continue
          raise ValueError('Required {}feature {!r} missing from record; '
                           'available: {}.'.format(
                               'sequence ' if spec.is_sequence else '', name,
                               sorted(source)))
        if not spec.is_sequence:
          out[name] = self._decode_value(spec, context[name])
          continue
        steps = [self._decode_value(spec, step, is_step=True)
                 for step in feature_lists[name]]
        if steps and isinstance(steps[0], bytes):
          array = _object_array(steps)
        elif steps:
          array = np.stack(steps)
        else:
          array = np.zeros((0,) + tuple(s or 1 for s in spec.shape),
                           spec.dtype)
        out[name] = array
        out[name + '_length'] = np.asarray(len(steps), dtype=np.int64)
    return out

  def parse_batch(self, serialized_batch, validate: bool = True
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A list of records (or a dict dataset key -> list) as ``(features,
    labels)``; sequences are padded to the batch's longest."""
    if isinstance(serialized_batch, dict):
      keys = list(serialized_batch)
      records = [{k: serialized_batch[k][i] for k in keys}
                 for i in range(len(serialized_batch[keys[0]]))]
    else:
      records = list(serialized_batch)
    # JPEG decode dominates, and OpenCV lets go of the GIL while it runs.
    if len(records) > 1 and any(s.is_encoded_image
                                for s in self._by_name.values()):
      parsed = list(_decode_pool().map(self.parse_single, records))
    else:
      parsed = [self.parse_single(r) for r in records]
    names = set()
    for p in parsed:
      names.update(p)
    batched: Dict[str, np.ndarray] = {}
    for name in names:
      rows = [p[name] for p in parsed if name in p]
      if len(rows) != len(parsed):
        # An optional feature that some record omits is dropped from the
        # whole batch: a batch is dense.
        continue
      if isinstance(rows[0], bytes):
        batched[name] = _object_array(rows)
        continue
      spec = self._by_name.get(name)
      if spec is not None and spec.is_sequence:
        longest = max(r.shape[0] for r in rows)
        pad_value = spec.varlen_default_value or 0
        rows = [np.concatenate([r, np.full(
            (longest - r.shape[0],) + r.shape[1:], pad_value, r.dtype)])
                if r.shape[0] < longest else r for r in rows]
      batched[name] = np.stack(rows)
    features = self._pack_side(self._feature_spec, batched)
    labels = self._pack_side(self._label_spec, batched)
    if validate:
      features = algebra.validate_and_pack(
          algebra.add_sequence_length_specs(self._feature_spec), features,
          ignore_batch=True)
      if self._label_spec:
        labels = algebra.validate_and_pack(
            algebra.add_sequence_length_specs(self._label_spec), labels,
            ignore_batch=True)
    return features, labels

  @staticmethod
  def _pack_side(side_spec, batched_by_name) -> Dict[str, np.ndarray]:
    out = {}
    for key, spec in side_spec.items():
      if spec.name is None or spec.name not in batched_by_name:
        continue
      out[key] = batched_by_name[spec.name]
      if spec.is_sequence and spec.name + '_length' in batched_by_name:
        out[key + '_length'] = batched_by_name[spec.name + '_length']
    return out


def build_example_for_specs(spec_structure, numpy_struct) -> bytes:
  """Spec-conforming numpy (one example, no batch axis) as a serialized
  tf.Example, or a SequenceExample where a spec is a sequence. An encoded
  image spec takes the image's encoded bytes."""
  flat_spec = algebra.flat_specs(spec_structure)
  flat_np = algebra.flatten_spec_structure(numpy_struct)
  context: Dict[str, object] = {}
  feature_lists: Dict[str, List[object]] = {}
  for key, spec in flat_spec.items():
    if spec.name is None or key not in flat_np:
      continue
    value = flat_np[key]
    if spec.is_sequence:
      feature_lists[spec.name] = [np.asarray(step).ravel()
                                  for step in np.asarray(value)]
    elif spec.is_encoded_image or spec.dtype == np.dtype(object):
      if isinstance(value, (bytes, str)):
        value = [value]
      else:
        value = [v if isinstance(v, (bytes, str)) else bytes(v)
                 for v in np.asarray(value, dtype=object).ravel()]
      context[spec.name] = value
    else:
      context[spec.name] = np.asarray(value).ravel()
  if feature_lists:
    return wire.build_sequence_example(context, feature_lists)
  return wire.build_example(context)
