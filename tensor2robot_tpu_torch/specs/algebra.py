"""The parts of the JAX package's ``specs/algebra.py`` that the record
parser and loader call, over the port's flat ``{key: spec}`` dicts.

A nested dict flattens to '/'-joined keys; a value that is a plain
``(shape, dtype)`` pair counts as an unnamed ``TensorSpec``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.specs.tensor_spec import as_tensor_spec

__all__ = ['add_sequence_length_specs', 'assert_valid_spec_structure',
           'flat_specs', 'flatten_spec_structure', 'is_encoded_image_spec',
           'pad_or_clip_tensor_to_spec_shape', 'validate_and_pack']


def _is_spec(value) -> bool:
  return isinstance(value, TensorSpec) or (
      isinstance(value, tuple) and len(value) == 2 and
      isinstance(value[0], tuple))


def flatten_spec_structure(structure) -> Dict[str, object]:
  """A flat dict of ``structure``'s leaves, nested dicts' keys joined by
  '/'; None is empty."""
  if structure is None:
    return {}
  if not isinstance(structure, Mapping):
    raise ValueError('A spec structure is a dict; got {}.'.format(
        type(structure)))
  flat = {}
  for key, value in structure.items():
    if isinstance(value, Mapping):
      for sub, leaf in flatten_spec_structure(value).items():
        flat['{}/{}'.format(key, sub)] = leaf
    else:
      flat[key] = value
  return flat


def flat_specs(structure) -> Dict[str, TensorSpec]:
  """``flatten_spec_structure`` with every leaf a TensorSpec."""
  flat = flatten_spec_structure(structure)
  for key, value in flat.items():
    if not _is_spec(value):
      raise ValueError('Invalid spec structure: {} -> {} is not a '
                       'TensorSpec.'.format(key, type(value)))
  return {key: as_tensor_spec(value) for key, value in flat.items()}


def assert_valid_spec_structure(structure) -> None:
  """Every leaf is a spec, and specs that share a name are one spec."""
  by_name = {}
  for spec in flat_specs(structure).values():
    if spec.name is None:
      continue
    seen = by_name.get(spec.name)
    if seen is not None and (seen != spec or seen.fields() != spec.fields()):
      raise ValueError('Duplicate spec name {!r} with conflicting '
                       'definitions: {} vs {}.'.format(spec.name, seen, spec))
    by_name[spec.name] = spec


def _validate_leaf(key: str, spec: TensorSpec, value,
                   ignore_batch: bool) -> None:
  shape = tuple(np.shape(value))
  dtype = np.dtype(value.dtype if hasattr(value, 'dtype') else
                   np.asarray(value).dtype)
  if dtype.kind in 'USO':
    dtype = np.dtype(object)   # bytes, however numpy holds them
  if ignore_batch:
    if not shape:
      raise ValueError('Cannot ignore the batch dimension of the scalar '
                       '{!r}.'.format(key))
    shape = shape[1:]
  if spec.is_sequence and len(shape) == len(spec.shape) + 1:
    shape = shape[1:]   # the ragged time axis of a sequence
  if dtype != spec.dtype:
    raise ValueError('Tensor {!r} dtype {} does not match spec {}.'.format(
        key, dtype, spec))
  if len(shape) != len(spec.shape) or any(
      mine is not None and mine != theirs
      for mine, theirs in zip(spec.shape, shape)):
    raise ValueError('Tensor {!r} shape {} does not match spec {} '
                     '(ignore_batch={}).'.format(key, shape, spec,
                                                 ignore_batch))


def validate_and_pack(structure, tensors, ignore_batch: bool = False
                      ) -> Dict[str, object]:
  """``tensors`` for the specs' keys, in their order, each checked against
  its spec; an optional spec's missing tensor is left out, a required
  one's raises."""
  tensors = flatten_spec_structure(tensors)
  out = {}
  for key, spec in flat_specs(structure).items():
    if key not in tensors:
      if spec.is_optional:
        continue
      raise ValueError('Required tensor {!r} missing; available: {}.'.format(
          key, sorted(tensors)))
    _validate_leaf(key, spec, tensors[key], ignore_batch)
    out[key] = tensors[key]
  return out


def add_sequence_length_specs(structure) -> Dict[str, TensorSpec]:
  """The specs with an int64 ``<key>_length`` after every sequence spec."""
  out = {}
  for key, spec in flat_specs(structure).items():
    out[key] = spec
    if spec.is_sequence:
      out[key + '_length'] = TensorSpec(
          (), np.int64,
          name=(spec.name or key.replace('/', '_')) + '_length')
  return out


def pad_or_clip_tensor_to_spec_shape(array: np.ndarray,
                                     spec: TensorSpec) -> np.ndarray:
  """Pads axis 0 with ``varlen_default_value`` (0 when None) or clips it
  to ``spec.shape[0]``."""
  target = spec.shape[0]
  if target is None:
    return array
  array = np.asarray(array)
  length = array.shape[0]
  if length >= target:
    return array[:target]
  pad_value = spec.varlen_default_value
  pad = np.full((target - length,) + array.shape[1:],
                0 if pad_value is None else pad_value, dtype=array.dtype)
  return np.concatenate([array, pad], axis=0)


def is_encoded_image_spec(spec) -> bool:
  return as_tensor_spec(spec).is_encoded_image
