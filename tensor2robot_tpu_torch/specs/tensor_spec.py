"""TensorSpec: a ``(shape, dtype)`` pair that also says how the tensor is
stored on disk (the JAX package's ``specs/tensor_spec.py``).

The port's specifications are flat ``{key: (shape, dtype)}`` dicts, and
every model, generator and server unpacks their values as pairs. A
``TensorSpec`` is such a pair, a 2-tuple, with the JAX spec's extra fields
as attributes, so a caller that unpacks ``shape, dtype = spec`` keeps
working while the data pipeline reads the rest:

  * ``name``: the feature's key in the records (unnamed specs are not
    parsed);
  * ``data_format``: 'jpeg', 'png', ...: the record holds encoded image
    bytes that decode to ``shape`` and ``dtype``;
  * ``dataset_key``: which of several zipped datasets the feature is in;
  * ``is_sequence``: a SequenceExample feature list (a ragged time axis and
    a ``<key>_length`` tensor beside it);
  * ``is_optional``: records may omit it (a batch where some record does
    drops the key);
  * ``varlen_default_value``: the on-disk list may have any length; it is
    padded with this value or clipped to ``shape[0]``.

Two specs compare equal as tuples, by shape and dtype; ``fields()`` tells
specs with other attributes apart. dtypes are numpy's (no bfloat16: numpy
has none without another package).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

__all__ = ['TensorSpec', 'as_tensor_spec']

_ENCODED_IMAGE_FORMATS = ('jpeg', 'jpg', 'png', 'webp', 'bmp')


def _canonical_shape(shape) -> tuple:
  if shape is None:
    return ()
  if isinstance(shape, (int, np.integer)):
    return (int(shape),)
  return tuple(None if d is None or int(d) < 0 else int(d) for d in shape)


class TensorSpec(tuple):
  """``(shape, dtype)`` with the on-disk fields as attributes."""

  def __new__(cls, shape: Union[Sequence[Optional[int]], int, None], dtype,
              name: Optional[str] = None, is_optional: bool = False,
              is_sequence: bool = False, data_format: Optional[str] = None,
              dataset_key: Optional[str] = None,
              varlen_default_value: Optional[float] = None):
    shape = _canonical_shape(shape)
    if varlen_default_value is not None:
      varlen_default_value = float(varlen_default_value)
      if data_format is None and len(shape) != 1:
        raise ValueError('varlen specs require rank-1 shapes (got {}) unless '
                         'they are encoded images.'.format(shape))
      if data_format is not None and len(shape) != 4:
        raise ValueError('varlen image specs require rank-4 shapes (got '
                         '{}).'.format(shape))
    self = super().__new__(cls, (shape, np.dtype(dtype)))
    self.name = name
    self.is_optional = bool(is_optional)
    self.is_sequence = bool(is_sequence)
    self.data_format = data_format
    self.dataset_key = dataset_key or ''
    self.varlen_default_value = varlen_default_value
    return self

  def __reduce__(self):
    return (_rebuild, (self.shape, self.dtype.str, self.fields()))

  @property
  def shape(self) -> tuple:
    return self[0]

  @property
  def dtype(self) -> np.dtype:
    return self[1]

  def fields(self) -> dict:
    """Every attribute but shape and dtype."""
    return {'name': self.name, 'is_optional': self.is_optional,
            'is_sequence': self.is_sequence, 'data_format': self.data_format,
            'dataset_key': self.dataset_key,
            'varlen_default_value': self.varlen_default_value}

  @property
  def is_encoded_image(self) -> bool:
    return (self.data_format is not None and
            self.data_format.lower() in _ENCODED_IMAGE_FORMATS)

  def __repr__(self) -> str:
    fields = ''.join(', {}={!r}'.format(k, v) for k, v in self.fields().items()
                     if v not in (None, False, ''))
    return 'TensorSpec(shape={}, dtype={}{})'.format(self.shape,
                                                     self.dtype.name, fields)


def _rebuild(shape, dtype, fields):
  return TensorSpec(shape, np.dtype(dtype), **fields)


def as_tensor_spec(spec) -> TensorSpec:
  """``spec`` as a TensorSpec: a plain ``(shape, dtype)`` pair becomes an
  unnamed one."""
  if isinstance(spec, TensorSpec):
    return spec
  shape, dtype = spec
  return TensorSpec(shape, dtype)
