"""DeviceDecodePreprocessor: train straight from JPEG DCT coefficients.

The counterpart of the JAX package's ``preprocessors/device_decode.py``,
the trainable half of the split decode. Wrapping a model's preprocessor::

    wrap_model_with_device_decode(model, wire_format='sparse')

changes its in-specifications so that the input pipeline ships each
eligible JPEG's quantized DCT coefficients instead of its pixels (the
native loader's coefficient modes: the entropy stage only, on the host),
and finishes the decode (``data/jpeg_device.py``: dequantize, IDCT,
chroma upsample, YCbCr -> RGB) on the model's device inside ``preprocess``,
before the wrapped preprocessor runs. ``DefaultRecordInputGenerator``
recognizes the wrapper and plans the loader in its mode; the trainer's
feed (``data/device_feed.py``) unpacks the sparse and packed wires to the
dense planes as it ships them.

Eligible image specs: rank-3 uint8 3-channel JPEGs with both dims
divisible by 16 (baseline 4:2:0); the wrapper refuses a model with any
other encoded image. Other specs pass through.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data import jpeg_device
from tensor2robot_tpu_torch.data.native_loader import coef_eligible
from tensor2robot_tpu_torch.data.native_loader import packed_dc_count
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['WIRE_FORMATS', 'DeviceDecodePreprocessor', 'coef_specs',
           'packed_coef_specs', 'sparse_coef_specs',
           'wrap_model_with_device_decode']

# The wires and the loader's image mode of each.
WIRE_FORMATS = {'dense': 'coef', 'sparse': 'coef_sparse',
                'packed': 'coef_packed'}


def coef_specs(key: str, spec: TensorSpec) -> Dict[str, TensorSpec]:
  """The four coefficient tensors that stand for one image spec."""
  h, w, _ = spec.shape
  name = spec.name or key
  return {key + '/y': TensorSpec((h // 8, w // 8, 64), np.int16,
                                 name=name + '/y'),
          key + '/cb': TensorSpec((h // 16, w // 16, 64), np.int16,
                                  name=name + '/cb'),
          key + '/cr': TensorSpec((h // 16, w // 16, 64), np.int16,
                                  name=name + '/cr'),
          key + '/qt': TensorSpec((3, 64), np.uint16, name=name + '/qt')}


def sparse_coef_specs(key: str, spec: TensorSpec) -> Dict[str, TensorSpec]:
  """The four sparse-stream tensors that stand for one image spec. The
  entries' dim is the batch's bucket (None); the feed unpacks them to the
  fixed-shape planes before the step."""
  name = spec.name or key
  return {key + '/sd': TensorSpec((None,), np.uint8, name=name + '/sd'),
          key + '/sv': TensorSpec((None,), np.int8, name=name + '/sv'),
          key + '/qt': TensorSpec((3, 64), np.uint16, name=name + '/qt'),
          key + '/n': TensorSpec((), np.int32, name=name + '/n')}


def packed_coef_specs(key: str, spec: TensorSpec) -> Dict[str, TensorSpec]:
  """The four packed-wire tensors that stand for one image spec: the
  nibble and escape streams bucketed a batch (None), the DC-delta plane
  fixed (a nibble a block), and the quant table one a batch ([1, 3, 64]),
  which the feed's unpack broadcasts back."""
  name = spec.name or key
  return {key + '/pw': TensorSpec((None,), np.uint8, name=name + '/pw'),
          key + '/se': TensorSpec((None,), np.int16, name=name + '/se'),
          key + '/dcn': TensorSpec((packed_dc_count(spec) // 2,), np.uint8,
                                   name=name + '/dcn'),
          key + '/qt': TensorSpec((3, 64), np.uint16, name=name + '/qt')}


def wrap_model_with_device_decode(model=None, sparse: bool = True,
                                  sparse_density: float = 0.5,
                                  wire_format: Optional[str] = None):
  """Switches ``model`` to the split decode (``train_qtopt_sparse.gin``'s
  wrapper): its preprocessor is wrapped in a ``DeviceDecodePreprocessor``
  of ``wire_format`` ('dense', 'sparse' or 'packed'; without it,
  ``sparse`` chooses 'sparse' or 'dense'). Returns the model."""
  if model is None:
    raise ValueError('wrap_model_with_device_decode requires a model.')
  model.set_preprocessor(
      DeviceDecodePreprocessor(model.preprocessor, sparse=sparse,
                               sparse_density=sparse_density,
                               wire_format=wire_format))
  return model


class DeviceDecodePreprocessor:
  """Wraps a preprocessor to take coefficient inputs (see the module's
  note).

  ``wire_format`` 'dense' ships the planes (``key/{y, cb, cr, qt}``),
  'sparse' the (delta, value) stream (``key/{sd, sv, qt, n}``), 'packed'
  the packed wire (``key/{pw, se, dcn}`` and one ``key/qt`` a batch);
  ``sparse_density`` is the streams' capacity a frame, as a fraction of
  its coefficients (the loader raises on a denser frame). ``preprocess``
  takes the planes, or the sparse and packed streams as the loader gives
  them (unpacked here), finishes the decode on their device and hands
  the frames to the wrapped preprocessor.
  """

  def __init__(self, inner, sparse: bool = False,
               sparse_density: float = 0.5,
               wire_format: Optional[str] = None):
    self._inner = inner
    if wire_format is None:
      wire_format = 'sparse' if sparse else 'dense'
    if wire_format not in WIRE_FORMATS:
      raise ValueError(
          "wire_format must be 'dense', 'sparse' or 'packed'; got {!r}."
          .format(wire_format))
    self.wire_format = wire_format
    self.sparse_density = float(sparse_density)
    if not self.image_keys(ModeKeys.TRAIN):
      raise ValueError(
          'DeviceDecodePreprocessor: the wrapped preprocessor declares no '
          'coef-eligible image specs (rank-3 uint8 JPEG, dims % 16 == 0).')
    # Refused at wrap time, naming the images: a plan with any other
    # encoded image would fail late, at the first batch.
    spec = algebra.flat_specs(inner.get_in_feature_specification(
        ModeKeys.TRAIN))
    ineligible = [key for key, value in spec.items()
                  if value.is_encoded_image and not coef_eligible(value)]
    if ineligible:
      raise ValueError(
          'DeviceDecodePreprocessor: encoded-image specs {} are not '
          'coef-eligible (need rank-3 uint8 3-channel JPEG with dims '
          'divisible by 16); split decode requires ALL images eligible.'
          .format(ineligible))

  @property
  def inner(self):
    return self._inner

  @property
  def image_mode(self) -> str:
    """The loader's image mode of the wire."""
    return WIRE_FORMATS[self.wire_format]

  def image_keys(self, mode: str) -> List[str]:
    spec = algebra.flat_specs(self._inner.get_in_feature_specification(mode))
    return [key for key, value in spec.items() if coef_eligible(value)]

  def image_shapes(self, mode: str) -> Dict[str, Tuple[int, int]]:
    """(height, width) of each coefficient image."""
    spec = algebra.flat_specs(self._inner.get_in_feature_specification(mode))
    return {key: tuple(spec[key].shape[:2]) for key in self.image_keys(mode)}

  def raw_in_feature_specification(self, mode: str):
    """The wrapped (on-disk JPEG) in-specifications: what the loader
    plans."""
    return self._inner.get_in_feature_specification(mode)

  def get_in_feature_specification(self, mode: str) -> Dict[str, TensorSpec]:
    spec = algebra.flat_specs(self._inner.get_in_feature_specification(mode))
    make_specs = {'dense': coef_specs, 'sparse': sparse_coef_specs,
                  'packed': packed_coef_specs}[self.wire_format]
    out = {}
    for key, value in spec.items():
      if coef_eligible(value):
        out.update(make_specs(key, value))
      else:
        out[key] = value
    return out

  def get_in_label_specification(self, mode: str):
    return self._inner.get_in_label_specification(mode)

  def decode(self, features: Dict[str, torch.Tensor], mode: str
             ) -> Dict[str, torch.Tensor]:
    """``features`` with each coefficient group decoded to its uint8
    frames, on the coefficients' device (sparse and packed groups
    unpacked first)."""
    features = dict(features)
    shapes = self.image_shapes(mode)
    sparse = {k: v for k, v in shapes.items() if k + '/sd' in features}
    packed = {k: v for k, v in shapes.items() if k + '/pw' in features}
    features = jpeg_device.unpack_sparse_features(features, sparse)
    features = jpeg_device.unpack_packed_features(features, packed)
    return jpeg_device.decode_coef_features(features, list(shapes))

  def preprocess(self, features, labels, mode: str, **kwargs):
    """Finishes the JPEG decode on the device, then runs the wrapped
    preprocessor (``kwargs``: its random draws' ``generator`` or
    ``offsets``)."""
    return self._inner.preprocess(self.decode(features, mode), labels, mode,
                                  **kwargs)

  def preprocess_images(self, images: torch.Tensor, *args, **kwargs):
    """Decoded frames (as the policies serve them) go to the wrapped
    preprocessor as they are."""
    return self._inner.preprocess_images(images, *args, **kwargs)
