"""Migrates pickled reference assets to ``t2r_assets.pbtxt`` (the JAX
package's ``utils/convert_pkl_assets.py``, writing through the port's
``specs/assets.py``). No torch.

A restricted unpickler rebuilds the port's ``TensorSpec``s from the
opcode stream of the reference's ``input_specs.pkl`` (and optional
``global_step.pkl``), without TF1 or the reference package installed and
without running arbitrary pickle globals: only an allowlist of spec, shape
and dtype constructors resolves, anything else raises
``pickle.UnpicklingError`` naming the global. The allowlist is what the
reference's writers emit: its ``ExtendedTensorSpec`` (a 9-tuple of
constructor arguments), its ``TensorSpecStruct`` (an OrderedDict of flat
``a/b`` paths), ``tf.TensorSpec``, and TF's ``TensorShape``, ``Dimension``
and ``as_dtype`` reductions.

    python -m tensor2robot_tpu_torch.utils.convert_pkl_assets \\
        --assets_filepath <export>/assets.extra
"""

import collections
import io
import os
import pickle
from typing import Any, Dict, Optional, Tuple

from tensor2robot_tpu_torch.specs.assets import T2R_ASSETS_FILENAME
from tensor2robot_tpu_torch.specs.assets import write_t2r_assets_to_file
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['convert', 'load_global_step_from_pkl', 'load_input_spec_from_pkl',
           'main']


def _tensor_shape(dims=None) -> Tuple[Optional[int], ...]:
  """tf.TensorShape reduces to (TensorShape, ([Dimension...],))."""
  if dims is None:
    return ()
  return tuple(dims)


def _dimension(value=None) -> Optional[int]:
  """A tf Dimension -> its int (None where unknown)."""
  return None if value is None else int(value)


def _as_dtype(name):
  """tf dtypes reduce to (as_dtype, ('float32',)): the name carries
  through; ``TensorSpec`` takes it."""
  return name


def _extended_tensor_spec(shape, dtype, name=None, is_optional=None,
                          is_sequence=False, is_extracted=False,
                          data_format=None, dataset_key=None,
                          varlen_default_value=None) -> TensorSpec:
  """The reference ExtendedTensorSpec's ``__reduce__`` argument order.
  ``is_extracted`` has no field in the port's spec (nor in the pbtxt it
  writes)."""
  del is_extracted
  return TensorSpec(
      shape=_tensor_shape(shape) if not isinstance(shape, tuple) else shape,
      dtype=dtype, name=name, is_optional=bool(is_optional),
      is_sequence=is_sequence, data_format=data_format,
      dataset_key=dataset_key, varlen_default_value=varlen_default_value)


def _plain_tensor_spec(shape, dtype, name=None) -> TensorSpec:
  return _extended_tensor_spec(shape, dtype, name)


class _SpecStructShim(collections.OrderedDict):
  """The reference TensorSpecStruct while unpickling: its instance state
  means nothing here and is dropped."""

  def __setstate__(self, state):  # noqa: ARG002 — the reference's state
    pass


_ALLOWED_GLOBALS = {
    ('collections', 'OrderedDict'): collections.OrderedDict,
    ('tensor2robot.utils.tensorspec_utils', 'ExtendedTensorSpec'):
        _extended_tensor_spec,
    ('tensor2robot.utils.tensorspec_utils', 'TensorSpecStruct'):
        _SpecStructShim,
    ('tensorflow.python.framework.tensor_shape', 'TensorShape'):
        _tensor_shape,
    ('tensorflow.python.framework.tensor_shape', 'Dimension'): _dimension,
    ('tensorflow.python.framework.tensor_shape', 'as_dimension'): _dimension,
    ('tensorflow.python.framework.dtypes', 'as_dtype'): _as_dtype,
    ('tensorflow.python.framework.tensor_spec', 'TensorSpec'):
        _plain_tensor_spec,
}


class _RestrictedUnpickler(pickle.Unpickler):

  def find_class(self, module: str, name: str):
    try:
      return _ALLOWED_GLOBALS[(module, name)]
    except KeyError:
      raise pickle.UnpicklingError(
          'Refusing to resolve pickle global {}.{}: only reference '
          'tensorspec assets can be converted (allowed: {}).'.format(
              module, name,
              sorted('{}.{}'.format(m, n) for m, n in _ALLOWED_GLOBALS)))


def _restricted_load(data: bytes) -> Any:
  return _RestrictedUnpickler(io.BytesIO(data)).load()


def _to_spec_dict(obj: Any) -> Dict[str, TensorSpec]:
  """A reference spec container (or a bare spec) -> the port's flat dict of
  ``a/b`` paths."""
  if isinstance(obj, TensorSpec):
    return {obj.name or 'value': obj}
  if isinstance(obj, collections.abc.Mapping):
    return dict(obj.items())
  raise ValueError(
      'Unsupported pickled spec container: {!r}'.format(type(obj)))


def load_input_spec_from_pkl(filename: str):
  """A reference ``input_specs.pkl`` -> (feature_spec, label_spec); its
  payload is ``{'in_feature_spec': ..., 'in_label_spec': ...}``."""
  with open(filename, 'rb') as f:
    payload = _restricted_load(f.read())
  if not isinstance(payload, collections.abc.Mapping) or not (
      'in_feature_spec' in payload and 'in_label_spec' in payload):
    raise ValueError(
        '{} is not a reference input_specs.pkl (expected in_feature_spec/'
        'in_label_spec keys, got {!r}).'.format(
            filename, sorted(payload) if isinstance(
                payload, collections.abc.Mapping) else type(payload)))
  return (_to_spec_dict(payload['in_feature_spec']),
          _to_spec_dict(payload['in_label_spec']))


def load_global_step_from_pkl(filename: str) -> int:
  """A reference ``global_step.pkl``'s step."""
  with open(filename, 'rb') as f:
    payload = _restricted_load(f.read())
  return int(payload['global_step'])


def convert(assets_filepath: str) -> str:
  """Writes ``t2r_assets.pbtxt`` (and its JSON twin) beside the reference
  assets of ``assets_filepath``: ``input_specs.pkl`` required,
  ``global_step.pkl`` optional. Returns the pbtxt's path."""
  input_spec_filepath = os.path.join(assets_filepath, 'input_specs.pkl')
  if not os.path.exists(input_spec_filepath):
    raise ValueError('No file exists for {}.'.format(input_spec_filepath))
  feature_spec, label_spec = load_input_spec_from_pkl(input_spec_filepath)
  global_step = None
  global_step_filepath = os.path.join(assets_filepath, 'global_step.pkl')
  if os.path.exists(global_step_filepath):
    global_step = load_global_step_from_pkl(global_step_filepath)
  out_path = os.path.join(assets_filepath, T2R_ASSETS_FILENAME)
  write_t2r_assets_to_file(feature_spec, label_spec, global_step, out_path)
  return out_path


def main(argv=None) -> None:
  import argparse
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--assets_filepath', required=True,
                      help='an exported model\'s assets directory holding '
                      'input_specs.pkl (and optionally global_step.pkl)')
  print(convert(parser.parse_args(argv).assets_filepath))


if __name__ == '__main__':
  main()
