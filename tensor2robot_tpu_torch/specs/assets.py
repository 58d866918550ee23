"""t2r_assets: the specifications shipped inside every export (the JAX
package's ``specs/assets.py``).

Every exported version holds ``assets.extra/t2r_assets.pbtxt``: the
feature and label specifications and the global step, in protobuf text
format (the T2R proto's ``ExtendedTensorSpec`` / ``TensorSpecStruct`` /
``T2RAssets`` messages), written and parsed here without protoc. For the
same specifications the port writes the JAX package's text byte for byte.
A JSON twin (``t2r_assets.json``) is written beside it and read first.
``global_step.txt`` holds the step alone.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs.algebra import flat_specs
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.specs.tensor_spec import as_tensor_spec

__all__ = ['EXTRA_ASSETS_DIRECTORY', 'GLOBAL_STEP_FILENAME',
           'T2R_ASSETS_FILENAME', 'T2R_ASSETS_JSON_FILENAME',
           'load_global_step_from_file', 'load_t2r_assets_from_file',
           'parse_pbtxt', 'pbtxt_to_specs', 'spec_from_dict', 'spec_to_dict',
           'specs_to_pbtxt', 'write_global_step_to_file',
           'write_t2r_assets_to_file']

# The on-disk dtype enum (TensorFlow's DataType numbers, which the T2R
# proto stores), and the names the JSON twin may use.
_DTYPE_TO_ENUM = {
    np.dtype(np.float16): 19,
    np.dtype(np.float32): 1,
    np.dtype(np.float64): 2,
    np.dtype(np.int8): 6,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 3,
    np.dtype(np.int64): 9,
    np.dtype(np.uint8): 4,
    np.dtype(np.uint16): 17,
    np.dtype(np.uint32): 22,
    np.dtype(np.uint64): 23,
    np.dtype(np.bool_): 10,
    np.dtype(object): 7,  # string / bytes
}
_ENUM_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ENUM.items()}


def spec_to_dict(spec) -> dict:
  """A spec's fields as the T2R proto (and the JAX ``TensorSpec.to_dict``)
  lists them; -1 for an unknown dimension."""
  spec = as_tensor_spec(spec)
  d = {'shape': [(-1 if s is None else int(s)) for s in spec.shape],
       'dtype': _DTYPE_TO_ENUM[np.dtype(spec.dtype)]}
  if spec.name is not None:
    d['name'] = spec.name
  if spec.is_optional:
    d['is_optional'] = True
  if spec.is_sequence:
    d['is_sequence'] = True
  if spec.data_format is not None:
    d['data_format'] = spec.data_format
  if spec.dataset_key:
    d['dataset_key'] = spec.dataset_key
  if spec.varlen_default_value is not None:
    d['varlen_default_value'] = float(spec.varlen_default_value)
  return d


def spec_from_dict(d: dict) -> TensorSpec:
  dtype = d.get('dtype', 1)
  dtype = _ENUM_TO_DTYPE[dtype] if isinstance(dtype, int) else np.dtype(
      'O' if dtype == 'string' else dtype)
  return TensorSpec(
      [(None if s < 0 else s) for s in d.get('shape', [])], dtype,
      name=d.get('name'), is_optional=d.get('is_optional', False),
      is_sequence=d.get('is_sequence', False),
      data_format=d.get('data_format'), dataset_key=d.get('dataset_key'),
      varlen_default_value=d.get('varlen_default_value'))


T2R_ASSETS_FILENAME = 't2r_assets.pbtxt'
T2R_ASSETS_JSON_FILENAME = 't2r_assets.json'
EXTRA_ASSETS_DIRECTORY = 'assets.extra'
GLOBAL_STEP_FILENAME = 'global_step.txt'


# -- pbtxt emission ----------------------------------------------------------

def _emit_scalar(value) -> str:
  if isinstance(value, bool):
    return 'true' if value else 'false'
  if isinstance(value, str):
    escaped = value.replace('\\', '\\\\').replace('"', '\\"')
    return '"{}"'.format(escaped)
  if isinstance(value, float):
    return repr(value)
  return str(int(value))


def _emit_message(fields, indent: int = 0) -> str:
  """fields: list of (name, value) where value is scalar, list-of-scalars, or dict."""
  pad = '  ' * indent
  lines = []
  for name, value in fields:
    if isinstance(value, dict):
      lines.append('{}{} {{'.format(pad, name))
      lines.append(_emit_message(list(value.items()), indent + 1))
      lines.append('{}}}'.format(pad))
    elif isinstance(value, list):
      for item in value:
        if isinstance(item, dict):
          lines.append('{}{} {{'.format(pad, name))
          lines.append(_emit_message(list(item.items()), indent + 1))
          lines.append('{}}}'.format(pad))
        else:
          lines.append('{}{}: {}'.format(pad, name, _emit_scalar(item)))
    else:
      lines.append('{}{}: {}'.format(pad, name, _emit_scalar(value)))
  return '\n'.join(lines)


def _spec_struct_to_fields(spec_structure) -> dict:
  flat = flat_specs(spec_structure)
  entries = []
  for key in flat:
    value = collections.OrderedDict()
    d = spec_to_dict(flat[key])
    # Strictly the T2R proto's fields 1-8, so that a protobuf text parser
    # of that schema reads the file. is_sequence is not part of the
    # schema; it round-trips through the JSON twin.
    for field in ('shape', 'dtype', 'name', 'is_optional', 'is_extracted',
                  'data_format', 'dataset_key', 'varlen_default_value'):
      if field in d:
        value[field] = d[field]
    entries.append(collections.OrderedDict([('key', key), ('value', value)]))
  return {'key_value': entries}


def specs_to_pbtxt(feature_spec, label_spec,
                   global_step: Optional[int] = None) -> str:
  fields = []
  if feature_spec is not None:
    fields.append(('feature_spec', _spec_struct_to_fields(feature_spec)))
  if label_spec is not None:
    fields.append(('label_spec', _spec_struct_to_fields(label_spec)))
  if global_step is not None:
    fields.append(('global_step', int(global_step)))
  return _emit_message(fields) + '\n'


# -- pbtxt parsing -----------------------------------------------------------

def _tokenize(text: str):
  tokens = []
  i, n = 0, len(text)
  while i < n:
    c = text[i]
    if c in ' \t\r\n':
      i += 1
    elif c == '#':
      while i < n and text[i] != '\n':
        i += 1
    elif c in '{}:':
      tokens.append(c)
      i += 1
    elif c == '"':
      j = i + 1
      buf = []
      while j < n and text[j] != '"':
        if text[j] == '\\':
          j += 1
          buf.append(text[j])
        else:
          buf.append(text[j])
        j += 1
      tokens.append(('STR', ''.join(buf)))
      i = j + 1
    else:
      j = i
      while j < n and text[j] not in ' \t\r\n{}:#"':
        j += 1
      tokens.append(('ATOM', text[i:j]))
      i = j
  return tokens


def _parse_atom(atom: str):
  if atom == 'true':
    return True
  if atom == 'false':
    return False
  try:
    return int(atom)
  except ValueError:
    return float(atom)


def _parse_message(tokens, pos: int) -> Tuple[dict, int]:
  """Parses fields until '}' or EOF. Repeated fields accumulate into lists."""
  out = collections.OrderedDict()

  def _add(name, value):
    if name in out:
      if not isinstance(out[name], list):
        out[name] = [out[name]]
      out[name].append(value)
    else:
      out[name] = value

  while pos < len(tokens):
    tok = tokens[pos]
    if tok == '}':
      return out, pos + 1
    if not (isinstance(tok, tuple) and tok[0] == 'ATOM'):
      raise ValueError('pbtxt parse error near token {}'.format(tok))
    name = tok[1]
    pos += 1
    if tokens[pos] == ':':
      pos += 1
      vtok = tokens[pos]
      pos += 1
      _add(name, vtok[1] if vtok[0] == 'STR' else _parse_atom(vtok[1]))
    elif tokens[pos] == '{':
      sub, pos = _parse_message(tokens, pos + 1)
      _add(name, sub)
    else:
      raise ValueError('pbtxt parse error after field {}'.format(name))
  return out, pos


def parse_pbtxt(text: str) -> dict:
  try:
    msg, _ = _parse_message(_tokenize(text), 0)
  except (IndexError, KeyError) as e:
    raise ValueError('Malformed pbtxt: {}'.format(e))
  return msg


def _as_list(value):
  if value is None:
    return []
  return value if isinstance(value, list) else [value]


def _fields_to_spec_struct(msg) -> dict:
  out = {}
  for entry in _as_list(msg.get('key_value')):
    value = dict(entry['value'])
    value['shape'] = [int(s) for s in _as_list(value.get('shape'))]
    out[entry['key']] = spec_from_dict(value)
  return out


def pbtxt_to_specs(text: str):
  """Returns (feature_spec, label_spec, global_step)."""
  msg = parse_pbtxt(text)
  feature_spec = label_spec = None
  if 'feature_spec' in msg:
    feature_spec = _fields_to_spec_struct(msg['feature_spec'])
  if 'label_spec' in msg:
    label_spec = _fields_to_spec_struct(msg['label_spec'])
  return feature_spec, label_spec, msg.get('global_step')


# -- file-level API (contract: assets.extra/t2r_assets.pbtxt) ----------------

def write_t2r_assets_to_file(feature_spec, label_spec, global_step,
                             filename: str) -> None:
  """Writes the pbtxt to ``filename`` and its JSON twin beside it."""
  if os.path.dirname(filename):
    os.makedirs(os.path.dirname(filename), exist_ok=True)
  with open(filename, 'w') as f:
    f.write(specs_to_pbtxt(feature_spec, label_spec, global_step))
  json_payload = {
      'feature_spec': {k: spec_to_dict(s) for k, s in
                       flat_specs(feature_spec).items()},
      'label_spec': {k: spec_to_dict(s) for k, s in
                     flat_specs(label_spec).items()},
      'global_step': int(global_step) if global_step is not None else None,
  }
  json_path = os.path.join(os.path.dirname(filename), T2R_ASSETS_JSON_FILENAME)
  with open(json_path, 'w') as f:
    json.dump(json_payload, f, indent=2)


def load_t2r_assets_from_file(filename: str):
  """(feature_spec, label_spec, global_step) of an assets file.

  Prefers the lossless JSON twin when present (it keeps is_sequence, which
  the pbtxt schema cannot carry); falls back to the pbtxt.
  """
  json_path = os.path.join(os.path.dirname(filename), T2R_ASSETS_JSON_FILENAME)
  if os.path.exists(json_path):
    try:
      with open(json_path) as f:
        payload = json.load(f)
      def _load(side):
        return {k: spec_from_dict(d)
                for k, d in (payload.get(side) or {}).items()}
      return _load('feature_spec'), _load('label_spec'), payload.get('global_step')
    except (ValueError, KeyError):
      pass  # corrupt twin: fall back to the pbtxt source of truth
  with open(filename) as f:
    return pbtxt_to_specs(f.read())


def write_global_step_to_file(global_step: int, dirname: str) -> None:
  """The step alone, beside an export's assets, for cheap reconciliation."""
  os.makedirs(dirname, exist_ok=True)
  with open(os.path.join(dirname, GLOBAL_STEP_FILENAME), 'w') as f:
    f.write(str(int(global_step)))


def load_global_step_from_file(dirname: str) -> int:
  """The step that ``write_global_step_to_file`` wrote."""
  with open(os.path.join(dirname, GLOBAL_STEP_FILENAME)) as f:
    return int(f.read().strip())
