"""Per-example replay records: a copy of the JAX package's
``replay/wire.py``, byte for byte on the wire.

  * ``encode_example`` / ``decode_example``: a self-describing binary
    record, named numpy arrays (dtype, shape, raw bytes) behind a
    magic/version header, framed with the Example codec's varints
    (``data/wire.py``). No pickle (a replay shard never executes bytes a
    collector sent it) and no JSON.
  * ``split_batch``: a native-loader ``coef_packed`` batch becomes B
    per-example records. The bucketed stream buffers are trimmed back to
    each row's payload (the packed wire's trailing bytes are 0x00 padding,
    and escape entries are never 0), and the batch's ``[1, 3, 64]`` quant
    table is copied onto every example, so that each record stands alone.
  * ``assemble_batch``: B records become one batch in the native loader's
    layout: streams zero-padded to the batch's longest, rounded up to
    ``PACKED_BUCKET`` / ``ESCAPE_BUCKET``, and the quant tables hoisted
    again (a mismatch is an error naming ``coef_sparse`` as the remedy).

Corruption (bad magic, truncation, an undeclared dtype, a size mismatch)
raises :class:`ReplayWireError`, which the service charges to a shard's
quarantine budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.data.native_loader import (ESCAPE_BUCKET,
                                                       PACKED_BUCKET)
from tensor2robot_tpu_torch.data.wire import write_varint

__all__ = ['ReplayWireError', 'encode_example', 'decode_example',
           'split_batch', 'assemble_batch', 'packed_group_keys',
           'example_nbytes', 'REPLAY_WIRE_MAGIC', 'REPLAY_WIRE_VERSION']

REPLAY_WIRE_MAGIC = b'T2RX'
REPLAY_WIRE_VERSION = 1

# Dtypes a record may carry. An allowlist, not a passthrough: decode
# constructs dtypes from attacker-controllable strings, and np.dtype()
# accepts far more than arrays we ever ship (incl. object).
_ALLOWED_DTYPES = ('<f8', '<f4', '<f2', '<i8', '<i4', '<i2', '<u8',
                   '<u4', '<u2', '|i1', '|u1', '|b1')


class ReplayWireError(ValueError):
  """A replay record failed structural validation (corrupt append)."""


def encode_example(entries: Dict[str, np.ndarray]) -> bytes:
  """Serializes ``{key: array}`` into one self-describing record."""
  out = bytearray()
  out.extend(REPLAY_WIRE_MAGIC)
  write_varint(out, REPLAY_WIRE_VERSION)
  write_varint(out, len(entries))
  for key in sorted(entries):
    array = np.asarray(entries[key])
    if array.ndim:  # ascontiguousarray would promote a 0-d to rank 1
      array = np.ascontiguousarray(array)
    dtype = np.dtype(array.dtype).str
    if dtype not in _ALLOWED_DTYPES:
      # bfloat16 (and any other 2-byte extension type) ships as its raw
      # view; the consumer reinterprets from the spec, exactly like the
      # native loader's byte buffers.
      if array.dtype.itemsize == 2:
        array = array.view(np.uint16)
        dtype = '<u2'
      else:
        raise ReplayWireError(
            'cannot encode dtype {} for {!r}'.format(array.dtype, key))
    name = key.encode('utf-8')
    write_varint(out, len(name))
    out.extend(name)
    dt = dtype.encode('ascii')
    write_varint(out, len(dt))
    out.extend(dt)
    write_varint(out, array.ndim)
    for dim in array.shape:
      write_varint(out, int(dim))
    payload = array.tobytes()
    write_varint(out, len(payload))
    out.extend(payload)
  return bytes(out)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  end = len(buf)
  while True:
    if pos >= end:
      raise ReplayWireError('record truncated inside a varint')
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7
    if shift > 63:
      raise ReplayWireError('malformed varint')


def decode_example(blob: bytes) -> Dict[str, np.ndarray]:
  """Parses one record back into ``{key: array}``; raises ReplayWireError.

  Array payloads are zero-copy views onto ``blob`` (frombuffer) — the
  store keeps records as bytes, so a sampled batch assembles without an
  extra copy per field.
  """
  buf = memoryview(blob)
  if len(buf) < 4 or bytes(buf[:4]) != REPLAY_WIRE_MAGIC:
    raise ReplayWireError('bad magic (not a replay record)')
  pos = 4
  version, pos = _read_varint(buf, pos)
  if version != REPLAY_WIRE_VERSION:
    raise ReplayWireError('unsupported record version {}'.format(version))
  count, pos = _read_varint(buf, pos)
  if count > 4096:
    raise ReplayWireError('implausible entry count {}'.format(count))
  entries: Dict[str, np.ndarray] = {}
  for _ in range(count):
    name_len, pos = _read_varint(buf, pos)
    if pos + name_len > len(buf):
      raise ReplayWireError('record truncated inside a name')
    key = bytes(buf[pos:pos + name_len]).decode('utf-8', 'strict')
    pos += name_len
    dt_len, pos = _read_varint(buf, pos)
    if pos + dt_len > len(buf):
      raise ReplayWireError('record truncated inside a dtype')
    dtype_str = bytes(buf[pos:pos + dt_len]).decode('ascii', 'strict')
    pos += dt_len
    if dtype_str not in _ALLOWED_DTYPES:
      raise ReplayWireError('undeclared dtype {!r} for {!r}'.format(
          dtype_str, key))
    dtype = np.dtype(dtype_str)
    ndim, pos = _read_varint(buf, pos)
    if ndim > 16:
      raise ReplayWireError('implausible rank {} for {!r}'.format(ndim, key))
    shape = []
    for _ in range(ndim):
      dim, pos = _read_varint(buf, pos)
      shape.append(dim)
    payload_len, pos = _read_varint(buf, pos)
    if pos + payload_len > len(buf):
      raise ReplayWireError('record truncated inside {!r}'.format(key))
    n_elems = int(np.prod(shape, dtype=np.int64)) if ndim else 1
    if payload_len != n_elems * dtype.itemsize:
      raise ReplayWireError(
          'payload size {} != shape {} x {} for {!r}'.format(
              payload_len, shape, dtype_str, key))
    if n_elems == 0:
      array = np.zeros(shape, dtype)
    else:
      array = np.frombuffer(buf, dtype=dtype, count=n_elems, offset=pos)
      array = array.reshape(shape) if ndim else array[0]
    pos += payload_len
    entries[key] = array
  if pos != len(buf):
    raise ReplayWireError('{} trailing bytes after the last entry'.format(
        len(buf) - pos))
  return entries


def example_nbytes(entries: Dict[str, np.ndarray]) -> int:
  """Payload bytes of one decoded record (at-rest accounting helper)."""
  return int(sum(np.asarray(v).nbytes for v in entries.values()))


def packed_group_keys(keys) -> List[str]:
  """Base keys of every packed image group present (``<base>/pw``)."""
  return sorted(key[:-3] for key in keys if key.endswith('/pw'))


def _trimmed_length(row: np.ndarray) -> int:
  """Length of ``row`` with trailing zeros removed (payload, not padding).

  Sound for ``pw`` (0x00 is the no-op padding byte, never emitted inside
  a stream) and ``se`` (escape values are never 0 — see module
  docstring). NOT generic: do not apply to dense features.
  """
  nonzero = np.flatnonzero(row)
  return int(nonzero[-1]) + 1 if nonzero.size else 0


def split_batch(features: Dict[str, np.ndarray],
                labels: Optional[Dict[str, np.ndarray]] = None
                ) -> List[bytes]:
  """One native-loader batch -> B per-example replay records.

  ``features``/``labels`` are flat ``{key: array}`` dicts (SpecStructs'
  ``to_dict()`` output). Packed stream buffers are trimmed per row; the
  batch-hoisted quant table is copied onto every example (records must
  be self-contained — a record sampled into a DIFFERENT batch needs its
  own table for the uniformity check).
  """
  sides = [('features', dict(features))]
  if labels:
    sides.append(('labels', dict(labels)))
  flat: Dict[str, np.ndarray] = {}
  batch = 0
  for side, values in sides:
    for key, value in values.items():
      array = np.asarray(value)
      flat[side + '/' + key] = array
  packed_bases = packed_group_keys(flat)
  for key, array in flat.items():
    if any(key == base + '/qt' for base in packed_bases):
      continue  # hoisted [1, 3, 64]: not a batch-dim array
    if array.ndim and (batch in (0, 1)):
      batch = int(array.shape[0])
      if batch > 1:
        break
  if not batch:
    raise ReplayWireError('cannot infer the batch dimension')
  records: List[bytes] = []
  for row in range(batch):
    entries: Dict[str, np.ndarray] = {}
    for key, array in flat.items():
      base = key[:-3] if key.endswith(('/pw', '/se')) else None
      if base in packed_bases:
        stream = array[row]
        entries[key] = stream[:_trimmed_length(stream)]
      elif any(key == b + '/qt' for b in packed_bases):
        entries[key] = array[0] if array.shape[0] == 1 else array[row]
      else:
        entries[key] = array[row]
    records.append(encode_example(entries))
  return records


def _bucket(length: int, granularity: int) -> int:
  return max(granularity, -(-length // granularity) * granularity)


def _hoist_quant_tables(rows: np.ndarray, base: str) -> np.ndarray:
  """Re-hoists per-example [3, 64] tables to the wire's [1, 3, 64].

  Same contract as the native loader's ``_hoisted_quant_table``:
  all-zero rows are empty payloads (skipped), a genuine mismatch is a
  hard error naming ``coef_sparse`` as the remedy, an all-empty batch
  ships 1s (the well-defined-dequant convention for zero images).
  """
  flat = rows.reshape(rows.shape[0], -1)
  present = flat.any(axis=1)
  if not present.any():
    return np.ones((1,) + rows.shape[1:], rows.dtype)
  first = int(np.argmax(present))
  if not (flat[present] == flat[first]).all():
    raise ReplayWireError(
        "replay sample: packed batch requires batch-uniform JPEG "
        "quantization tables for '{}' (the packed wire ships ONE table "
        "per batch); these examples mix qualities — collect with "
        "image_mode='coef_sparse' instead.".format(base))
  return rows[first:first + 1].copy()


def assemble_batch(examples: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
  """B decoded records -> one flat batch dict in native-loader layout.

  Every record must carry the same key set (one spec per service). The
  packed streams are padded with zeros to the batch max, rounded up to
  the loader's bucket granularities; quant tables re-hoist to [1, 3, 64].
  """
  if not examples:
    raise ReplayWireError('assemble_batch needs at least one example')
  keys = sorted(examples[0])
  for entry in examples[1:]:
    if sorted(entry) != keys:
      raise ReplayWireError(
          'examples disagree on keys: {} vs {}'.format(keys,
                                                       sorted(entry)))
  packed_bases = packed_group_keys(keys)
  out: Dict[str, np.ndarray] = {}
  for key in keys:
    rows = [np.asarray(entry[key]) for entry in examples]
    base = key[:-3] if key.endswith(('/pw', '/se')) else None
    if base in packed_bases:
      granularity = PACKED_BUCKET if key.endswith('/pw') else ESCAPE_BUCKET
      width = _bucket(max(row.shape[0] for row in rows), granularity)
      stacked = np.zeros((len(rows), width), rows[0].dtype)
      for i, row in enumerate(rows):
        stacked[i, :row.shape[0]] = row
      out[key] = stacked
    elif any(key == b + '/qt' for b in packed_bases):
      out[key] = _hoist_quant_tables(np.stack(rows, axis=0), key[:-3])
    else:
      out[key] = np.stack(rows, axis=0)
  return out
