"""TFRecord files without TensorFlow (the JAX package's ``data/tfrecord.py``;
the corrupt-record budget is ``reliability/quarantine.py``'s).

Each record is ``[uint64 length][uint32 masked_crc32c(length)][bytes
data][uint32 masked_crc32c(data)]``, little-endian. CRC32C comes from
``google_crc32c`` where it is installed, else from a table in Python: the
same function, the second some 50x slower.

A reader verifying CRCs either raises ``CorruptRecordError`` on damage or,
with ``skip_corrupt``, charges it to a ``RecordQuarantine`` and reads on:
a bad data CRC skips the record, a bad length CRC or a truncated frame
abandons the rest of the file (its framing can no longer be trusted). The
quarantine raises ``CorruptionBudgetExceeded`` once more records than its
budgets allow are damaged, in one file or in all. Each record read passes
the ``data.read`` fault site, whose fired call is a corrupt record (skipped
and charged, or raised). The native loader reads its own records and takes
no skip mode.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional

from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.reliability.errors import (
    CorruptionBudgetExceeded, CorruptRecordError, InjectedFault)
from tensor2robot_tpu_torch.reliability.quarantine import RecordQuarantine

__all__ = ['CorruptRecordError', 'CorruptionBudgetExceeded',
           'RecordQuarantine', 'TFRecordWriter', 'masked_crc',
           'read_all_records', 'tfrecord_iterator', 'write_records']

try:
  import google_crc32c

  def _crc32c(data: bytes) -> int:
    return google_crc32c.value(data)
except ImportError:
  _CRC_TABLE = []
  for _i in range(256):
    _crc = _i
    for _ in range(8):
      _crc = (_crc >> 1) ^ 0x82F63B78 if _crc & 1 else _crc >> 1
    _CRC_TABLE.append(_crc)

  def _crc32c(data: bytes) -> int:
    table, crc = _CRC_TABLE, 0xFFFFFFFF
    for byte in data:
      crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
  crc = _crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
  """Appends framed records to a file."""

  def __init__(self, path: str):
    dirname = os.path.dirname(path)
    if dirname:
      os.makedirs(dirname, exist_ok=True)
    self._file = open(path, 'wb')

  def write(self, record: bytes) -> None:
    length = struct.pack('<Q', len(record))
    self._file.write(length)
    self._file.write(struct.pack('<I', masked_crc(length)))
    self._file.write(record)
    self._file.write(struct.pack('<I', masked_crc(record)))

  def flush(self) -> None:
    self._file.flush()

  def close(self) -> None:
    self._file.close()

  def __enter__(self):
    return self

  def __exit__(self, *_):
    self.close()


def tfrecord_iterator(path: str, verify_crc: bool = False,
                      skip_corrupt: bool = False,
                      quarantine: Optional[RecordQuarantine] = None
                      ) -> Iterator[bytes]:
  """Yields the records of one file (see the module's note on damage)."""
  if skip_corrupt and quarantine is None:
    quarantine = RecordQuarantine()

  def lost(reason: str, index: int):
    """The framing is lost: skip and abandon the file, or raise."""
    if not skip_corrupt:
      raise CorruptRecordError(path, reason, index)
    quarantine.record_skipped(path, reason, index)
    quarantine.file_abandoned(path, reason)

  with open(path, 'rb') as f:
    index = 0
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) < 12:
        # A trailing partial frame (a writer that crashed): counted in the
        # skip mode, silently the end otherwise.
        if skip_corrupt:
          lost('truncated header', index)
        return
      (length,) = struct.unpack('<Q', header[:8])
      if verify_crc and masked_crc(header[:8]) != struct.unpack(
          '<I', header[8:12])[0]:
        lost('length CRC', index)
        return
      data = f.read(length)
      if len(data) < length:
        lost('truncated data' if skip_corrupt else 'truncation', index)
        return
      footer = f.read(4)
      if len(footer) < 4:
        lost('truncated footer' if skip_corrupt else 'truncation', index)
        return
      index += 1
      if verify_crc and masked_crc(data) != struct.unpack('<I', footer)[0]:
        # The frame boundaries still hold: only this record is damaged.
        if not skip_corrupt:
          raise CorruptRecordError(path, 'data CRC', index - 1)
        quarantine.record_skipped(path, 'data CRC', index - 1)
        continue
      try:
        fault_injection.maybe_fail(fault_injection.SITE_DATA_READ)
      except InjectedFault:
        if not skip_corrupt:
          raise CorruptRecordError(path, 'injected', index - 1)
        quarantine.record_skipped(path, 'injected', index - 1)
        continue
      yield data


def read_all_records(path: str) -> List[bytes]:
  return list(tfrecord_iterator(path))


def write_records(path: str, records) -> None:
  with TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
