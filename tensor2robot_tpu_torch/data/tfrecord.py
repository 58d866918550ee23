"""TFRecord files without TensorFlow (the JAX package's ``data/tfrecord.py``
and the corrupt-record budget of its ``reliability/quarantine.py``).

Each record is ``[uint64 length][uint32 masked_crc32c(length)][bytes
data][uint32 masked_crc32c(data)]``, little-endian. CRC32C comes from
``google_crc32c`` where it is installed, else from a table in Python: the
same function, the second some 50x slower.

A reader verifying CRCs either raises ``CorruptRecordError`` on damage or,
with ``skip_corrupt``, charges it to a ``RecordQuarantine`` and reads on:
a bad data CRC skips the record, a bad length CRC or a truncated frame
abandons the rest of the file (its framing can no longer be trusted). The
quarantine raises ``CorruptionBudgetExceeded`` once more records than its
budgets allow are damaged, in one file or in all.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, List, Optional

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


class CorruptRecordError(IOError):
  """One unreadable record (bad CRC or truncation)."""

  def __init__(self, path: str, reason: str,
               record_index: Optional[int] = None):
    at = '' if record_index is None else ' (record #{})'.format(record_index)
    super().__init__('Corrupt TFRecord {} in {}{}'.format(reason, path, at))
    self.path = path
    self.reason = reason
    self.record_index = record_index


class CorruptionBudgetExceeded(IOError):
  """More corrupt records than the quarantine's budget allows."""

  def __init__(self, path: str, scope: str, limit: int):
    super().__init__(
        'Corrupt-record budget exhausted: more than {} corrupt record(s) {} '
        '- last offender: {}. The data is damaged beyond the configured '
        'tolerance; repair or exclude it.'.format(
            limit, 'in one file' if scope == 'file' else 'across the run',
            path))
    self.path = path
    self.scope = scope
    self.limit = limit


class RecordQuarantine:
  """Counts corrupt records against a per-file and a global budget.

  The (N+1)-th corrupt record over either budget raises; 0 fails on the
  first. A record is charged once however many epochs read it again.
  """

  def __init__(self, max_corrupt_records: int = 100,
               max_corrupt_records_per_file: int = 10):
    self._lock = threading.Lock()
    self._max_total = int(max_corrupt_records)
    self._max_per_file = int(max_corrupt_records_per_file)
    self._skipped_by_file: Dict[str, int] = {}
    self._abandoned_files: Dict[str, str] = {}
    self._skipped_total = 0
    self._charged: set = set()

  @property
  def records_skipped(self) -> int:
    with self._lock:
      return self._skipped_total

  @property
  def files_abandoned(self) -> int:
    with self._lock:
      return len(self._abandoned_files)

  def record_skipped(self, path: str, reason: str = '',
                     record_index: Optional[int] = None) -> None:
    """Charges one corrupt record to ``path``; raises when a budget is
    exceeded."""
    del reason
    with self._lock:
      if record_index is not None:
        if (path, record_index) in self._charged:
          return
        self._charged.add((path, record_index))
      self._skipped_total += 1
      in_file = self._skipped_by_file.get(path, 0) + 1
      self._skipped_by_file[path] = in_file
      over_file = in_file > self._max_per_file
      over_total = self._skipped_total > self._max_total
    if over_file:
      raise CorruptionBudgetExceeded(path, 'file', self._max_per_file)
    if over_total:
      raise CorruptionBudgetExceeded(path, 'global', self._max_total)

  def file_abandoned(self, path: str, reason: str = '') -> None:
    """Marks the rest of ``path`` unreadable (its framing is lost)."""
    with self._lock:
      self._abandoned_files.setdefault(path, reason)

  def summary(self) -> Dict[str, object]:
    with self._lock:
      return {'records_skipped': self._skipped_total,
              'by_file': dict(self._skipped_by_file),
              'abandoned_files': dict(self._abandoned_files)}


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
      yield data


def read_all_records(path: str) -> List[bytes]:
  return list(tfrecord_iterator(path))


def write_records(path: str, records) -> None:
  with TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
