"""Corrupt-record quarantine: bounded tolerance with loud exhaustion (a copy
of the JAX package's ``reliability/quarantine.py``).

Every skipped record is counted per file (or replay shard) and in all; the
(N+1)-th corrupt record over either budget raises
``CorruptionBudgetExceeded`` naming the offender. The process-wide total
is the registry counter ``data/corrupt_records_skipped``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.reliability.errors import CorruptionBudgetExceeded

__all__ = ['FILES_ABANDONED_COUNTER', 'RECORDS_SKIPPED_COUNTER',
           'RecordQuarantine']

RECORDS_SKIPPED_COUNTER = 'data/corrupt_records_skipped'
FILES_ABANDONED_COUNTER = 'data/corrupt_files_abandoned'


class RecordQuarantine:
  """Counts corrupt records against a per-file and a global budget.

  The (N+1)-th corrupt record over either budget raises; 0 fails on the
  first. A record given with its index is charged once however many epochs
  read it again.
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

  def skipped_in_file(self, path: str) -> int:
    with self._lock:
      return self._skipped_by_file.get(path, 0)

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
    get_registry().counter(RECORDS_SKIPPED_COUNTER).inc()
    if over_file:
      raise CorruptionBudgetExceeded(path, 'file', self._max_per_file)
    if over_total:
      raise CorruptionBudgetExceeded(path, 'global', self._max_total)

  def file_abandoned(self, path: str, reason: str = '') -> None:
    """Marks the rest of ``path`` unreadable (its framing is lost)."""
    with self._lock:
      newly = path not in self._abandoned_files
      self._abandoned_files.setdefault(path, reason)
    if newly:
      get_registry().counter(FILES_ABANDONED_COUNTER).inc()

  def summary(self) -> Dict[str, object]:
    with self._lock:
      return {'records_skipped': self._skipped_total,
              'by_file': dict(self._skipped_by_file),
              'abandoned_files': dict(self._abandoned_files)}
