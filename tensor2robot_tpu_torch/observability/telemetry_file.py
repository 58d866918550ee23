"""Machine-readable run telemetry: ``telemetry.jsonl`` + heartbeat file.

A copy of the single-process half of the JAX package's
``observability/telemetry_file.py``. The file names, the record layout
(``{"time", "kind", "step", ...payload}``, one JSON object per line) and
the heartbeat (``{"time", "step", "pid", "hostname"}``, replaced
atomically) are the same, so ``bin/t2r_telemetry doctor`` reads a serving
directory written by either package.

The live file is capped at ``max_bytes``; at the cap it is renamed to
``telemetry.jsonl.1`` (older generations shift up to ``max_rotated``) and
a fresh file starts, always at a line boundary. ``read_telemetry`` stitches
the generations back together, oldest first, and tolerates a torn final
line.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

__all__ = ['TelemetryLogger', 'read_telemetry',
           'TELEMETRY_FILENAME', 'HEARTBEAT_FILENAME', 'DEFAULT_MAX_BYTES',
           'DEFAULT_MAX_ROTATED']

TELEMETRY_FILENAME = 'telemetry.jsonl'
HEARTBEAT_FILENAME = 'heartbeat.json'

DEFAULT_MAX_BYTES = 256 * 2**20
DEFAULT_MAX_ROTATED = 2


class TelemetryLogger:
  """Appends telemetry records and keeps the heartbeat of one process.

  Thread-safe within one process: ``log``, ``heartbeat`` and ``flush``
  take one lock, so the serve loop and a hot-swap poller cannot interleave
  a record mid-line or race the rotation.
  """

  def __init__(self, model_dir: str,
               max_bytes: Optional[int] = DEFAULT_MAX_BYTES,
               max_rotated: int = DEFAULT_MAX_ROTATED):
    os.makedirs(model_dir, exist_ok=True)
    self.model_dir = model_dir
    self.max_bytes = None if max_bytes is None else int(max_bytes)
    self.max_rotated = max(1, int(max_rotated))
    self._lock = threading.Lock()
    self._path = os.path.join(model_dir, TELEMETRY_FILENAME)
    self._heartbeat_path = os.path.join(model_dir, HEARTBEAT_FILENAME)
    self._file = open(self._path, 'a', encoding='utf-8')
    # Tracked size, not tell(): tell() on a text append stream flushes.
    self._size = os.path.getsize(self._path)

  @property
  def path(self) -> str:
    return self._path

  def _maybe_rotate(self, incoming_bytes: int) -> None:
    if self.max_bytes is None:
      return
    if self._size == 0 or self._size + incoming_bytes <= self.max_bytes:
      return  # a fresh file always takes at least one record
    self._file.flush()
    self._file.close()
    for index in range(self.max_rotated, 1, -1):
      older = '{}.{}'.format(self._path, index - 1)
      if os.path.exists(older):
        os.replace(older, '{}.{}'.format(self._path, index))
    os.replace(self._path, self._path + '.1')
    self._file = open(self._path, 'a', encoding='utf-8')
    self._size = 0

  def log(self, kind: str, step: Optional[int] = None,
          **payload) -> Dict[str, object]:
    """Appends one record; returns it."""
    record: Dict[str, object] = {
        'time': time.time(),  # wall-clock timestamp (cross-process record)
        'kind': kind,
        'step': None if step is None else int(step)}
    record.update(payload)
    line = json.dumps(record) + '\n'
    encoded = len(line.encode('utf-8'))
    with self._lock:
      self._maybe_rotate(encoded)
      self._file.write(line)
      self._size += encoded
    return record

  def heartbeat(self, step: Optional[int] = None, **extra) -> None:
    """Atomically replaces the heartbeat file (never half-written)."""
    beat: Dict[str, object] = {
        'time': time.time(),  # wall-clock timestamp (external readers)
        'step': None if step is None else int(step),
        'pid': os.getpid(),
        'hostname': socket.gethostname(),
    }
    beat.update(extra)
    tmp = self._heartbeat_path + '.tmp'
    with self._lock:
      with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(beat, f)
      os.replace(tmp, self._heartbeat_path)

  def flush(self) -> None:
    with self._lock:
      if not self._file.closed:
        self._file.flush()

  def close(self) -> None:
    with self._lock:
      if not self._file.closed:
        self._file.flush()
        self._file.close()


def _read_one(path: str) -> List[Dict[str, object]]:
  records: List[Dict[str, object]] = []
  with open(path, encoding='utf-8') as f:
    lines = f.read().splitlines()
  for index, line in enumerate(lines):
    if not line.strip():
      continue
    try:
      records.append(json.loads(line))
    except ValueError as e:
      if index == len(lines) - 1:
        break  # torn tail from a killed writer: ignore
      raise ValueError('{}:{} holds malformed telemetry: {}'.format(
          path, index + 1, e)) from e
  return records


def read_telemetry(path: str) -> List[Dict[str, object]]:
  """Parses a telemetry.jsonl file (or the directory holding one),
  rotated generations included, oldest first."""
  if os.path.isdir(path):
    path = os.path.join(path, TELEMETRY_FILENAME)
  generations = []
  index = 1
  while os.path.exists('{}.{}'.format(path, index)):
    generations.insert(0, '{}.{}'.format(path, index))
    index += 1
  if os.path.exists(path):
    generations.append(path)
  if not generations:
    raise FileNotFoundError(path)
  records: List[Dict[str, object]] = []
  for generation in generations:
    records.extend(_read_one(generation))
  return records
