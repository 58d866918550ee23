"""Machine-readable run telemetry: ``telemetry.jsonl`` + heartbeat file.

A copy of the JAX package's ``observability/telemetry_file.py``. The file
names, the record layout (``{"time", "kind", "step", ...payload}``, one JSON
object per line) and the heartbeat (``{"time", "step", "pid", "hostname"}``,
replaced atomically) are the same, so ``bin/t2r_telemetry doctor`` reads a
directory written by either package.

The live file is capped at ``max_bytes``; at the cap it is renamed to
``telemetry.jsonl.1`` (older generations shift up to ``max_rotated``) and
a fresh file starts, always at a line boundary. ``read_telemetry`` stitches
the generations back together, oldest first, and tolerates a torn final
line.

Indexed streams: several writers sharing one directory (a serving fleet's
router and its replicas) each write their own files,
``telemetry.<process_index>.jsonl`` and ``heartbeat.<process_index>.json``,
named by ``host_meta`` (``process_index``, ``process_count``, ...), and every
record and heartbeat carries that identity. A single writer
(``process_count`` absent or 1) keeps the bare names. ``discover_hosts`` and
``read_heartbeat(..., process_index=)`` read them back.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from typing import Dict, List, Optional

__all__ = ['TelemetryLogger', 'read_telemetry', 'read_heartbeat',
           'rotated_paths', 'discover_hosts', 'telemetry_filename',
           'heartbeat_filename', 'TELEMETRY_FILENAME', 'HEARTBEAT_FILENAME',
           'DEFAULT_MAX_BYTES', 'DEFAULT_MAX_ROTATED', 'HOST_META_KEYS']

TELEMETRY_FILENAME = 'telemetry.jsonl'
HEARTBEAT_FILENAME = 'heartbeat.json'

# Identity fields stamped into every record and heartbeat of an indexed
# stream.
HOST_META_KEYS = ('process_index', 'process_count', 'device_kind',
                  'hostname')

DEFAULT_MAX_BYTES = 256 * 2**20
DEFAULT_MAX_ROTATED = 2

_HOST_TELEMETRY_RE = re.compile(r'^telemetry\.(\d+)\.jsonl$')
_HOST_HEARTBEAT_RE = re.compile(r'^heartbeat\.(\d+)\.json$')


def _is_fleet_meta(host_meta: Optional[Dict[str, object]]) -> bool:
  """Whether this identity names one writer of several (indexed names)."""
  if not host_meta:
    return False
  return int(host_meta.get('process_count') or 1) > 1 and \
      host_meta.get('process_index') is not None


def telemetry_filename(host_meta: Optional[Dict[str, object]] = None) -> str:
  """``telemetry.<process_index>.jsonl`` for one writer of several, the
  bare ``telemetry.jsonl`` otherwise."""
  if _is_fleet_meta(host_meta):
    return 'telemetry.{}.jsonl'.format(int(host_meta['process_index']))
  return TELEMETRY_FILENAME


def heartbeat_filename(host_meta: Optional[Dict[str, object]] = None) -> str:
  """``heartbeat.<process_index>.json`` for one writer of several, the
  bare ``heartbeat.json`` otherwise."""
  if _is_fleet_meta(host_meta):
    return 'heartbeat.{}.json'.format(int(host_meta['process_index']))
  return HEARTBEAT_FILENAME


class TelemetryLogger:
  """Appends telemetry records and keeps the heartbeat of one process.

  Thread-safe within one process: ``log``, ``heartbeat`` and ``flush``
  take one lock, so the serve loop and a hot-swap poller cannot interleave
  a record mid-line or race the rotation. Writers sharing a directory each
  pass their own ``host_meta``: one of several writes the indexed files
  and stamps ``HOST_META_KEYS`` into every record and heartbeat.
  """

  def __init__(self, model_dir: str,
               max_bytes: Optional[int] = DEFAULT_MAX_BYTES,
               max_rotated: int = DEFAULT_MAX_ROTATED,
               host_meta: Optional[Dict[str, object]] = None):
    os.makedirs(model_dir, exist_ok=True)
    self.model_dir = model_dir
    self.max_bytes = None if max_bytes is None else int(max_bytes)
    self.max_rotated = max(1, int(max_rotated))
    self._lock = threading.Lock()
    self.host_meta = {key: host_meta[key] for key in HOST_META_KEYS
                      if key in host_meta} if host_meta else None
    self._path = os.path.join(model_dir, telemetry_filename(host_meta))
    self._heartbeat_path = os.path.join(model_dir,
                                        heartbeat_filename(host_meta))
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
    if self.host_meta:
      record.update(self.host_meta)
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
    if self.host_meta:
      beat.update(self.host_meta)
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


def rotated_paths(path: str) -> List[str]:
  """Existing generations of one telemetry file, oldest first, ending with
  the live ``path``: ``[telemetry.jsonl.2, telemetry.jsonl.1,
  telemetry.jsonl]``."""
  out: List[str] = []
  index = 1
  while os.path.exists('{}.{}'.format(path, index)):
    out.append('{}.{}'.format(path, index))
    index += 1
  out.reverse()
  out.append(path)
  return out


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
  generations = [p for p in rotated_paths(path) if os.path.exists(p)]
  if not generations:
    raise FileNotFoundError(path)
  records: List[Dict[str, object]] = []
  for generation in generations:
    records.extend(_read_one(generation))
  return records


def read_heartbeat(model_dir: str,
                   process_index: Optional[int] = None
                   ) -> Optional[Dict[str, object]]:
  """The last heartbeat written under ``model_dir``, or None.

  ``process_index`` selects one writer's ``heartbeat.<i>.json``; without
  it, writer 0's indexed file, else the bare ``heartbeat.json``. An
  indexed file wins over the bare name: a directory holding both saw a
  single writer before several, and the indexed one is the live one.
  """
  if process_index is not None:
    candidates = ['heartbeat.{}.json'.format(int(process_index))]
    if int(process_index) == 0:
      candidates.append(HEARTBEAT_FILENAME)
  else:
    candidates = ['heartbeat.0.json', HEARTBEAT_FILENAME]
  for name in candidates:
    path = os.path.join(model_dir, name)
    if os.path.exists(path):
      try:
        with open(path, encoding='utf-8') as f:
          return json.load(f)
      except ValueError:
        return None  # mid-replace race or torn tmp: treat as absent
  return None


def discover_hosts(model_dir: str) -> Dict[int, Dict[str, Optional[str]]]:
  """Each writer's live files under one directory:
  ``{process_index: {'telemetry': path or None, 'heartbeat': path or
  None}}``. The bare names map to writer 0 unless an indexed writer-0 file
  exists; rotated generations belong to their live file."""
  hosts: Dict[int, Dict[str, Optional[str]]] = {}

  def slot(index: int) -> Dict[str, Optional[str]]:
    return hosts.setdefault(int(index), {'telemetry': None,
                                         'heartbeat': None})

  try:
    names = sorted(os.listdir(model_dir))
  except OSError:
    return hosts
  for name in names:
    match = _HOST_TELEMETRY_RE.match(name)
    if match:
      slot(int(match.group(1)))['telemetry'] = os.path.join(model_dir, name)
      continue
    match = _HOST_HEARTBEAT_RE.match(name)
    if match:
      slot(int(match.group(1)))['heartbeat'] = os.path.join(model_dir, name)
  for key, name in (('telemetry', TELEMETRY_FILENAME),
                    ('heartbeat', HEARTBEAT_FILENAME)):
    bare = os.path.join(model_dir, name)
    if os.path.exists(bare) and not hosts.get(0, {}).get(key):
      slot(0)[key] = bare
  return hosts
