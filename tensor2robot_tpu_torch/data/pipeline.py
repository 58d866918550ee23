"""The Python record pipeline: glob, interleave, shuffle, parse, batch
(the JAX package's ``data/pipeline.py``).

Records stream from TFRecord shards by a round-robin interleave of four
files at a time and a bounded shuffle buffer; several datasets zip, one
record of each a row; the ``ExampleParser`` turns each batch of records
into spec-conforming numpy. Each of N readers takes every N-th file
(``shard_index::num_shards``). Batches are made on demand: the input
generator's prefetch thread runs them ahead of the trainer.
"""

from __future__ import annotations

import glob as glob_lib
import random
from typing import Dict, Iterator, List, Optional, Sequence, Union

from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data.parser import ExampleParser

__all__ = ['BatchedExampleStream', 'RecordDataset', 'parse_file_patterns']

_SUPPORTED_FORMATS = ('tfrecord',)


def parse_file_patterns(file_patterns: Union[str, Sequence[str]]):
  """``'tfrecord:/path/a*,/path/b*'``-style patterns as ``(format,
  files)``: comma-separated, each glob's matches sorted, an optional
  ``<format>:`` prefix."""
  if isinstance(file_patterns, str):
    patterns = [p for p in file_patterns.split(',') if p]
  else:
    patterns = list(file_patterns)
  data_format = 'tfrecord'
  filenames: List[str] = []
  for pattern in patterns:
    if ':' in pattern and pattern.split(':', 1)[0] in _SUPPORTED_FORMATS:
      data_format, pattern = pattern.split(':', 1)
    matched = sorted(glob_lib.glob(pattern))
    if not matched and glob_lib.has_magic(pattern):
      raise ValueError('No files match pattern {!r}.'.format(pattern))
    filenames.extend(matched if matched else [pattern])
  if not filenames:
    raise ValueError('Empty file pattern {!r}.'.format(file_patterns))
  return data_format, filenames


def _interleaved_records(filenames: List[str], cycle_length: int = 4,
                         shuffle_files: bool = False,
                         seed: Optional[int] = None,
                         skip_corrupt: bool = False,
                         quarantine=None) -> Iterator[bytes]:
  """Round-robin over ``cycle_length`` open files; a finished file's place
  goes to the next one."""
  files = list(filenames)
  if shuffle_files:
    random.Random(seed).shuffle(files)

  def reader(path):
    return tfrecord.tfrecord_iterator(path, verify_crc=True,
                                      skip_corrupt=skip_corrupt,
                                      quarantine=quarantine)

  pending = iter(files)
  active = [reader(path) for path in (next(pending, None)
                                      for _ in range(cycle_length))
            if path is not None]
  while active:
    done = []
    for it in active:
      record = next(it, None)
      if record is None:
        done.append(it)
      else:
        yield record
    for it in done:
      active.remove(it)
      path = next(pending, None)
      if path is not None:
        active.append(reader(path))


def _shuffled(records: Iterator[bytes], buffer_size: int,
              seed: Optional[int]) -> Iterator[bytes]:
  """A bounded reservoir shuffle."""
  rng = random.Random(seed)
  buf: List[bytes] = []
  for record in records:
    buf.append(record)
    if len(buf) >= buffer_size:
      idx = rng.randrange(len(buf))
      buf[idx], buf[-1] = buf[-1], buf[idx]
      yield buf.pop()
  rng.shuffle(buf)
  yield from buf


class RecordDataset:
  """One dataset: the TFRecord shards of a file pattern, this reader's
  share of them."""

  def __init__(self, file_patterns: Union[str, Sequence[str]],
               dataset_key: str = '', shard_index: int = 0,
               num_shards: int = 1, skip_corrupt_records: bool = False,
               quarantine: Optional[tfrecord.RecordQuarantine] = None):
    self.data_format, filenames = parse_file_patterns(file_patterns)
    self.filenames = filenames[shard_index::num_shards]
    if not self.filenames:
      raise ValueError('Reader {} of {} has no files: only {} file(s) '
                       'matched.'.format(shard_index, num_shards,
                                         len(filenames)))
    self.dataset_key = dataset_key
    self.skip_corrupt_records = skip_corrupt_records
    if skip_corrupt_records and quarantine is None:
      quarantine = tfrecord.RecordQuarantine()
    self.quarantine = quarantine

  def iter_records(self, shuffle: bool = False, shuffle_buffer: int = 500,
                   num_epochs: Optional[int] = None,
                   seed: Optional[int] = None) -> Iterator[bytes]:
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
      epoch_seed = None if seed is None else seed + epoch
      records = _interleaved_records(
          self.filenames, shuffle_files=shuffle, seed=epoch_seed,
          skip_corrupt=self.skip_corrupt_records, quarantine=self.quarantine)
      if shuffle:
        records = _shuffled(records, shuffle_buffer, epoch_seed)
      yield from records
      epoch += 1


class BatchedExampleStream:
  """Zips datasets, batches their records and parses each batch; the last
  partial batch is dropped unless ``drop_remainder`` is False."""

  def __init__(self, datasets: Union[RecordDataset, Dict[str, RecordDataset]],
               parser: ExampleParser, batch_size: int, shuffle: bool = False,
               shuffle_buffer: int = 500, num_epochs: Optional[int] = None,
               seed: Optional[int] = None, drop_remainder: bool = True):
    if isinstance(datasets, RecordDataset):
      datasets = {datasets.dataset_key: datasets}
    self._datasets = datasets
    self._parser = parser
    self._batch_size = int(batch_size)
    self._shuffle = shuffle
    self._shuffle_buffer = shuffle_buffer
    self._num_epochs = num_epochs
    self._seed = seed
    self._drop_remainder = drop_remainder

  def _record_tuples(self) -> Iterator[Dict[str, bytes]]:
    iters = {key: ds.iter_records(self._shuffle, self._shuffle_buffer,
                                  self._num_epochs, self._seed)
             for key, ds in self._datasets.items()}
    while True:
      row = {}
      for key, it in iters.items():
        record = next(it, None)
        if record is None:
          return  # the zip ends with the shortest dataset
        row[key] = record
      yield row

  def _parse(self, rows: List[Dict[str, bytes]]):
    by_key = {key: [row[key] for row in rows] for key in rows[0]}
    if list(by_key) == ['']:
      return self._parser.parse_batch(by_key[''])
    return self._parser.parse_batch(by_key)

  def __iter__(self):
    pending: List[Dict[str, bytes]] = []
    for row in self._record_tuples():
      pending.append(row)
      if len(pending) == self._batch_size:
        yield self._parse(pending)
        pending = []
    if pending and not self._drop_remainder:
      yield self._parse(pending)
