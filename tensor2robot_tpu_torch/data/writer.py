"""TFRecordReplayWriter: serialized Examples, or spec-conforming numpy, to
a TFRecord file (the JAX package's ``data/writer.py``)."""

from __future__ import annotations

from typing import Optional

from tensor2robot_tpu_torch.data.parser import build_example_for_specs
from tensor2robot_tpu_torch.data.tfrecord import TFRecordWriter

__all__ = ['TFRecordReplayWriter']


class TFRecordReplayWriter:
  """Writes serialized tf.Example bytes, or encodes numpy by specs."""

  def __init__(self):
    self._writer: Optional[TFRecordWriter] = None

  def open(self, path: str) -> None:
    self.close()
    self._writer = TFRecordWriter(path)

  def write(self, serialized_records) -> None:
    """Writes one record or a list of records (bytes)."""
    if self._writer is None:
      raise ValueError('open() must be called before write().')
    if isinstance(serialized_records, bytes):
      serialized_records = [serialized_records]
    for record in serialized_records:
      self._writer.write(record)

  def write_numpy(self, spec_structure, numpy_struct) -> None:
    self.write(build_example_for_specs(spec_structure, numpy_struct))

  def flush(self) -> None:
    if self._writer is not None:
      self._writer.flush()

  def close(self) -> None:
    if self._writer is not None:
      self._writer.close()
      self._writer = None

  def __enter__(self):
    return self

  def __exit__(self, *_):
    self.close()
