"""MetricsWriter: TensorBoard event files without TensorFlow (the JAX
package's ``trainer/metrics.py``).

Scalars, images and histograms go into ``events.out.tfevents.*`` files,
framed by the port's own TFRecord writer (``data/tfrecord.py``) and
encoded with its wire helpers (``data/wire.py``); TensorBoard reads them.
The trainer writes its log windows' scalars under ``model_dir`` and its
evals' under ``model_dir/eval``. A file's name carries the wall-clock
second, the host and the process id, so that two processes (a trainer and
a continuous eval) never write one file.

Event wire layout (tensorflow/core/util/event.proto):
  Event { double wall_time=1; int64 step=2; string file_version=3;
          Summary summary=5; }
  Summary { repeated Value value=1; }
  Value { string tag=1; float simple_value=2; Image image=4;
          HistogramProto histo=5; }
  Image { int32 height=1; int32 width=2; int32 colorspace=3;
          bytes encoded_image_string=4; }
  HistogramProto { double min=1..sum_squares=5;
                   repeated double bucket_limit=6, bucket=7 (packed); }
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Dict, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.data.tfrecord import TFRecordWriter
from tensor2robot_tpu_torch.data.tfrecord import tfrecord_iterator

__all__ = ['MetricsWriter', 'read_events']

emit_bytes_field = wire._emit_bytes_field
iter_fields = wire._iter_fields
write_varint = wire.write_varint


def _emit_varint_field(out: bytearray, field: int, value: int) -> None:
  write_varint(out, (field << 3) | 0)
  write_varint(out, value & 0xFFFFFFFFFFFFFFFF)


def _emit_double_field(out: bytearray, field: int, value: float) -> None:
  write_varint(out, (field << 3) | 1)
  out.extend(struct.pack('<d', value))


def _emit_float_field(out: bytearray, field: int, value: float) -> None:
  write_varint(out, (field << 3) | 5)
  out.extend(struct.pack('<f', value))


def _encode_image(image: np.ndarray) -> bytes:
  """Summary.Image message for one [H, W, C] array (PNG-encoded)."""
  from PIL import Image as PILImage

  if image.dtype != np.uint8:
    image = (np.clip(np.asarray(image, np.float32), 0.0, 1.0)
             * 255.0).astype(np.uint8)
  if image.ndim == 3 and image.shape[-1] == 1:
    image = image[..., 0]
  buf = io.BytesIO()
  PILImage.fromarray(image).save(buf, format='PNG')
  out = bytearray()
  height, width = image.shape[:2]
  colorspace = 1 if image.ndim == 2 else image.shape[-1]
  _emit_varint_field(out, 1, height)
  _emit_varint_field(out, 2, width)
  _emit_varint_field(out, 3, colorspace)
  emit_bytes_field(out, 4, buf.getvalue())
  return bytes(out)


# TF's default histogram bucket boundaries: exponential, 1e-12 * 1.1^k.
def _default_bucket_limits() -> np.ndarray:
  positive = []
  v = 1e-12
  while v < 1e20:
    positive.append(v)
    v *= 1.1
  positive = np.asarray(positive)
  return np.concatenate([-positive[::-1], [0.0], positive, [np.inf]])


_BUCKET_LIMITS = _default_bucket_limits()


def _encode_histogram(values: np.ndarray) -> bytes:
  """HistogramProto message for a 1-D sample array."""
  values = np.asarray(values, np.float64).ravel()
  counts, _ = np.histogram(
      values, bins=np.concatenate([[-np.inf], _BUCKET_LIMITS]))
  nonzero = np.nonzero(counts)[0]
  out = bytearray()
  _emit_double_field(out, 1, float(values.min()) if values.size else 0.0)
  _emit_double_field(out, 2, float(values.max()) if values.size else 0.0)
  _emit_double_field(out, 3, float(values.size))
  _emit_double_field(out, 4, float(values.sum()))
  _emit_double_field(out, 5, float(np.sum(values ** 2)))
  if nonzero.size:
    last = nonzero[-1] + 1
    limits = bytearray()
    buckets = bytearray()
    for i in range(last):
      limits.extend(struct.pack('<d', min(_BUCKET_LIMITS[i], 1e308)))
      buckets.extend(struct.pack('<d', float(counts[i])))
    emit_bytes_field(out, 6, bytes(limits))  # packed repeated double
    emit_bytes_field(out, 7, bytes(buckets))
  return bytes(out)


def _encode_value(tag: str, *, simple_value: Optional[float] = None,
                  image: Optional[np.ndarray] = None,
                  histogram: Optional[np.ndarray] = None) -> bytes:
  out = bytearray()
  emit_bytes_field(out, 1, tag.encode('utf-8'))
  if simple_value is not None:
    _emit_float_field(out, 2, float(simple_value))
  if image is not None:
    emit_bytes_field(out, 4, _encode_image(image))
  if histogram is not None:
    emit_bytes_field(out, 5, _encode_histogram(histogram))
  return bytes(out)


def _encode_event(step: int, values: Sequence[bytes] = (),
                  file_version: Optional[str] = None,
                  wall_time: Optional[float] = None) -> bytes:
  out = bytearray()
  # wall-clock timestamp: TensorBoard's event wall_time field.
  _emit_double_field(out, 1, time.time() if wall_time is None else wall_time)
  _emit_varint_field(out, 2, int(step))
  if file_version is not None:
    emit_bytes_field(out, 3, file_version.encode('utf-8'))
  if values:
    summary = bytearray()
    for value in values:
      emit_bytes_field(summary, 1, value)
    emit_bytes_field(out, 5, bytes(summary))
  return bytes(out)


class MetricsWriter:
  """Writes TensorBoard event files into ``log_dir``."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    self.log_dir = log_dir
    filename = 'events.out.tfevents.{:d}.{}.{:d}'.format(
        int(time.time()), socket.gethostname(), os.getpid())
    self._writer = TFRecordWriter(os.path.join(log_dir, filename))
    self._writer.write(_encode_event(0, file_version='brain.Event:2'))

  def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
    values = [_encode_value(tag, simple_value=float(np.mean(value)))
              for tag, value in scalars.items()]
    self._writer.write(_encode_event(step, values))

  def write_images(self, step: int, images: Dict[str, np.ndarray],
                   max_outputs: int = 3) -> None:
    """Each entry is [N, H, W, C] (first ``max_outputs`` logged) or [H, W, C]."""
    values = []
    for tag, batch in images.items():
      batch = np.asarray(batch)
      if batch.ndim == 3:
        batch = batch[None]
      for i, image in enumerate(batch[:max_outputs]):
        suffix = '' if batch.shape[0] == 1 else '/{:d}'.format(i)
        values.append(_encode_value(tag + suffix, image=image))
    self._writer.write(_encode_event(step, values))

  def write_histograms(self, step: int,
                       histograms: Dict[str, np.ndarray]) -> None:
    values = [_encode_value(tag, histogram=np.asarray(value))
              for tag, value in histograms.items()]
    self._writer.write(_encode_event(step, values))

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()


def read_events(log_dir: str):
  """Parses all event files in a dir -> list of (step, {tag: value}).

  Scalar values come back as floats; images as {'png': bytes, 'height',
  'width'}; histograms as {'num', 'sum', 'min', 'max'}.
  """
  events = []
  for name in sorted(os.listdir(log_dir)):
    if 'tfevents' not in name:
      continue
    for record in tfrecord_iterator(os.path.join(log_dir, name)):
      step = 0
      tags: Dict[str, object] = {}
      summary_payload = None
      for field, wire_type, value in iter_fields(record, 0, len(record)):
        if field == 2 and wire_type == 0:
          step = value
        elif field == 5 and wire_type == 2:
          summary_payload = record[value[0]:value[1]]
      if summary_payload is None:
        continue
      for field, wire_type, value in iter_fields(summary_payload, 0,
                                                  len(summary_payload)):
        if field != 1 or wire_type != 2:
          continue
        tag, parsed = _parse_summary_value(
            summary_payload[value[0]:value[1]])
        if tag is not None:
          tags[tag] = parsed
      events.append((step, tags))
  return events


def _parse_summary_value(payload: bytes):

  def _bytes(span):
    return payload[span[0]:span[1]]

  tag = None
  parsed = None
  for field, wire_type, value in iter_fields(payload, 0, len(payload)):
    if field == 1 and wire_type == 2:
      tag = _bytes(value).decode('utf-8')
    elif field == 2 and wire_type == 5:
      parsed = struct.unpack('<f', _bytes(value))[0]
    elif field == 4 and wire_type == 2:
      sub = _bytes(value)
      image = {}
      for f2, w2, v2 in iter_fields(sub, 0, len(sub)):
        if f2 == 1 and w2 == 0:
          image['height'] = v2
        elif f2 == 2 and w2 == 0:
          image['width'] = v2
        elif f2 == 4 and w2 == 2:
          image['png'] = sub[v2[0]:v2[1]]
      parsed = image
    elif field == 5 and wire_type == 2:
      sub = _bytes(value)
      histo = {}
      names = {1: 'min', 2: 'max', 3: 'num', 4: 'sum', 5: 'sum_squares'}
      for f2, w2, v2 in iter_fields(sub, 0, len(sub)):
        if f2 in names and w2 == 1:
          histo[names[f2]] = struct.unpack('<d', sub[v2[0]:v2[1]])[0]
      parsed = histo
  return tag, parsed
