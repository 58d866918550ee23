"""Host-to-device batch feeds: the copy to the model's device, metered,
and the unpack of the split decode's coefficient streams.

The counterpart of the JAX package's ``data/device_feed.py``. Every batch
that the trainer ships goes through a feed's ``put_batch``:

  * ``HostDeviceFeed`` copies a ``(features, labels)`` pair of numpy dicts
    to the device. To a CUDA device each array goes through a pinned
    staging buffer (two sets used in turn; a set is refilled only once its
    last copy's event has fired) on a copy stream of its own; the tensors
    are allocated on that stream and recorded on the consumer's stream,
    and an event that the consumer's stream waits on hands them over: the
    host does not wait for the copy. Each batch's copies are timed on the
    card by events into the ``pipeline/transfer/ms`` histogram. A CPU
    device takes the arrays as tensors.
  * ``SparseCoefFeed`` (the feed of a ``DeviceDecodePreprocessor``) also
    unpacks the sparse and packed wires, whose widths are the loader's
    bucket a batch, to the fixed-shape dense planes (``key/{y, cb, cr}``,
    the packed wire's one table broadcast to ``[B, 3, 64]``): after the
    timed copies, on the copy stream, so that the step sees one shape. The
    ``data/feed_shape_signatures`` gauge counts the distinct shapes of the
    train channel's batches after it, which must stay 1.
  * ``PipelinedFeed`` runs a feed ``depth`` batches ahead in a thread, in
    order: the copies and the unpacks overlap the device's steps.

There is no CPU carry-on: a CUDA feed gives CUDA tensors or raises. The
``data.stall`` fault site fires before each batch's transfer (a host sleep
of ``DATA_STALL_SECONDS``: in the producer thread under ``PipelinedFeed``).
Not ported: the JAX feed's pipeline X-ray stage meter (the port has no
X-ray yet).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data import jpeg_device
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.observability.spans import SPAN_BUCKETS_MS
from tensor2robot_tpu_torch.reliability import fault_injection

__all__ = ['FEED_SHAPES_GAUGE', 'TRANSFER_MS_HISTOGRAM', 'HostDeviceFeed',
           'PipelinedFeed', 'SparseCoefFeed', 'feed_for_model']

FEED_SHAPES_GAUGE = 'data/feed_shape_signatures'
TRANSFER_MS_HISTOGRAM = 'pipeline/transfer/ms'

Batch = Tuple[Optional[Dict[str, np.ndarray]], Optional[Dict[str, np.ndarray]]]


class HostDeviceFeed:
  """The plain host-to-device hop (see the module's note)."""

  # Sets of pinned staging buffers, used in turn: the host fills one while
  # the copy from the other may still run.
  STAGING_SETS = 2

  def __init__(self, device):
    self.device = torch.device(device)
    if self.device.type == 'cuda' and self.device.index is None:
      self.device = torch.device('cuda', torch.cuda.current_device())
    self._transfer_ms = get_registry().histogram(TRANSFER_MS_HISTOGRAM,
                                                 bounds=SPAN_BUCKETS_MS)
    self._stream = None
    self._consumer = None
    if self.device.type == 'cuda':
      self._stream = torch.cuda.Stream(self.device)
      # The stream that takes the batches: the constructing thread's.
      self._consumer = torch.cuda.current_stream(self.device)
    # Each set's buffers by (side, key), and its last copy's timing events
    # (None once waited for).
    self._staging = [{} for _ in range(self.STAGING_SETS)]
    self._copies = [None] * self.STAGING_SETS
    self._next_set = 0
    self._lock = threading.Lock()   # one transfer at a time: the staging
    self._hops = collections.deque(maxlen=1024)  # ms, the last hops

  def transfer_ms(self) -> Optional[float]:
    """The median ms of this feed's hops (None before the first): a
    batch's copies on the card (its host-to-device conversion on the
    CPU)."""
    with self._lock:
      for index in range(self.STAGING_SETS):
        self._settle(index)
    if not self._hops:
      return None
    return float(np.median(self._hops))

  def put_batch(self, batch: Batch, channel: str = 'train') -> Batch:
    """One ``(features, labels)`` batch on the device, ready for the
    calling thread's stream."""
    device_batch, ready = self.transfer(batch, channel)
    self.wait(ready)
    return device_batch

  def wait(self, ready) -> None:
    """Makes the calling thread's stream wait for a transferred batch."""
    if ready is not None:
      torch.cuda.current_stream(self.device).wait_event(ready)

  def transfer(self, batch: Batch, channel: str = 'train'):
    """``(device batch, ready event)``: the copies, then the feed's device
    work (``_finish``), queued on the copy stream without waiting for
    them; the event (None on the CPU) marks the batch ready. The
    ``data.stall`` site sleeps first where it fires."""
    stall_s = fault_injection.stall_data_seconds()
    if stall_s > 0.0:
      time.sleep(stall_s)
    with self._lock:
      return self._transfer(batch, channel)

  def _transfer(self, batch: Batch, channel: str):
    if self._stream is None:
      start = time.perf_counter()
      device_batch = tuple(None if part is None else {
          key: torch.from_numpy(np.ascontiguousarray(value)).to(self.device)
          for key, value in part.items()} for part in batch)
      self._record_hop((time.perf_counter() - start) * 1e3)
      return self._finish(device_batch, channel), None
    index = self._next_set
    self._next_set = (index + 1) % self.STAGING_SETS
    # The set's buffers are refilled only once their last copy is done.
    self._settle(index)
    with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
      start = torch.cuda.Event(enable_timing=True)
      start.record(self._stream)
      device_batch = tuple(None if part is None else {
          key: self._copy(self._staging[index], side, key, value)
          for key, value in part.items()}
          for side, part in zip(('features', 'labels'), batch))
      end = torch.cuda.Event(enable_timing=True)
      end.record(self._stream)
      self._copies[index] = (start, end)
      device_batch = self._finish(device_batch, channel)
      for part in device_batch:
        for tensor in (part or {}).values():
          # Freed only once the consumer's queued work is done with it.
          tensor.record_stream(self._consumer)
      ready = torch.cuda.Event()
      ready.record(self._stream)
    return device_batch, ready

  def _settle(self, index: int) -> None:
    """Waits for staging set ``index``'s last copy and records its time."""
    if self._copies[index] is not None:
      start, end = self._copies[index]
      end.synchronize()
      self._record_hop(start.elapsed_time(end))
      self._copies[index] = None

  def _record_hop(self, ms: float) -> None:
    self._hops.append(ms)
    self._transfer_ms.record(ms)

  def _copy(self, staging: Dict[Tuple[str, str], torch.Tensor], side: str,
            key: str, value) -> torch.Tensor:
    """One array to the device through its pinned staging buffer in
    ``staging``, on the copy stream (the caller's)."""
    array = np.ascontiguousarray(value)
    source = torch.from_numpy(array)
    buffer = staging.get((side, key))
    if buffer is None or buffer.numel() < array.nbytes:
      buffer = torch.empty(max(array.nbytes, 1), dtype=torch.uint8,
                           pin_memory=True)
      staging[(side, key)] = buffer
    pinned = buffer[:array.nbytes].view(source.dtype).view(source.shape)
    pinned.copy_(source)
    out = torch.empty(source.shape, dtype=source.dtype, device=self.device)
    out.copy_(pinned, non_blocking=True)
    return out

  def _finish(self, device_batch: Batch, channel: str) -> Batch:
    """Device work after the copy; none for the plain feed."""
    del channel
    return device_batch


class SparseCoefFeed(HostDeviceFeed):
  """The feed of the split decode: copies, then unpacks the sparse and
  packed coefficient wires (see the module's note)."""

  def __init__(self, image_shapes: Dict[str, Tuple[int, int]], device):
    super().__init__(device)
    self._shapes = dict(image_shapes)
    self._signatures: Dict[str, set] = {}
    self._shape_gauge = get_registry().gauge(FEED_SHAPES_GAUGE)

  def _finish(self, device_batch: Batch, channel: str) -> Batch:
    features, labels = device_batch
    if features is not None:
      features = dict(features)
      sparse = {k: v for k, v in self._shapes.items()
                if k + '/sd' in features}
      packed = {k: v for k, v in self._shapes.items()
                if k + '/pw' in features}
      features = jpeg_device.unpack_sparse_features(features, sparse)
      features = jpeg_device.unpack_packed_features(features, packed)
      self._record_signature(features, channel)
    return features, labels

  def _record_signature(self, features, channel: str) -> None:
    """Counts the distinct (name, shape) sets of a channel's batches; the
    gauge shows the train channel's."""
    signature = tuple(sorted((key, tuple(value.shape))
                             for key, value in features.items()))
    self._signatures.setdefault(channel, set()).add(signature)
    self._shape_gauge.set(float(len(self._signatures.get('train', ()))))


def feed_for_model(model) -> HostDeviceFeed:
  """The feed of ``model``: a ``SparseCoefFeed`` for the split decode's
  preprocessor, else the plain one, on the model's device."""
  from tensor2robot_tpu_torch.preprocessors.device_decode import (
      DeviceDecodePreprocessor)

  if isinstance(model.preprocessor, DeviceDecodePreprocessor):
    return SparseCoefFeed(model.preprocessor.image_shapes('train'),
                          model.device)
  return HostDeviceFeed(model.device)


class PipelinedFeed:
  """``depth`` batches transferred ahead of the consumer, in a thread.

  One producer thread draws from ``batch_iterator`` and transfers each
  batch through ``feed`` (copy and unpack on the feed's stream), strictly
  in order; ``get`` hands the next one over, its stream waiting on the
  batch's event. At most ``depth`` transferred batches wait, plus the one
  in flight. A producer's error (the end of the iterator's data
  included) is raised at ``get``; ``close`` stops the thread, which
  closes ``batch_iterator``.
  """

  def __init__(self, batch_iterator, feed: HostDeviceFeed, depth: int = 2,
               channel: str = 'train'):
    self._feed = feed
    self._depth = max(1, int(depth))
    self._buffer = []
    self._lock = threading.Condition()
    self._stopped = False
    self._done = False
    self._errors = []

    def produce():
      try:
        if feed.device.type == 'cuda':
          torch.cuda.set_device(feed.device)
        for batch in batch_iterator:
          transferred = feed.transfer(batch, channel)
          with self._lock:
            while len(self._buffer) >= self._depth and not self._stopped:
              self._lock.wait(0.05)
            if self._stopped:
              return
            self._buffer.append(transferred)
            self._lock.notify_all()
      except BaseException as e:  # noqa: BLE001 — raised at get()
        with self._lock:
          self._errors.append(e)
          self._lock.notify_all()
      finally:
        close = getattr(batch_iterator, 'close', None)
        if close is not None:
          close()
        with self._lock:
          self._done = True
          self._lock.notify_all()

    self._thread = threading.Thread(target=produce, daemon=True,
                                    name='t2r-torch-device-feed')
    self._thread.start()

  def get(self) -> Batch:
    """The next device batch; StopIteration at the end of the data."""
    with self._lock:
      while True:
        if self._buffer:
          device_batch, ready = self._buffer.pop(0)
          self._lock.notify_all()
          break
        if self._errors:
          raise self._errors[0]
        if self._done:
          raise StopIteration
        self._lock.wait(0.05)
    self._feed.wait(ready)
    return device_batch

  def __iter__(self):
    return self

  def __next__(self) -> Batch:
    return self.get()

  def close(self, timeout: float = 60.0) -> bool:
    """Stops the producer; whether its thread ended in time."""
    with self._lock:
      self._stopped = True
      self._buffer.clear()
      self._lock.notify_all()
    self._thread.join(timeout=timeout)
    return not self._thread.is_alive()
