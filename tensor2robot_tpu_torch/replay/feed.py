"""The learner's replay feed: sampled batches into the trainer (the JAX
package's ``replay/feed.py``).

Batches a client samples from the service become ``(features, labels)``
dicts in the native loader's layout, so that they go through the trainer's
feed (``data/device_feed.py``) as a disk batch would.

``ReplayInputGenerator`` is the input generator of a trainer fed from
replay: its iterator samples forever, so ``max_train_steps`` (not epochs)
bounds the run.

Kept deviation: the JAX feed meters its draws as the pipeline X-ray's
``read`` stage (``StageMeter('read')``); the port has no X-ray, so the
iterator meters nothing.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

from tensor2robot_tpu_torch.data.input_generators import AbstractInputGenerator
from tensor2robot_tpu_torch.replay.client import LocalReplayClient, ReplayClient
from tensor2robot_tpu_torch.replay.service import ReplayService, SampleBatch
from tensor2robot_tpu_torch.specs import algebra

__all__ = ['ReplayBatchIterator', 'ReplayInputGenerator', 'to_batch_dicts']


def to_batch_dicts(batch: SampleBatch):
  """A sampled batch as (features, labels) dicts."""
  return dict(batch.features), dict(batch.labels)


class ReplayBatchIterator:
  """Iterator of (features, labels) batches from a client.

  ``num_batches=None`` iterates forever (the replay stream has no epochs).
  The first draw ``wait``s for the store to fill (a learner booting before
  its collectors); later draws fail fast, so that a drained store surfaces
  instead of hanging.
  """

  def __init__(self, client, batch_size: int,
               num_batches: Optional[int] = None,
               wait_timeout_s: float = 60.0):
    self._client = client
    self._batch_size = int(batch_size)
    self._num_batches = num_batches
    self._wait_timeout_s = float(wait_timeout_s)
    self._drawn = 0

  def __iter__(self):
    return self

  def __next__(self):
    if self._num_batches is not None and self._drawn >= self._num_batches:
      raise StopIteration
    batch = self._client.sample(self._batch_size,
                                wait=self._drawn == 0,
                                wait_timeout_s=self._wait_timeout_s)
    self._drawn += 1
    return to_batch_dicts(batch)


class ReplayInputGenerator(AbstractInputGenerator):
  """Feeds a trainer from a replay endpoint (or an in-process service).

  ``endpoint``: a ``host:port`` / ``http://...`` replay service, a client,
  or a :class:`ReplayService` (wrapped in a LocalReplayClient). Batches are
  validated against the model's specifications unless they carry packed or
  sparse coefficient groups, which the device unpacks (as the native
  loader's coefficient batches are).
  """

  def __init__(self, endpoint: Union[str, ReplayService, object],
               batch_size: int = 32,
               prefetch: int = 2,
               wait_timeout_s: float = 60.0):
    super().__init__(batch_size=batch_size, prefetch=prefetch)
    if isinstance(endpoint, str):
      self._client = ReplayClient(endpoint)
    elif isinstance(endpoint, ReplayService):
      self._client = LocalReplayClient(endpoint)
    else:
      self._client = endpoint  # anything with the client API
    self._wait_timeout_s = float(wait_timeout_s)

  @property
  def client(self):
    return self._client

  def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                       num_shards, device) -> Iterator:
    # num_epochs bounds batches here (a stream has no epochs); None samples
    # until the trainer stops.
    del mode, seed, frames, shard_index, num_shards, device
    iterator = ReplayBatchIterator(self._client, self._batch_size,
                                   num_batches=num_epochs,
                                   wait_timeout_s=self._wait_timeout_s)
    feature_spec, label_spec = self._feature_spec, self._label_spec

    for features, labels in iterator:
      if any(key.endswith(('/pw', '/sd')) for key in features):
        yield features, labels
        continue
      features = algebra.validate_and_pack(feature_spec, features,
                                           ignore_batch=True)
      if labels is not None and label_spec:
        labels = algebra.validate_and_pack(label_spec, labels,
                                           ignore_batch=True)
      yield features, labels
