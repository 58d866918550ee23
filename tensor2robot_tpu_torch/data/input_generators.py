"""Input generators: batches of numpy arrays that match a model's
in-specifications (the JAX package's ``data/input_generators.py``, the
generator-backed part; reading records from disk is a later slice).

  * ``AbstractInputGenerator`` takes its specifications from the model's
    preprocessor (what the preprocessor consumes, not what the network
    does) and yields ``(features, labels)`` dicts, validated against them,
    optionally made ahead in a background thread (``prefetch``);
  * ``GeneratorInputGenerator`` wraps a ``batch_generator_fn(batch_size)``;
  * ``DefaultRandomInputGenerator`` draws spec-conforming random batches,
    batch ``i`` of an iterator seeded ``seed`` from features seed
    ``seed + i`` and labels seed ``seed + i + 977``: array for array the
    JAX generator's.

An iterator given ``frames`` (a ``FrameShard``: the keys whose first
per-example axis is the episode's frames, and a range of those frames)
yields only those frames of the frame keys, the other keys whole: the
share of one rank of a sequence-parallel group. The random generator draws
episodes frame by frame (``generators.make_random_frames``), so a rank
draws only its own frames, and the shares of the ranks concatenate to the
batch that one rank would draw alone.
"""

from __future__ import annotations

import abc
import queue
import threading
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import generators

__all__ = ['AbstractInputGenerator', 'DefaultRandomInputGenerator',
           'FrameShard', 'GeneratorInputGenerator', 'prefetch_iterator']


class FrameShard(NamedTuple):
  """Frames ``[start, stop)`` of the arrays keyed in ``keys``, whose first
  per-example axis (axis 1 of a batch) is the episode's frames."""
  keys: Tuple[str, ...]
  start: int
  stop: int

  def spec(self, spec):
    """``spec`` with the frame keys cut to this shard's frames."""
    return {key: ((self.stop - self.start,) + tuple(shape[1:]), dtype)
            if key in self.keys else (shape, dtype)
            for key, (shape, dtype) in spec.items()}

  def cut(self, arrays):
    """This shard's frames of a batch of whole episodes."""
    return {key: value[:, self.start:self.stop] if key in self.keys
            else value for key, value in arrays.items()}


def prefetch_iterator(iterator: Iterator, depth: int) -> Iterator:
  """Runs ``iterator`` ``depth`` items ahead in a daemon thread.

  An error in the producer is raised at the consumer; closing the returned
  generator (or dropping it) stops the producer at its next item.
  """
  items: queue.Queue = queue.Queue(maxsize=depth)
  stop = threading.Event()
  done = object()
  errors = []

  def put(item) -> bool:
    while not stop.is_set():
      try:
        items.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def produce():
    try:
      for item in iterator:
        if not put(item):
          return
    except Exception as e:  # noqa: BLE001 — raised again at the consumer
      errors.append(e)
    put(done)

  thread = threading.Thread(target=produce, daemon=True,
                            name='t2r-torch-prefetch')
  thread.start()

  def consume():
    try:
      while True:
        item = items.get()
        if item is done:
          if errors:
            raise errors[0]
          return
        yield item
    finally:
      stop.set()

  return consume()


class AbstractInputGenerator(abc.ABC):
  """Binds a model's preprocessor in-specifications to a batch source."""

  def __init__(self, batch_size: int = 32, prefetch: int = 2):
    self._batch_size = int(batch_size)
    self._prefetch = int(prefetch)
    self._feature_spec = None
    self._label_spec = None

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def feature_spec(self):
    return self._feature_spec

  @property
  def label_spec(self):
    return self._label_spec

  def set_specification_from_model(self, model, mode: str) -> None:
    """Takes the specifications the model's preprocessor consumes."""
    if mode not in ModeKeys.ALL:
      raise ValueError('mode must be one of {}, not {!r}.'.format(
          ModeKeys.ALL, mode))
    preprocessor = model.preprocessor
    self.set_specification(preprocessor.get_in_feature_specification(mode),
                           preprocessor.get_in_label_specification(mode))

  def set_specification(self, feature_spec, label_spec) -> None:
    self._feature_spec = dict(feature_spec)
    self._label_spec = dict(label_spec)

  def create_dataset_iterator(self, mode: str,
                              num_epochs: Optional[int] = None,
                              seed: Optional[int] = None,
                              prefetch: Optional[int] = None,
                              frames: Optional[FrameShard] = None
                              ) -> Iterator:
    """Yields (features, labels) numpy dicts; ``num_epochs`` None is
    endless, ``prefetch`` None takes the generator's default (0 makes
    each batch on demand), and ``frames`` keeps only a shard of the
    episodes' frames."""
    if self._feature_spec is None:
      raise ValueError('set_specification(_from_model) must be called '
                       'before creating a dataset iterator.')
    iterator = self._create_iterator(mode, num_epochs, seed, frames)
    depth = self._prefetch if prefetch is None else prefetch
    if depth > 0:
      iterator = prefetch_iterator(iterator, depth)
    return iterator

  @abc.abstractmethod
  def _create_iterator(self, mode: str, num_epochs: Optional[int],
                       seed: Optional[int],
                       frames: Optional[FrameShard]) -> Iterator:
    ...


class GeneratorInputGenerator(AbstractInputGenerator):
  """Wraps ``batch_generator_fn(batch_size) -> features or (features,
  labels)``."""

  def __init__(self, batch_generator_fn: Optional[Callable] = None,
               batch_size: int = 32, prefetch: int = 2):
    super().__init__(batch_size=batch_size, prefetch=prefetch)
    self._batch_generator_fn = batch_generator_fn

  def _generate_batch(self, seed: Optional[int],
                      frames: Optional[FrameShard] = None):
    """One batch, of ``frames`` only where given: the function draws whole
    episodes, and this keeps the shard."""
    if self._batch_generator_fn is None:
      raise NotImplementedError(
          'Provide batch_generator_fn or override _generate_batch.')
    batch = self._batch_generator_fn(self._batch_size)
    if frames is None:
      return batch
    if isinstance(batch, tuple):
      return tuple(None if part is None else frames.cut(part)
                   for part in batch)
    return frames.cut(batch)

  def _create_iterator(self, mode, num_epochs, seed, frames):
    del mode
    feature_spec, label_spec = self._feature_spec, self._label_spec
    if frames is not None:
      feature_spec, label_spec = frames.spec(feature_spec), frames.spec(
          label_spec)
    step = 0
    while num_epochs is None or step < num_epochs:
      batch_seed = None if seed is None else seed + step
      batch = self._generate_batch(batch_seed, frames)
      features, labels = batch if isinstance(batch, tuple) else (batch, None)
      features = generators.validate_batch(feature_spec, features)
      if labels is not None and label_spec:
        labels = generators.validate_batch(label_spec, labels)
      yield features, labels
      step += 1


class DefaultRandomInputGenerator(GeneratorInputGenerator):
  """Spec-conforming random batches; with ``frames``, only that shard of
  the frames drawn."""

  def _generate_batch(self, seed: Optional[int],
                      frames: Optional[FrameShard] = None):
    label_seed = None if seed is None else seed + 977
    if frames is None:
      return (generators.make_random_numpy(self._feature_spec,
                                           self._batch_size, seed),
              generators.make_random_numpy(self._label_spec,
                                           self._batch_size, label_seed))
    return tuple(generators.make_random_frames(
        spec, self._batch_size, part_seed, frames.keys, frames.start,
        frames.stop) for spec, part_seed in ((self._feature_spec, seed),
                                             (self._label_spec, label_seed)))
