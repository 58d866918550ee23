"""Input generators: batches of numpy arrays that match a model's
in-specifications (the JAX package's ``data/input_generators.py``).

  * ``AbstractInputGenerator`` takes its specifications from the model's
    preprocessor (what the preprocessor consumes, not what the network
    does) and yields ``(features, labels)`` dicts, validated against them,
    optionally made ahead in a background thread (``prefetch``);
  * ``GeneratorInputGenerator`` wraps a ``batch_generator_fn(batch_size)``;
  * ``DefaultRandomInputGenerator`` draws spec-conforming random batches,
    batch ``i`` of an iterator seeded ``seed`` from features seed
    ``seed + i`` and labels seed ``seed + i + 977``: array for array the
    JAX generator's;
  * ``DefaultRecordInputGenerator`` reads TFRecord files (the data users
    train on) through the native loader or the Python parser, and
    ``FractionalRecordInputGenerator`` and
    ``MultiEvalRecordInputGenerator`` choose which files. Reader
    ``shard_index`` of ``num_shards`` reads every ``num_shards``-th file
    from its own on.

An iterator given ``frames`` (a ``FrameShard``: the keys whose first
per-example axis is the episode's frames, and a range of those frames)
yields only those frames of the frame keys, the other keys whole: the
share of one rank of a sequence-parallel group. The shares of the ranks
concatenate to the batch that one rank would read or draw alone.
"""

from __future__ import annotations

import abc
import json
import os
import queue
import threading
from typing import (Callable, Dict, Iterator, NamedTuple, Optional, Tuple,
                    Union)

from tensor2robot_tpu_torch.data import native_loader
from tensor2robot_tpu_torch.data import parser
from tensor2robot_tpu_torch.data import pipeline
from tensor2robot_tpu_torch.data.tfrecord import RecordQuarantine
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import generators
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.specs.tensor_spec import as_tensor_spec

__all__ = ['AbstractInputGenerator', 'DefaultRandomInputGenerator',
           'DefaultRecordInputGenerator', 'FractionalRecordInputGenerator',
           'FrameShard', 'GeneratorInputGenerator',
           'MultiEvalRecordInputGenerator', 'get_multi_eval_name',
           'prefetch_iterator']


class FrameShard(NamedTuple):
  """Frames ``[start, stop)`` of the arrays keyed in ``keys``, whose first
  per-example axis (axis 1 of a batch) is the episode's frames.

  Where the cut happens: the random generator draws only these frames
  (``generators.make_random_frames``); the record generator's native
  loader decodes and copies only these frames of each record (the cut is
  in its plan, ``native_loader.plan_for_specs``), and its Python parser
  path parses whole episodes and cuts them after (``cut``).
  """
  keys: Tuple[str, ...]
  start: int
  stop: int

  def spec(self, spec):
    """``spec`` with the frame keys cut to this shard's frames; a
    ``TensorSpec`` keeps its on-disk fields."""
    out = {}
    for key, value in spec.items():
      if key in self.keys:
        value = as_tensor_spec(value)
        value = TensorSpec((self.stop - self.start,) + tuple(value.shape[1:]),
                           value.dtype, **value.fields())
      out[key] = value
    return out

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
    # The split decode's preprocessor (a ``DeviceDecodePreprocessor``) and
    # its on-disk JPEG specs, when the model has one.
    self._device_decode = None
    self._raw_feature_spec = None

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
    """Takes the specifications the model's preprocessor consumes. A
    ``DeviceDecodePreprocessor`` is recognized: a record generator then
    plans its loader in the wrapper's coefficient mode against the
    on-disk JPEG specs."""
    if mode not in ModeKeys.ALL:
      raise ValueError('mode must be one of {}, not {!r}.'.format(
          ModeKeys.ALL, mode))
    preprocessor = model.preprocessor
    self.set_specification(preprocessor.get_in_feature_specification(mode),
                           preprocessor.get_in_label_specification(mode))
    if hasattr(preprocessor, 'raw_in_feature_specification'):
      self._device_decode = preprocessor
      self._raw_feature_spec = dict(
          preprocessor.raw_in_feature_specification(mode))

  def set_specification(self, feature_spec, label_spec) -> None:
    self._feature_spec = dict(feature_spec)
    self._label_spec = dict(label_spec)
    self._device_decode = self._raw_feature_spec = None

  def create_dataset_iterator(self, mode: str,
                              num_epochs: Optional[int] = None,
                              seed: Optional[int] = None,
                              prefetch: Optional[int] = None,
                              frames: Optional[FrameShard] = None,
                              shard_index: int = 0, num_shards: int = 1,
                              device: Optional[int] = None) -> Iterator:
    """Yields (features, labels) numpy dicts; ``num_epochs`` None is
    endless, ``prefetch`` None takes the generator's default (0 makes
    each batch on demand), ``frames`` keeps only a shard of the episodes'
    frames, a record reader reads its ``shard_index`` of ``num_shards``
    shares of the files, and ``device`` is the index of the caller's CUDA
    device, where a reader that decodes on a card decodes (None: the
    caller's current device; readers on the host ignore it)."""
    if self._feature_spec is None:
      raise ValueError('set_specification(_from_model) must be called '
                       'before creating a dataset iterator.')
    iterator = self._create_iterator(mode, num_epochs, seed, frames,
                                     shard_index, num_shards, device)
    depth = self._prefetch if prefetch is None else prefetch
    if depth > 0:
      iterator = prefetch_iterator(iterator, depth)
    return iterator

  @abc.abstractmethod
  def _create_iterator(self, mode: str, num_epochs: Optional[int],
                       seed: Optional[int], frames: Optional[FrameShard],
                       shard_index: int, num_shards: int,
                       device: Optional[int]) -> Iterator:
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

  def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                       num_shards, device):
    # Every reader draws from the seed, on the host.
    del mode, shard_index, num_shards, device
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


def _cut_frames(iterator: Iterator, frames: FrameShard) -> Iterator:
  for features, labels in iterator:
    yield frames.cut(features), None if labels is None else frames.cut(
        labels)


class DefaultRecordInputGenerator(AbstractInputGenerator):
  """TFRecord files, one dataset or several zipped, as batches.

  ``file_patterns``: 'path/a*' or 'tfrecord:path/a*,path/b*'.
  ``dataset_map``: {dataset_key: file_patterns}, zipped by the specs'
  ``dataset_key``s.

  ``use_native`` chooses the reader: True, the native loader
  (``native_loader``: C++ worker threads read, parse and decode); False,
  the Python parser (``pipeline``); 'auto', the native loader exactly
  when it can read these specs and files: ``plan_for_specs`` plans them
  (not PNG images, sequences without ``sequence_max_len``, or unnamed or
  shared names), every configured dataset is read by a spec and
  ``skip_corrupt_records`` is off. The rule looks at the specs and the
  configuration only: a loader that fails to build or load raises, and
  True raises where the specs are not the loader's.

  ``skip_corrupt_records``: count corrupt or truncated records against
  ``max_corrupt_records`` in all and ``max_corrupt_records_per_file`` in
  one file, and read on, until either budget is exceeded; only the
  Python parser skips. TRAIN shuffles files and records, from ``seed``
  and its epoch; EVAL and PREDICT read in order. The native loader's
  order is a function of the seed alone, so the ranks of a sequence group
  (one seed, each its ``frames``) read the same episodes; it decodes only
  the shard's frames, with nvJPEG on the CUDA ``device`` that the
  iterator is given.

  A model whose preprocessor is a ``DeviceDecodePreprocessor`` (the split
  decode) is planned against its on-disk JPEG specs in the wrapper's
  coefficient mode; only the native loader ships coefficients, so
  ``skip_corrupt_records``, ``use_native=False``, a ``dataset_map`` or
  specs it cannot plan raise.
  """

  def __init__(self, file_patterns: Optional[str] = None,
               dataset_map: Optional[Dict[str, str]] = None,
               batch_size: int = 32, shuffle_buffer_size: int = 500,
               prefetch: int = 2, use_native: Union[bool, str] = 'auto',
               num_native_threads: Optional[int] = None,
               sequence_max_len: Optional[int] = None,
               skip_corrupt_records: bool = False,
               max_corrupt_records: int = 100,
               max_corrupt_records_per_file: int = 10):
    super().__init__(batch_size=batch_size, prefetch=prefetch)
    if not file_patterns and not dataset_map:
      raise ValueError('file_patterns or dataset_map is required.')
    if file_patterns and dataset_map:
      raise ValueError('file_patterns and dataset_map are mutually '
                       'exclusive.')
    if use_native not in (True, False, 'auto'):
      raise ValueError("use_native must be True, False or 'auto'; got "
                       '{!r}.'.format(use_native))
    if skip_corrupt_records and use_native is True:
      raise ValueError('use_native=True cannot skip corrupt records: only '
                       'the Python parser can.')
    self._file_patterns = file_patterns
    self._dataset_map = dataset_map
    self._shuffle_buffer_size = shuffle_buffer_size
    self._use_native = use_native
    self._num_native_threads = num_native_threads
    self._sequence_max_len = sequence_max_len
    self._skip_corrupt_records = skip_corrupt_records
    self.quarantine = None
    if skip_corrupt_records:
      self.quarantine = RecordQuarantine(max_corrupt_records,
                                         max_corrupt_records_per_file)
    # The reader the last iterator took: 'native' or 'python'; the native
    # loader's stream of the last iterator (its stats), or None.
    self.reader = None
    self.stream = None

  def _dataset_files(self) -> Dict[str, str]:
    if self._dataset_map is not None:
      return dict(self._dataset_map)
    return {'': self._file_patterns}

  def native_plan(self, frames: Optional[FrameShard] = None):
    """The native loader's plan of the specs (of ``frames`` only, where
    given) when ``use_native`` takes it (see the class's rule), else
    None; for the split decode, the plan in the wrapper's coefficient mode
    or an error (no other reader ships coefficients)."""
    if self._device_decode is not None:
      return self._coefficient_plan(frames)
    if self._use_native is False:
      return None
    plan = None
    if not self._skip_corrupt_records:
      plan = native_loader.plan_for_specs(
          self._feature_spec, self._label_spec,
          sequence_max_len=self._sequence_max_len, frames=frames)
    if plan is not None and set(plan.dataset_keys) != set(
        self._dataset_files()):
      plan = None   # the Python zip reads every configured dataset
    if plan is None and self._use_native is True:
      raise ValueError(
          'use_native=True, but the native loader does not read these '
          'specs and datasets (sequences without sequence_max_len, PNG '
          'images, unnamed or shared names, or datasets no spec reads).')
    return plan

  def _coefficient_plan(self, frames: Optional[FrameShard]):
    """The loader's plan of the split decode, which only the native loader
    reads: every way round it raises."""
    if self._skip_corrupt_records:
      raise ValueError(
          'skip_corrupt_records is not supported with a '
          'DeviceDecodePreprocessor (native-only stream).')
    if self._use_native is False:
      raise ValueError(
          'DeviceDecodePreprocessor requires the native loader '
          '(use_native must not be False).')
    if self._dataset_map is not None:
      raise ValueError(
          'DeviceDecodePreprocessor does not support multi-dataset zip.')
    plan = native_loader.plan_for_specs(
        self._raw_feature_spec, self._label_spec,
        image_mode=self._device_decode.image_mode,
        sparse_density=self._device_decode.sparse_density,
        sequence_max_len=self._sequence_max_len, frames=frames)
    if plan is None:
      raise ValueError(
          'DeviceDecodePreprocessor requires the native loader fast path '
          '(plain Example, fixed shapes, 4:2:0-eligible JPEG specs).')
    return plan

  def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                       num_shards, device):
    shuffle = mode == ModeKeys.TRAIN
    plan = self.native_plan(frames)
    if plan is not None:
      files = {}
      for key, patterns in self._dataset_files().items():
        files[key] = pipeline.parse_file_patterns(patterns)[1][
            shard_index::num_shards]
        if not files[key]:
          raise ValueError('Reader {} of {} has no files of dataset '
                           '{!r}.'.format(shard_index, num_shards, key))
      stream = native_loader.NativeBatchedStream(
          plan, files[''] if plan.dataset_keys == [''] else files,
          batch_size=self._batch_size, shuffle=shuffle,
          shuffle_buffer=self._shuffle_buffer_size, num_epochs=num_epochs,
          seed=seed, num_threads=self._num_native_threads,
          device=device)
      self.reader = 'native'
      self.stream = stream
      # The loader's plan keeps only the shard's frames.
      return self._closing(stream)
    example_parser = parser.ExampleParser(self._feature_spec,
                                          self._label_spec)
    datasets = {
        key: pipeline.RecordDataset(
            patterns, dataset_key=key, shard_index=shard_index,
            num_shards=num_shards,
            skip_corrupt_records=self._skip_corrupt_records,
            quarantine=self.quarantine)
        for key, patterns in self._dataset_files().items()}
    missing = set(example_parser.dataset_keys) - set(datasets)
    if missing:
      raise ValueError('Specs read dataset keys {} with no files; have '
                       '{}.'.format(sorted(missing), sorted(datasets)))
    self.reader, self.stream = 'python', None
    # The Python parser parses whole episodes; the shard is cut after.
    iterator = iter(pipeline.BatchedExampleStream(
        datasets, example_parser, batch_size=self._batch_size,
        shuffle=shuffle,
        shuffle_buffer=self._shuffle_buffer_size, num_epochs=num_epochs,
        seed=seed))
    return iterator if frames is None else _cut_frames(iterator, frames)

  @staticmethod
  def _closing(stream) -> Iterator:
    try:
      yield from stream
    finally:
      stream.close()


class FractionalRecordInputGenerator(DefaultRecordInputGenerator):
  """Reads only the first ``file_fraction`` of the matched files (for
  data ablations)."""

  def __init__(self, file_fraction: float = 1.0, **kwargs):
    super().__init__(**kwargs)
    if not 0.0 < file_fraction <= 1.0:
      raise ValueError('file_fraction must be in (0, 1].')
    self._file_fraction = file_fraction

  def _dataset_files(self) -> Dict[str, str]:
    out = {}
    for key, patterns in super()._dataset_files().items():
      if self._file_fraction < 1.0:
        files = pipeline.parse_file_patterns(patterns)[1]
        patterns = ','.join(files[:max(1, int(self._file_fraction *
                                              len(files)))])
      out[key] = patterns
    return out


def get_multi_eval_name(default: Optional[str] = None) -> Optional[str]:
  """The eval dataset's name in ``TF_CONFIG``'s ``multi_eval_name``."""
  tf_config = os.environ.get('TF_CONFIG')
  if not tf_config:
    return default
  try:
    return json.loads(tf_config).get('multi_eval_name', default)
  except (ValueError, AttributeError):
    return default


class MultiEvalRecordInputGenerator(DefaultRecordInputGenerator):
  """Reads the dataset of ``eval_map`` that ``TF_CONFIG``'s
  ``multi_eval_name`` names."""

  def __init__(self, eval_map: Dict[str, str], **kwargs):
    multi_eval_name = get_multi_eval_name()
    if multi_eval_name is None:
      raise ValueError('TF_CONFIG.multi_eval_name must be set for '
                       'MultiEvalRecordInputGenerator.')
    if multi_eval_name not in eval_map:
      raise ValueError('multi_eval_name {!r} not in eval_map {}.'.format(
          multi_eval_name, sorted(eval_map)))
    self.multi_eval_name = multi_eval_name
    super().__init__(file_patterns=eval_map[multi_eval_name], **kwargs)
