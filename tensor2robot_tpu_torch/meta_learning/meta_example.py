"""Meta-example records: one record a task, bundling its condition and
inference episodes (the JAX package's ``meta_learning/meta_example.py``).

``make_meta_example`` merges serialized episode Examples (or
SequenceExamples) into one record whose feature names carry
``condition_ep<i>/`` and ``inference_ep<i>/`` prefixes, at the level of
the wire codec; ``MetaExampleInputGenerator`` reads such records back as
[num_tasks, num_samples, ...] batches in the meta layout
(``meta_data.to_meta_batch``), which the MAML models train on.
``run_meta_env(write_meta_examples=True)`` writes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.data import pipeline
from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.data.input_generators import (
    AbstractInputGenerator)
from tensor2robot_tpu_torch.data.parser import ExampleParser
from tensor2robot_tpu_torch.data.tfrecord import read_all_records
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['CONDITION_PREFIX', 'INFERENCE_PREFIX',
           'MetaExampleInputGenerator', 'make_meta_example']

CONDITION_PREFIX = 'condition_ep'
INFERENCE_PREFIX = 'inference_ep'


def _encodeable(feature_value):
  """A wire ``(kind, values)`` as a value the wire's builders take."""
  kind, values = feature_value
  if kind == 'bytes':
    return list(values)
  if kind == 'float':
    return np.asarray(values, np.float32)
  return np.asarray(values, np.int64)


def make_meta_example(condition_examples: Sequence[bytes],
                      inference_examples: Sequence[bytes]) -> bytes:
  """One meta-example record of serialized episode records: their feature
  names under ``condition_ep<i>/`` and ``inference_ep<i>/``. A
  SequenceExample bundle where any record has feature lists (a plain
  Example reads as a SequenceExample without them)."""
  if not condition_examples or not inference_examples:
    raise ValueError('Need at least one condition and one inference example.')
  parsed = []
  for prefix, examples in ((CONDITION_PREFIX, condition_examples),
                           (INFERENCE_PREFIX, inference_examples)):
    for i, record in enumerate(examples):
      try:
        context, feature_lists = wire.parse_sequence_example(record)
      except Exception:  # noqa: BLE001 - a plain Example's wire quirks
        context, feature_lists = wire.parse_example(record), {}
      parsed.append(('{}{}/'.format(prefix, i), context, feature_lists))
  merged_context: Dict[str, object] = {}
  merged_lists: Dict[str, list] = {}
  for tag, context, feature_lists in parsed:
    for name, value in context.items():
      merged_context[tag + name] = _encodeable(value)
    for name, steps in feature_lists.items():
      merged_lists[tag + name] = [_encodeable(s) for s in steps]
  if any(feature_lists for _, _, feature_lists in parsed):
    return wire.build_sequence_example(merged_context, merged_lists)
  return wire.build_example(merged_context)


def _prefixed_specs(specs, prefix: str):
  """The specs with their on-disk names under ``prefix/``."""
  return {key: TensorSpec(spec.shape, spec.dtype, **{
      **spec.fields(),
      'name': prefix + '/' + (spec.name if spec.name is not None else key)})
          for key, spec in specs.items()}


class MetaExampleInputGenerator(AbstractInputGenerator):
  """Meta-example records, one a task, as meta batches of ``num_tasks``
  tasks; files are read one at a time, in a shuffled order in TRAIN."""

  def __init__(self, file_patterns: str,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1,
               num_tasks: Optional[int] = None, shuffle: bool = True,
               **kwargs):
    kwargs.setdefault('batch_size', num_tasks or 2)
    super().__init__(**kwargs)
    self._file_patterns = file_patterns
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task
    self._num_tasks = num_tasks or self._batch_size
    self._shuffle = shuffle

  def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                       num_shards, device):
    del mode, frames, device
    _, files = pipeline.parse_file_patterns(self._file_patterns)
    files = files[shard_index::num_shards]
    if not files:
      raise ValueError('No meta-example files match {}.'.format(
          self._file_patterns))
    feature_spec, label_spec = meta_data.split_meta_in_spec(
        self._feature_spec)
    parsers = []
    for i in range(self._num_condition + self._num_inference):
      prefix = (CONDITION_PREFIX + str(i) if i < self._num_condition
                else INFERENCE_PREFIX + str(i - self._num_condition))
      parsers.append(ExampleParser(_prefixed_specs(feature_spec, prefix),
                                   _prefixed_specs(label_spec, prefix)))
    rng = np.random.RandomState(seed)

    def parse_chunk(chunk):
      parsed = [parser.parse_batch(chunk) for parser in parsers]
      return meta_data.to_meta_batch(
          meta_data.stack_struct([p[0] for p in parsed], axis=1),
          meta_data.stack_struct([p[1] for p in parsed], axis=1),
          self._num_condition)

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
      file_order = (rng.permutation(len(files)) if self._shuffle
                    else np.arange(len(files)))
      pending: List[bytes] = []
      yielded = False
      for file_idx in file_order:
        records = read_all_records(files[file_idx])
        order = (rng.permutation(len(records)) if self._shuffle
                 else np.arange(len(records)))
        pending.extend(records[i] for i in order)
        while len(pending) >= self._num_tasks:
          chunk, pending = (pending[:self._num_tasks],
                            pending[self._num_tasks:])
          yield parse_chunk(chunk)
          yielded = True
      if not yielded:
        raise ValueError(
            'Meta-example files {} hold fewer than num_tasks={} records; '
            'collect more tasks or lower num_tasks.'.format(
                files, self._num_tasks))
      epoch += 1
