"""Task-batched data for meta-learning (the JAX package's
``meta_learning/meta_data.py``).

  * ``flatten_batch_examples`` and ``unflatten_batch_examples``: the
    [num_tasks, num_samples] leading dims merged into one and split again;
  * ``multi_batch_apply``: a function of one batch dim over several, over
    the tensors in (nested dicts, lists and tuples of) its arguments;
  * ``split_meta_in_spec`` and ``to_meta_batch``: the meta layout's specs
    back to the base model's, and [tasks, samples] batches of the base
    model's into the meta layout (condition, inference, meta labels);
  * ``MetaRecordInputGenerator`` (one record file a task) and
    ``MAMLRandomInputGenerator`` (random meta batches, array for array the
    JAX generator's).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch.data import pipeline
from tensor2robot_tpu_torch.data.input_generators import (
    AbstractInputGenerator)
from tensor2robot_tpu_torch.data.parser import ExampleParser
from tensor2robot_tpu_torch.data.tfrecord import read_all_records
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs import generators
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['MAMLRandomInputGenerator', 'MetaRecordInputGenerator',
           'flatten_batch_examples', 'multi_batch_apply',
           'split_meta_in_spec', 'stack_struct', 'to_meta_batch',
           'unflatten_batch_examples']


def _merge_two(x):
  if getattr(x, 'ndim', 0) < 2:
    return x
  return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def flatten_batch_examples(struct):
  """[num_tasks, num_samples, ...] -> [num_tasks * num_samples, ...] of a
  tensor, an array or a dict of them; values with fewer than two dims (a
  task's scalar) pass through."""
  if isinstance(struct, dict):
    return {key: _merge_two(value) for key, value in struct.items()}
  return _merge_two(struct)


def unflatten_batch_examples(struct, num_samples_per_task: int):
  """The inverse of ``flatten_batch_examples``."""
  split = lambda x: x.reshape((-1, num_samples_per_task) +
                              tuple(x.shape[1:]))
  if isinstance(struct, dict):
    return {key: split(value) for key, value in struct.items()}
  return split(struct)


def _map(fn, tree):
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return type(tree)((key, _map(fn, value)) for key, value in tree.items())
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, value) for value in tree)
  return tree


def _tensors(tree):
  found = []
  _map(found.append, tree)
  return found


def multi_batch_apply(fn: Callable, num_batch_dims: int, *args, **kwargs):
  """Applies ``fn`` (which expects one batch dim) over ``num_batch_dims``.

  The leading ``num_batch_dims`` dims of every tensor in ``args`` and
  ``kwargs`` are merged into one, ``fn`` runs, and the leading dim of every
  tensor it returns is split back into the first tensor's batch dims.
  """
  leaves = _tensors((args, kwargs))
  if not leaves:
    raise ValueError('multi_batch_apply needs at least one tensor argument.')
  batch_dims = tuple(leaves[0].shape[:num_batch_dims])

  def merge(x):
    if x.dim() >= num_batch_dims:
      return x.reshape((-1,) + tuple(x.shape[num_batch_dims:]))
    return x

  def split(x):
    return x.reshape(batch_dims + tuple(x.shape[1:]))

  outputs = fn(*_map(merge, args), **_map(merge, kwargs))
  return _map(split, outputs)


def stack_struct(structs: Sequence[Dict[str, np.ndarray]],
                 axis: int = 0) -> Dict[str, np.ndarray]:
  return {key: np.stack([np.asarray(s[key]) for s in structs], axis=axis)
          for key in structs[0]}


def split_meta_in_spec(meta_in_spec):
  """A meta in-specification -> (the base feature spec, the base label
  spec): the ``condition_features/`` or ``condition_labels/`` name prefix
  and the samples dim taken off (``create_maml_feature_spec``'s
  inverse)."""

  def debase(spec):
    name = spec.name
    if name and name.startswith(('condition_features/',
                                 'condition_labels/')):
      name = name.split('/', 1)[1]
    return TensorSpec(spec.shape[1:], spec.dtype,
                      **{**spec.fields(), 'name': name})

  features, labels = {}, {}
  for key, spec in algebra.flat_specs(meta_in_spec).items():
    if key.startswith('condition/features/'):
      features[key[len('condition/features/'):]] = debase(spec)
    elif key.startswith('condition/labels/'):
      labels[key[len('condition/labels/'):]] = debase(spec)
  return features, labels


def to_meta_batch(features, labels, num_condition: int):
  """[tasks, samples, ...] base batches -> (meta features, meta labels):
  each task's first ``num_condition`` samples feed the inner loop, the
  rest the outer loss."""
  meta_features = {}
  for key, value in features.items():
    meta_features['condition/features/' + key] = value[:, :num_condition]
    meta_features['inference/features/' + key] = value[:, num_condition:]
  for key, value in labels.items():
    meta_features['condition/labels/' + key] = value[:, :num_condition]
  return meta_features, {key: value[:, num_condition:]
                         for key, value in labels.items()}


class MetaRecordInputGenerator(AbstractInputGenerator):
  """One TFRecord file a task: each batch groups ``num_tasks`` tasks, each
  ``num_condition_samples_per_task`` examples for the inner loop and
  ``num_inference_samples_per_task`` for the outer loss, [num_tasks,
  num_samples, ...] in the meta layout. A task file with fewer examples
  than that wraps around."""

  # The reader (the trainer's JSON line names it): the Python parser.
  reader = 'python'

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
    del mode, frames, shard_index, num_shards, device
    _, files = pipeline.parse_file_patterns(self._file_patterns)
    if not files:
      raise ValueError('No task files match {}.'.format(self._file_patterns))
    feature_spec, label_spec = split_meta_in_spec(self._feature_spec)
    parser = ExampleParser(feature_spec, label_spec)
    samples = self._num_condition + self._num_inference
    rng = np.random.RandomState(seed)

    def read_task(path):
      records = read_all_records(path)
      if len(records) < samples:
        records = records * (samples // len(records) + 1)
      idx = (rng.choice(len(records), samples, replace=False)
             if self._shuffle else np.arange(samples))
      return [records[i] for i in idx]

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
      order = (rng.permutation(len(files)) if self._shuffle
               else np.arange(len(files)))
      for start in range(0, len(order) - self._num_tasks + 1,
                         self._num_tasks):
        # One parse of every task's records: their images decode in the
        # parser's threads together.
        features, labels = parser.parse_batch(
            [record for i in order[start:start + self._num_tasks]
             for record in read_task(files[i])])
        yield to_meta_batch(unflatten_batch_examples(features, samples),
                            unflatten_batch_examples(labels, samples),
                            self._num_condition)
      epoch += 1


class MAMLRandomInputGenerator(AbstractInputGenerator):
  """Random meta batches of the base specs: batch ``step`` of an iterator
  seeded ``seed`` draws the features from ``seed + step`` and the labels
  from ``seed + step + 977``, ``num_tasks * samples`` examples each, as
  the JAX generator does."""

  def __init__(self, num_tasks: int = 2,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1, **kwargs):
    kwargs.setdefault('batch_size', num_tasks)
    super().__init__(**kwargs)
    self._num_tasks = num_tasks
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                       num_shards, device):
    del mode, frames, shard_index, num_shards, device
    feature_spec, label_spec = split_meta_in_spec(self._feature_spec)
    samples = self._num_condition + self._num_inference
    step = 0
    while num_epochs is None or step < num_epochs:
      features = unflatten_batch_examples(generators.make_random_numpy(
          feature_spec, self._num_tasks * samples,
          None if seed is None else seed + step), samples)
      labels = unflatten_batch_examples(generators.make_random_numpy(
          label_spec, self._num_tasks * samples,
          None if seed is None else seed + step + 977), samples)
      yield to_meta_batch(features, labels, self._num_condition)
      step += 1
