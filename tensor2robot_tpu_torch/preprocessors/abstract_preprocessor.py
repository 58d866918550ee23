"""AbstractPreprocessor: declared in and out specifications around one
transform of a batch (the JAX package's
``preprocessors/abstract_preprocessor.py``), and ``NoOpPreprocessor``
(its ``noop_preprocessor.py``).

A preprocessor declares four flat specifications, in and out, features and
labels, per mode; ``preprocess`` checks the batch against the in
specifications, runs ``_preprocess_fn`` and checks its result against the
out ones. The batch is tensors on the model's device (numpy arrays are
taken as they are); each spec describes one example, so the leading batch
dims are not checked, nor a spec dim that is None.

Where JAX's transform takes an ``rng`` key, the port's takes the step's
``torch.Generator`` (the trainer's crop generator, on the model's device)
and, in its place, ``draws``: the random values themselves, as a
preprocessor's ``draw`` makes them, so that a test can inject JAX's.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import algebra

__all__ = ['AbstractPreprocessor', 'NoOpPreprocessor', 'check_batch']


def _dtype(value) -> np.dtype:
  if isinstance(value, torch.Tensor):
    return np.dtype(torch.empty((), dtype=value.dtype).numpy().dtype)
  return np.asarray(value).dtype


def check_batch(spec, batch, what: str) -> Dict[str, Any]:
  """``batch``'s values for the flat ``spec``'s keys, in its order: a
  required key missing, another dtype or another per-example shape (the
  trailing ``len(spec.shape)`` dims; None matches any) raises."""
  out = {}
  for key, item in algebra.flat_specs(spec).items():
    if key not in batch:
      if item.is_optional:
        continue
      raise ValueError('{} has no {!r}; the specification asks for {}.'
                       .format(what, key, sorted(algebra.flat_specs(spec))))
    value = batch[key]
    shape = tuple(value.shape)
    rank = len(item.shape)
    if len(shape) < rank or any(
        want is not None and want != got
        for want, got in zip(item.shape, shape[len(shape) - rank:])):
      raise ValueError('{} {!r} has shape {}; the specification asks for '
                       '{} an example.'.format(what, key, shape, item.shape))
    if _dtype(value) != item.dtype:
      raise ValueError('{} {!r} is {}; the specification asks for {}.'
                       .format(what, key, _dtype(value), item.dtype))
    out[key] = value
  return out


class AbstractPreprocessor(abc.ABC):
  """Specifications and a transform; subclasses define both."""

  def __init__(self, model_feature_specification_fn=None,
               model_label_specification_fn=None):
    """Optionally binds the model's specification functions (mode ->
    specification), which the out specifications default to."""
    self._model_feature_specification_fn = model_feature_specification_fn
    self._model_label_specification_fn = model_label_specification_fn

  @abc.abstractmethod
  def get_in_feature_specification(self, mode: str):
    """What the input generator must make."""

  @abc.abstractmethod
  def get_in_label_specification(self, mode: str):
    ...

  @abc.abstractmethod
  def get_out_feature_specification(self, mode: str):
    """What the model's network consumes."""

  @abc.abstractmethod
  def get_out_label_specification(self, mode: str):
    ...

  def _model_feature_specification(self, mode: str):
    if self._model_feature_specification_fn is None:
      raise ValueError('{} was not constructed with the model\'s '
                       'specification functions.'.format(type(self)))
    return self._model_feature_specification_fn(mode)

  def _model_label_specification(self, mode: str):
    if self._model_label_specification_fn is None:
      raise ValueError('{} was not constructed with the model\'s '
                       'specification functions.'.format(type(self)))
    return self._model_label_specification_fn(mode)

  @abc.abstractmethod
  def _preprocess_fn(self, features: Dict[str, Any],
                     labels: Optional[Dict[str, Any]], mode: str,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Any] = None
                     ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """The transform of one checked batch."""

  def preprocess(self, features, labels, mode: str,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Any] = None):
    """(features, labels) checked, transformed and checked again; labels
    are None where the in specification declares none."""
    if mode not in ModeKeys.ALL:
      raise ValueError('mode must be one of {}, not {!r}.'.format(
          ModeKeys.ALL, mode))
    features = check_batch(self.get_in_feature_specification(mode),
                           features, 'The features')
    if labels is not None and algebra.flat_specs(
        self.get_in_label_specification(mode)):
      labels = check_batch(self.get_in_label_specification(mode), labels,
                           'The labels')
    else:
      labels = None
    features, labels = self._preprocess_fn(features, labels, mode,
                                           generator, draws)
    features = check_batch(self.get_out_feature_specification(mode),
                           features, 'The preprocessed features')
    if labels is not None:
      labels = check_batch(self.get_out_label_specification(mode), labels,
                           'The preprocessed labels')
    return features, labels


class NoOpPreprocessor(AbstractPreprocessor):
  """The identity: in and out specifications are the model's (with their
  sequence lengths), the JAX models' default preprocessor."""

  def get_in_feature_specification(self, mode):
    return algebra.add_sequence_length_specs(
        self._model_feature_specification(mode))

  def get_in_label_specification(self, mode):
    return algebra.add_sequence_length_specs(
        self._model_label_specification(mode))

  def get_out_feature_specification(self, mode):
    return self.get_in_feature_specification(mode)

  def get_out_label_specification(self, mode):
    return self.get_in_label_specification(mode)

  def _preprocess_fn(self, features, labels, mode, generator=None,
                     draws=None):
    return features, labels
