"""AbstractPredictor: the numpy-in, numpy-out serving interface.

The counterpart of the JAX package's ``predictors/abstract_predictor.py``:
``predict(features)``, the specification getters, ``restore``,
``init_randomly``, ``close`` and the version properties. Every concrete
predictor's own ``predict`` and ``restore`` are wrapped when its class is
created, so latency lands in the histogram ``inference/latency_ms`` labelled
with the predictor's class, failures in ``inference/errors`` and restores in
``inference/restores`` (labelled with the outcome): the JAX package's series
under the JAX package's names.
"""

from __future__ import annotations

import abc
import functools
import threading
import time
from typing import Dict

import numpy as np

from tensor2robot_tpu_torch.observability import (
    DEFAULT_LATENCY_BUCKETS_MS,
    get_registry,
)

__all__ = ['AbstractPredictor', 'INFERENCE_ERRORS_COUNTER',
           'INFERENCE_LATENCY_HISTOGRAM', 'INFERENCE_RESTORES_COUNTER']

INFERENCE_LATENCY_HISTOGRAM = 'inference/latency_ms'
INFERENCE_RESTORES_COUNTER = 'inference/restores'
INFERENCE_ERRORS_COUNTER = 'inference/errors'

# Only the outermost instrumented call on a thread records, so one request
# that goes through predict_versioned and predict is observed once.
_call_depth = threading.local()


def _instrument_predict(fn):
  """Times successful calls; counts failures apart."""

  @functools.wraps(fn)
  def wrapper(self, features, *args, **kwargs):
    name = type(self).__name__
    depth = getattr(_call_depth, 'value', 0)
    _call_depth.value = depth + 1
    start = time.perf_counter()
    try:
      outputs = fn(self, features, *args, **kwargs)
    except Exception:
      if depth == 0:
        get_registry().counter_family(
            INFERENCE_ERRORS_COUNTER, ('predictor',)).series(name).inc()
      raise
    finally:
      _call_depth.value = depth
    if depth == 0:
      get_registry().histogram_family(
          INFERENCE_LATENCY_HISTOGRAM, ('predictor',),
          bounds=DEFAULT_LATENCY_BUCKETS_MS).series(name).record(
              (time.perf_counter() - start) * 1e3)
    return outputs

  wrapper._t2r_instrumented = True  # noqa: SLF001 — idempotence marker
  return wrapper


def _instrument_restore(fn):
  """Counts restores by outcome (success, or timeout when it returns
  False)."""

  @functools.wraps(fn)
  def wrapper(self, *args, **kwargs):
    result = fn(self, *args, **kwargs)
    get_registry().counter_family(
        INFERENCE_RESTORES_COUNTER, ('predictor', 'outcome')).series(
            type(self).__name__,
            'timeout' if result is False else 'success').inc()
    return result

  wrapper._t2r_instrumented = True  # noqa: SLF001
  return wrapper


class AbstractPredictor(abc.ABC):
  """Loads a model and exposes a predict function."""

  def __init_subclass__(cls, **kwargs):
    # Wrap only the methods this subclass defines: inherited ones were
    # wrapped on their own class, and the label reads the runtime type.
    super().__init_subclass__(**kwargs)
    for method, instrument in (('predict', _instrument_predict),
                               ('predict_versioned', _instrument_predict),
                               ('restore', _instrument_restore)):
      fn = cls.__dict__.get(method)
      if fn is not None and callable(fn) and not getattr(
          fn, '_t2r_instrumented', False):
        setattr(cls, method, instrument(fn))

  @abc.abstractmethod
  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Runs the model on a dict of feature arrays."""

  def predict_versioned(self, features: Dict[str, np.ndarray]):
    """``(outputs, model_version)``, both from one read of the loaded
    state (a subclass that swaps its state as one snapshot makes this
    hold under a concurrent ``restore``)."""
    return self.predict(features), self.model_version

  @abc.abstractmethod
  def get_feature_specification(self):
    """The input features a prediction needs."""

  def get_label_specification(self):
    """Optional labels, for evaluation."""
    return None

  @abc.abstractmethod
  def restore(self) -> bool:
    """Loads the newest available weights; True on success."""

  def init_randomly(self) -> None:
    """Random weights, for tests and cold starts."""

  @abc.abstractmethod
  def close(self) -> None:
    """Releases all handles."""

  @property
  def is_loaded(self) -> bool:
    return False

  @property
  def model_version(self) -> int:
    return 0

  @property
  def global_step(self) -> int:
    return 0

  @property
  def model_path(self) -> str:
    return ''
