"""CheckpointPredictor: serve straight from the trainer's checkpoints.

The counterpart of the JAX package's ``predictors/checkpoint_predictor.py``.
``restore`` polls ``<checkpoint_dir>`` for the port's own checkpoints
(``trainer/checkpointing.py``: ``checkpoint_<step>.pt``) and swaps in the
newest one's serving variables; ``predict`` runs the model's one serving
function (``export.export_generators.make_serve_fn``: PREDICT preprocessing
and ``predict_step``) on them.

Every field a serving call needs lives in one immutable snapshot,
``_Loaded(variables, step)``, assigned as one reference: a predict that
started on step N finishes on step N, ``predict_versioned`` labels its
outputs with that step, and ``versioned_variables`` hands a server the
``(step, variables)`` pair of one snapshot to hot-swap in
(``PolicyServer.swap_from_predictor``, which ``serving/serve.py
--checkpoint_dir`` polls). A JAX (Orbax) checkpoint reaches the port
through ``convert``, its arrays given as numpy.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.export.export_generators import make_serve_fn
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.reliability.errors import CHECKPOINT_SKIP_ERRORS
from tensor2robot_tpu_torch.trainer import checkpointing

__all__ = ['CHECKPOINT_WAIT_GAUGE', 'CheckpointPredictor']

_POLL_INTERVAL_SECS = 1.0
# How often the otherwise silent wait for a checkpoint reports itself.
_WAIT_REPORT_INTERVAL_SECS = 10.0
CHECKPOINT_WAIT_GAUGE = 'inference/checkpoint_wait_seconds'


class _Loaded(NamedTuple):
  """One restored model version, swapped in as a single reference."""

  variables: Any
  step: int


class CheckpointPredictor(AbstractPredictor):
  """Polls ``checkpoint_dir`` and serves the newest step."""

  def __init__(self, t2r_model, checkpoint_dir: Optional[str] = None,
               timeout: float = 600.0):
    """Args:
      t2r_model: the model whose predict path to serve (on its device).
      checkpoint_dir: the trainer's model_dir; None allows only
        ``init_randomly``.
      timeout: the most seconds ``restore`` waits for a new checkpoint.
    """
    self._model = t2r_model
    self._checkpoint_dir = checkpoint_dir
    self._timeout = timeout
    self._loaded: Optional[_Loaded] = None
    self._serve_fn = make_serve_fn(t2r_model)

  # -- loading ---------------------------------------------------------------

  def init_randomly(self, seed: int = 0) -> None:
    """Random weights from the model's initializer (from ``seed``);
    version 0."""
    self._loaded = _Loaded(variables=self._model.init_variables(
        torch.Generator().manual_seed(seed)), step=0)

  def restore(self) -> bool:
    """Waits for a checkpoint newer than the loaded one, then loads it.

    Returns True once loaded, or at once when nothing is newer than an
    already loaded step; False when ``timeout`` passes first. A
    checkpoint that fails to load transiently or is damaged
    (``CHECKPOINT_SKIP_ERRORS``) is skipped for the next older one, and
    left where it is: a reader never renames a training run's files.
    """
    if self._checkpoint_dir is None:
      raise ValueError('CheckpointPredictor constructed without a '
                       'checkpoint_dir; call init_randomly() instead.')
    wait_start = time.monotonic()
    deadline = wait_start + self._timeout
    next_report = wait_start + _WAIT_REPORT_INTERVAL_SECS
    wait_gauge = get_registry().gauge_family(
        CHECKPOINT_WAIT_GAUGE, ('dir',)).series(self._checkpoint_dir)
    try:
      while True:
        steps = checkpointing.all_checkpoint_steps(self._checkpoint_dir)
        loaded = self._loaded
        floor = loaded.step if loaded is not None else -1
        # Newest first, never below what is loaded.
        candidates = [s for s in reversed(steps) if s > floor]
        if not candidates and loaded is not None and steps:
          return True
        for step in candidates:
          try:
            return self._load_step(step)
          except CHECKPOINT_SKIP_ERRORS as e:
            logging.warning('CheckpointPredictor: step %d in %s failed to '
                            'restore (%s); trying an older checkpoint.',
                            step, self._checkpoint_dir, e)
        now = time.monotonic()
        if now >= next_report:
          elapsed = now - wait_start
          wait_gauge.set(elapsed)
          logging.warning('CheckpointPredictor: still waiting for a '
                          'checkpoint in %s (%.0fs elapsed).',
                          self._checkpoint_dir, elapsed)
          next_report = now + _WAIT_REPORT_INTERVAL_SECS
        if now > deadline:
          return False
        time.sleep(_POLL_INTERVAL_SECS)
    finally:
      wait_gauge.set(0.0)

  def _load_step(self, step: int) -> bool:
    state = checkpointing.CheckpointManager(
        self._checkpoint_dir, quarantine_damaged=False).restore(
            step, device='cpu')
    variables = {name: self._model.to_device(weights)
                 for name, weights in state.variables().items()}
    self._loaded = _Loaded(variables=variables, step=step)
    return True

  # -- serving ---------------------------------------------------------------

  def _snapshot(self) -> _Loaded:
    loaded = self._loaded  # one read; restore swaps the whole reference
    if loaded is None:
      raise ValueError('The predictor has not been restored yet.')
    return loaded

  @property
  def variables(self):
    """The loaded serving variables."""
    return self._snapshot().variables

  @property
  def versioned_variables(self):
    """``(step, variables)`` of one snapshot, read once: what a server
    swaps in."""
    loaded = self._snapshot()
    return loaded.step, loaded.variables

  def predict_versioned(self, features: Dict[str, np.ndarray]):
    loaded = self._snapshot()
    outputs = self._serve_fn(loaded.variables, dict(features))
    return ({key: value.cpu().numpy() for key, value in outputs.items()},
            loaded.step)

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return self.predict_versioned(features)[0]

  def get_feature_specification(self):
    return self._model.preprocessor.get_in_feature_specification(
        ModeKeys.PREDICT)

  def get_label_specification(self):
    return self._model.get_label_specification(ModeKeys.PREDICT)

  @property
  def is_loaded(self) -> bool:
    return self._loaded is not None

  @property
  def global_step(self) -> int:
    loaded = self._loaded
    return loaded.step if loaded is not None else 0

  @property
  def model_version(self) -> int:
    return self.global_step

  @property
  def model_path(self) -> str:
    return self._checkpoint_dir or ''

  def close(self) -> None:
    self._loaded = None
