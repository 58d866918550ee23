"""ExportedModelPredictor: serve the newest version under an export root
(the JAX package's ``predictors/exported_model_predictor.py``).

``restore`` polls the export root (``<model_dir>/export/<exporter>``) for
a committed numeric version newer than the loaded one, skipping the
``tmp-`` directories of exports still being written, and waits for one up
to ``timeout`` seconds. A version that vanishes (or fails to load) while it
is read, as retention may remove it, falls back to the next newest. The
global step comes from the artifact's assets (``global_step.txt`` where
they lack it).

A port artifact carries no predict function (``export_generators``), so
the predictor needs the model: it serves the artifact's variables through
the model's one serving function (``make_serve_fn``), honouring the
artifact's receiver mode. Every field a serving call reads lives in one
immutable snapshot, ``_Loaded``, swapped in as one reference: a predict
sees all of one version or all of the next, and ``versioned_variables``
hands a server the ``(version, variables)`` pair of one snapshot to
hot-swap (``PolicyServer.swap_from_predictor``, which ``serving/serve.py
--export_dir`` polls).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np

from tensor2robot_tpu_torch.export import export_generators
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.specs import assets as assets_lib

__all__ = ['EXPORT_WAIT_GAUGE', 'ExportedModelPredictor']

_POLL_INTERVAL_SECS = 1.0
_WAIT_REPORT_INTERVAL_SECS = 10.0
EXPORT_WAIT_GAUGE = 'inference/export_wait_seconds'
# A version that fails to load with one of these (removed by retention or
# half written while read) falls back to the next newest.
_SKIP_ERRORS = (ValueError, OSError, RuntimeError, EOFError,
                pickle.UnpicklingError)


class _Loaded(NamedTuple):
  """One loaded export version, swapped in as a single reference."""

  variables: Any
  serve_fn: Any
  raw_receivers: bool
  feature_spec: Any
  label_spec: Any
  version: int
  global_step: int
  model_path: str


class ExportedModelPredictor(AbstractPredictor):
  """Serves the newest artifact under an export root directory."""

  def __init__(self, export_dir: str, t2r_model=None,
               timeout: float = 600.0):
    """Args:
      export_dir: the versioned export root, e.g.
        ``<model_dir>/export/latest_exporter``.
      t2r_model: the model whose serving function runs the artifact's
        variables (on its device). Required: a port artifact holds no
        predict function.
      timeout: the most seconds ``restore`` waits for a new version.
    """
    if t2r_model is None:
      raise ValueError('ExportedModelPredictor needs the t2r_model: the '
                       "port's artifacts carry no predict function.")
    self._export_dir = export_dir
    self._model = t2r_model
    self._timeout = timeout
    self._loaded: Optional[_Loaded] = None

  # -- restore ---------------------------------------------------------------

  def _try_load_version(self, version: int) -> bool:
    version_dir = os.path.join(self._export_dir, str(version))
    try:
      feature_spec, label_spec, step = assets_lib.load_t2r_assets_from_file(
          os.path.join(version_dir, assets_lib.EXTRA_ASSETS_DIRECTORY,
                       assets_lib.T2R_ASSETS_FILENAME))
      saved = export_generators.load_exported_variables(version_dir)
      if step is None:
        step = assets_lib.load_global_step_from_file(version_dir)
    except _SKIP_ERRORS as e:
      logging.warning('ExportedModelPredictor: version %d in %s failed to '
                      'load (%s); trying an older one.', version,
                      self._export_dir, e)
      return False
    raw = bool(export_generators.load_serving_config(version_dir).get(
        'raw_receivers', False))
    previous = self._loaded
    if previous is not None and previous.raw_receivers == raw:
      serve_fn = previous.serve_fn
    else:
      serve_fn = export_generators.make_serve_fn(self._model,
                                                 raw_receivers=raw)
    variables = {name: self._model.to_device(weights)
                 for name, weights in saved.items()}
    # Built whole before the one assignment: a concurrent predict sees all
    # of the old version or all of the new one.
    self._loaded = _Loaded(
        variables=variables, serve_fn=serve_fn, raw_receivers=raw,
        feature_spec=feature_spec, label_spec=label_spec, version=version,
        global_step=int(step or 0), model_path=version_dir)
    return True

  def restore(self) -> bool:
    """Waits for a version newer than the loaded one, then loads it.

    Returns True once loaded, or at once when the loaded version is still
    the newest; False when ``timeout`` passes first.
    """
    wait_start = time.monotonic()
    deadline = wait_start + self._timeout
    next_report = wait_start + _WAIT_REPORT_INTERVAL_SECS
    wait_gauge = get_registry().gauge_family(
        EXPORT_WAIT_GAUGE, ('dir',)).series(self._export_dir)
    try:
      while True:
        versions = export_generators.list_exported_versions(self._export_dir)
        loaded = self._loaded
        fresh = [v for v in versions if loaded is None or v > loaded.version]
        for version in reversed(fresh):
          if self._try_load_version(version):
            return True
        if loaded is not None and versions:
          return True
        now = time.monotonic()
        if now >= next_report:
          elapsed = now - wait_start
          wait_gauge.set(elapsed)
          logging.warning('ExportedModelPredictor: still waiting for an '
                          'export in %s (%.0fs elapsed).', self._export_dir,
                          elapsed)
          next_report = now + _WAIT_REPORT_INTERVAL_SECS
        if now > deadline:
          return False
        time.sleep(_POLL_INTERVAL_SECS)
    finally:
      wait_gauge.set(0.0)

  # -- serving ---------------------------------------------------------------

  def _snapshot(self) -> _Loaded:
    loaded = self._loaded  # one read; restore swaps the whole reference
    if loaded is None:
      raise ValueError('The predictor has not been restored yet.')
    return loaded

  @property
  def variables(self):
    return self._snapshot().variables

  @property
  def versioned_variables(self):
    """``(version, variables)`` of one snapshot: what a server swaps in."""
    loaded = self._snapshot()
    return loaded.version, loaded.variables

  def predict_versioned(self, features: Dict[str, np.ndarray]):
    loaded = self._snapshot()
    outputs = loaded.serve_fn(loaded.variables, dict(features))
    return ({key: value.cpu().numpy() for key, value in outputs.items()},
            loaded.version)

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return self.predict_versioned(features)[0]

  def get_feature_specification(self):
    return self._snapshot().feature_spec

  def get_label_specification(self):
    return self._snapshot().label_spec

  @property
  def is_loaded(self) -> bool:
    return self._loaded is not None

  @property
  def model_version(self) -> int:
    loaded = self._loaded
    return loaded.version if loaded is not None else 0

  @property
  def global_step(self) -> int:
    loaded = self._loaded
    return loaded.global_step if loaded is not None else 0

  @property
  def model_path(self) -> str:
    loaded = self._loaded
    return loaded.model_path if loaded is not None else ''

  def close(self) -> None:
    self._loaded = None
