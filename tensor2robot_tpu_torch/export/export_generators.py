"""Export generators: versioned serving artifacts, and the one serving
function of a model (the JAX package's ``export/export_generators.py``).

An artifact is a directory under an export root:

    <export_root>/<version>/          (numeric; written as tmp-<version>
      variables/variables.pt           and committed by one os.rename, so
      assets.extra/t2r_assets.pbtxt    a poller never sees half of one)
      assets.extra/t2r_assets.json
      global_step.txt
      serving_config.json
      warmup_requests.npz              (DefaultExportGenerator only)

The file names are the JAX package's. ``variables.pt`` is a ``torch.save``
of ``{'params': {name: tensor}}`` on the CPU (the served weights, the
average where the model averages, with the batch norm statistics), which
``torch.load(weights_only=True)`` reads. The JAX artifact's Orbax
directory and its ``predict_fn.jaxexport`` (StableHLO) have no
counterpart: a port artifact carries no predict function, and its
predictor rebuilds the model from its class.

``make_serve_fn`` is the one serving function: PREDICT preprocessing
(unless the artifact takes raw receivers), then ``model.predict_step`` on
the served weights. The predictors and ``chip_smoke.py`` serve through it,
so serving means the same thing everywhere.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs import assets as assets_lib
from tensor2robot_tpu_torch.specs import generators as spec_generators

__all__ = ['AbstractExportGenerator', 'DefaultExportGenerator',
           'SERVING_CONFIG_FILENAME', 'VARIABLES_SUBDIR',
           'VariablesExportGenerator', 'WARMUP_REQUESTS_FILENAME',
           'garbage_collect_versions', 'list_exported_versions',
           'load_exported_variables', 'load_serving_config', 'make_serve_fn',
           'next_version', 'write_serving_artifact']

VARIABLES_SUBDIR = 'variables'
VARIABLES_FILENAME = 'variables.pt'
WARMUP_REQUESTS_FILENAME = 'warmup_requests.npz'
SERVING_CONFIG_FILENAME = 'serving_config.json'
_TMP_PREFIX = 'tmp-'


def make_serve_fn(model, raw_receivers: bool = False
                  ) -> Callable[..., Dict[str, torch.Tensor]]:
  """``serve(variables, features) -> outputs`` on the model's device.

  ``features`` are arrays or tensors (numpy in, from a robot); they move to
  the model's device, go through the preprocessor in PREDICT mode (not
  where ``raw_receivers``: the client preprocessed them), and
  ``model.predict_step`` turns them into the export outputs (tensors on
  the device).
  """

  def serve(variables, features) -> Dict[str, torch.Tensor]:
    features = {key: torch.as_tensor(value).to(model.device)
                for key, value in features.items()}
    if not raw_receivers:
      features, _ = model.preprocessor.preprocess(features, None,
                                                  ModeKeys.PREDICT)
    return model.predict_step(variables, features)

  return serve


def _cpu(tree):
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu()
  return {key: _cpu(value) for key, value in tree.items()}


def list_exported_versions(export_root: str) -> List[int]:
  """The committed (numeric, renamed into place) versions, ascending."""
  if not os.path.isdir(export_root):
    return []
  return sorted(int(name) for name in os.listdir(export_root)
                if name.isdigit())


def next_version(export_root: str) -> int:
  """The wall-clock second, bumped past the newest existing version."""
  version = int(time.time())
  existing = list_exported_versions(export_root)
  if existing and version <= existing[-1]:
    version = existing[-1] + 1
  return version


def garbage_collect_versions(export_root: str, keep: int) -> None:
  """Deletes all but the newest ``keep`` committed versions."""
  for version in list_exported_versions(export_root)[:-keep or None]:
    shutil.rmtree(os.path.join(export_root, str(version)),
                  ignore_errors=True)


def write_serving_artifact(export_root: str, variables: Any, feature_spec,
                           label_spec, global_step: int,
                           warmup_features: Optional[
                               Dict[str, np.ndarray]] = None,
                           version: Optional[int] = None,
                           raw_receivers: bool = False) -> str:
  """Writes one versioned artifact under ``tmp-<version>`` and commits it
  with one ``os.rename``; returns the committed path."""
  if version is None:
    version = next_version(export_root)
  os.makedirs(export_root, exist_ok=True)
  final_dir = os.path.join(export_root, str(version))
  tmp_dir = os.path.join(export_root, _TMP_PREFIX + str(version))
  os.makedirs(os.path.join(tmp_dir, VARIABLES_SUBDIR))
  torch.save(_cpu(variables), os.path.join(tmp_dir, VARIABLES_SUBDIR,
                                           VARIABLES_FILENAME))
  assets_lib.write_t2r_assets_to_file(
      feature_spec, label_spec, global_step,
      os.path.join(tmp_dir, assets_lib.EXTRA_ASSETS_DIRECTORY,
                   assets_lib.T2R_ASSETS_FILENAME))
  assets_lib.write_global_step_to_file(global_step, tmp_dir)
  if warmup_features is not None:
    np.savez(os.path.join(tmp_dir, WARMUP_REQUESTS_FILENAME),
             **{k: np.asarray(v) for k, v in warmup_features.items()})
  with open(os.path.join(tmp_dir, SERVING_CONFIG_FILENAME), 'w') as f:
    json.dump({'raw_receivers': bool(raw_receivers)}, f)
  os.rename(tmp_dir, final_dir)
  return final_dir


def load_serving_config(version_dir: str) -> dict:
  try:
    with open(os.path.join(version_dir, SERVING_CONFIG_FILENAME)) as f:
      return json.load(f)
  except (OSError, ValueError):
    return {'raw_receivers': False}


def load_exported_variables(version_dir: str) -> Dict[str, Any]:
  """The variables of one exported version, as CPU tensors."""
  return torch.load(os.path.join(version_dir, VARIABLES_SUBDIR,
                                 VARIABLES_FILENAME),
                    map_location='cpu', weights_only=True)


class AbstractExportGenerator:
  """Builds serving artifacts for a model.

  ``export_raw_receivers``: the artifact's declared in-specification is
  the model's feature specification (the client preprocesses); otherwise
  it is the preprocessor's, and serving preprocesses.
  """

  def __init__(self, export_raw_receivers: bool = False):
    self._export_raw_receivers = export_raw_receivers
    self._model = None

  def set_specification_from_model(self, t2r_model) -> None:
    self._model = t2r_model

  @property
  def model(self):
    if self._model is None:
      raise ValueError(
          'set_specification_from_model must be called before exporting.')
    return self._model

  def serving_feature_spec(self):
    """The in-specification the serving client feeds."""
    if self._export_raw_receivers:
      return self.model.get_feature_specification(ModeKeys.PREDICT)
    return self.model.preprocessor.get_in_feature_specification(
        ModeKeys.PREDICT)

  def create_serving_fn(self):
    return make_serve_fn(self.model, raw_receivers=self._export_raw_receivers)

  def warmup_features(self, batch_size: int) -> Optional[Dict[str,
                                                               np.ndarray]]:
    """A random request batch of the serving specification."""
    return spec_generators.make_random_numpy(self.serving_feature_spec(),
                                             batch_size=batch_size)

  def export(self, export_root: str, variables, global_step: int,
             batch_size: int = 1, version: Optional[int] = None) -> str:
    """Writes one artifact of ``variables``; returns its path."""
    return write_serving_artifact(
        export_root, variables, self.serving_feature_spec(),
        self.model.get_label_specification(ModeKeys.PREDICT), global_step,
        warmup_features=self.warmup_features(batch_size), version=version,
        raw_receivers=self._export_raw_receivers)


class DefaultExportGenerator(AbstractExportGenerator):
  """The standard generator: serving preprocesses, and the artifact holds
  a warmup request batch."""


class VariablesExportGenerator(AbstractExportGenerator):
  """An artifact without the warmup batch, for frequent in-process
  consumers that hold the model class already (a target network polling a
  lagged export)."""

  def warmup_features(self, batch_size: int):
    del batch_size
    return None
