"""Latest and best exporters, run after each eval (the JAX package's
``export/exporters.py``).

``train_eval_model`` calls every exporter of ``create_exporters_fn`` after
each eval with ``(trainer, state, eval_metrics)``. Each writes a versioned
serving artifact (``export_generators``) under
``<model_dir>/export/<name>`` and keeps the newest ``exports_to_keep``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from tensor2robot_tpu_torch.export import export_generators

__all__ = ['BestModelExporter', 'EXPORT_SUBDIR', 'LatestModelExporter',
           'create_default_exporters', 'serving_variables']

EXPORT_SUBDIR = 'export'


def serving_variables(state, use_avg_params: bool) -> Dict[str, Any]:
  """What an artifact holds: ``{'params': weights}``, the weights being
  the average where ``use_avg_params`` (and the state keeps one), with the
  batch norm statistics."""
  params = (state.avg_params if use_avg_params and
            state.avg_params is not None else state.params)
  return {'params': {**params, **state.model_state}}


def _loss_compare_fn(best: Optional[Dict[str, float]],
                     current: Dict[str, float], key: str = 'loss') -> bool:
  """True when ``current`` beats ``best`` (lower ``key``); a missing key in
  ``current`` never does, a missing best always loses."""
  if current is None or key not in current:
    return False
  if best is None or key not in best:
    return True
  return float(current[key]) < float(best[key])


class _ExporterBase:
  """Resolves the export root, writes one artifact, collects old ones."""

  def __init__(self, name: str,
               export_generator: Optional[
                   export_generators.AbstractExportGenerator] = None,
               exports_to_keep: int = 5,
               use_avg_params: Optional[bool] = None):
    self.name = name
    self._export_generator = (export_generator or
                              export_generators.DefaultExportGenerator())
    self._exports_to_keep = exports_to_keep
    self._use_avg_params = use_avg_params

  def export_root(self, trainer) -> str:
    return os.path.join(trainer.model_dir, EXPORT_SUBDIR, self.name)

  def _write(self, trainer, state) -> str:
    model = trainer.model
    self._export_generator.set_specification_from_model(model)
    use_avg = (model.use_avg_model_params if self._use_avg_params is None
               else self._use_avg_params)
    root = self.export_root(trainer)
    path = self._export_generator.export(
        root, serving_variables(state, use_avg), int(state.step))
    export_generators.garbage_collect_versions(root, self._exports_to_keep)
    return path

  def export(self, trainer, state, eval_metrics) -> Optional[str]:
    raise NotImplementedError


class LatestModelExporter(_ExporterBase):
  """Exports after every eval, keeping the newest ``exports_to_keep``."""

  def __init__(self, name: str = 'latest_exporter', **kwargs):
    super().__init__(name=name, **kwargs)

  def export(self, trainer, state, eval_metrics) -> Optional[str]:
    del eval_metrics
    return self._write(trainer, state)


class BestModelExporter(_ExporterBase):
  """Exports only when ``metric_key`` improves (lower is better). The best
  value survives restarts in ``best_metrics.json`` beside the exports."""

  def __init__(self, name: str = 'best_exporter', metric_key: str = 'loss',
               **kwargs):
    super().__init__(name=name, **kwargs)
    self._metric_key = metric_key

  def _state_path(self, trainer) -> str:
    return os.path.join(self.export_root(trainer), 'best_metrics.json')

  def _load_best(self, trainer) -> Optional[Dict[str, Any]]:
    try:
      with open(self._state_path(trainer)) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def export(self, trainer, state, eval_metrics) -> Optional[str]:
    if not _loss_compare_fn(self._load_best(trainer), eval_metrics,
                            self._metric_key):
      return None
    path = self._write(trainer, state)
    os.makedirs(self.export_root(trainer), exist_ok=True)
    with open(self._state_path(trainer), 'w') as f:
      json.dump({self._metric_key: float(eval_metrics[self._metric_key])}, f)
    return path


def create_default_exporters(t2r_model,
                             export_generator: Optional[
                                 export_generators.AbstractExportGenerator
                             ] = None,
                             exports_to_keep: int = 5,
                             metric_key: str = 'loss'):
  """The best and the latest exporter (``train_qtopt.gin``'s
  ``create_exporters_fn``)."""
  del t2r_model  # bound at each export (set_specification_from_model)
  return [
      BestModelExporter(export_generator=export_generator,
                        exports_to_keep=exports_to_keep,
                        metric_key=metric_key),
      LatestModelExporter(export_generator=export_generator,
                          exports_to_keep=exports_to_keep),
  ]
