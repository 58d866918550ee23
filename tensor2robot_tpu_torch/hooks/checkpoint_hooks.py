"""Export hooks: a serving artifact every N steps, and a second export
directory one version behind (the JAX package's
``hooks/checkpoint_hooks.py``).

``CheckpointExportHook`` exports every ``export_every_steps`` and at the
end, so that predictors can poll fresh weights while training goes on.
``LaggedCheckpointExportHook`` also keeps a directory one export behind:
a TD3 target network kept on the filesystem, which actors read for the
target Q. Both keep the newest ``exports_to_keep`` versions.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from tensor2robot_tpu_torch.export import export_generators
from tensor2robot_tpu_torch.export.exporters import serving_variables
from tensor2robot_tpu_torch.hooks.hook_builder import TrainHook

__all__ = ['CheckpointExportHook', 'LaggedCheckpointExportHook']

_gc_versions = export_generators.garbage_collect_versions


class CheckpointExportHook(TrainHook):
  """Exports a serving artifact every ``export_every_steps``."""

  def __init__(self, export_dir: str, export_every_steps: int = 500,
               exports_to_keep: int = 5, export_generator=None,
               batch_size: int = 1):
    self._export_dir = export_dir
    self._export_every_steps = export_every_steps
    self._exports_to_keep = exports_to_keep
    self._export_generator = (export_generator or
                              export_generators.DefaultExportGenerator())
    self._batch_size = batch_size
    self._last_exported_step: Optional[int] = None

  @property
  def export_dir(self) -> str:
    return self._export_dir

  def _export(self, trainer, state) -> Optional[str]:
    step = int(state.step)
    if step == self._last_exported_step:
      return None
    self._export_generator.set_specification_from_model(trainer.model)
    path = self._export_generator.export(
        self._export_dir,
        serving_variables(state, trainer.model.use_avg_model_params), step,
        batch_size=self._batch_size)
    self._last_exported_step = step
    _gc_versions(self._export_dir, self._exports_to_keep)
    return path

  def after_step(self, trainer, state, step: int, metrics) -> None:
    if step % self._export_every_steps == 0:
      self._export(trainer, state)

  def end(self, trainer, state) -> None:
    self._export(trainer, state)


class LaggedCheckpointExportHook(CheckpointExportHook):
  """Keeps ``export_dir`` and ``lagged_export_dir``, the second one export
  behind: before a new version lands in ``export_dir`` the newest one
  there is copied into the lagged directory."""

  def __init__(self, export_dir: str, lagged_export_dir: str, **kwargs):
    super().__init__(export_dir, **kwargs)
    self._lagged_export_dir = lagged_export_dir

  @property
  def lagged_export_dir(self) -> str:
    return self._lagged_export_dir

  def _mirror_version(self, version_dir: str) -> None:
    """Copies one version into the lagged directory under a ``tmp-`` name
    and renames it into place (once)."""
    version = os.path.basename(version_dir)
    target = os.path.join(self._lagged_export_dir, version)
    if os.path.isdir(target):
      return
    os.makedirs(self._lagged_export_dir, exist_ok=True)
    tmp = os.path.join(self._lagged_export_dir, 'tmp-' + version)
    shutil.copytree(version_dir, tmp)
    os.rename(tmp, target)

  def _export(self, trainer, state):
    if int(state.step) == self._last_exported_step:
      # No new export lands: the lagged directory must not catch up.
      return None
    latest = export_generators.list_exported_versions(self._export_dir)
    if latest:
      self._mirror_version(os.path.join(self._export_dir, str(latest[-1])))
      _gc_versions(self._lagged_export_dir, self._exports_to_keep)
    path = super()._export(trainer, state)
    if path is not None and not export_generators.list_exported_versions(
        self._lagged_export_dir):
      # The first export: the lagged directory starts with it.
      self._mirror_version(path)
    return path
