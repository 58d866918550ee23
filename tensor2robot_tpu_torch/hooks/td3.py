"""TD3Hooks: the latest and the lagged export directories of a
filesystem target network (the JAX package's ``hooks/td3.py``)."""

from __future__ import annotations

import os
from typing import List

from tensor2robot_tpu_torch.hooks.checkpoint_hooks import (
    LaggedCheckpointExportHook)
from tensor2robot_tpu_torch.hooks.hook_builder import HookBuilder, TrainHook

__all__ = ['TD3Hooks']


class TD3Hooks(HookBuilder):
  """Exports every ``save_steps`` into ``export_dir`` and keeps
  ``lagged_export_dir`` one export behind (by default
  ``<model_dir>/export/latest_exporter`` and ``.../lagged_exporter``)."""

  def __init__(self, export_dir: str = '', lagged_export_dir: str = '',
               save_steps: int = 500, exports_to_keep: int = 5,
               export_generator=None):
    self._export_dir = export_dir
    self._lagged_export_dir = lagged_export_dir
    self._save_steps = save_steps
    self._exports_to_keep = exports_to_keep
    self._export_generator = export_generator

  def create_hooks(self, t2r_model, trainer) -> List[TrainHook]:
    del t2r_model
    export_dir = self._export_dir or os.path.join(
        trainer.model_dir, 'export', 'latest_exporter')
    lagged_dir = self._lagged_export_dir or os.path.join(
        trainer.model_dir, 'export', 'lagged_exporter')
    return [LaggedCheckpointExportHook(
        export_dir, lagged_dir, export_every_steps=self._save_steps,
        exports_to_keep=self._exports_to_keep,
        export_generator=self._export_generator)]
