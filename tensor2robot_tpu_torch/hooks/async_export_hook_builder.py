"""AsyncExportHookBuilder: an export per N steps while training goes on
(the JAX package's ``hooks/async_export_hook_builder.py``)."""

from __future__ import annotations

import os
from typing import List

from tensor2robot_tpu_torch.hooks.checkpoint_hooks import CheckpointExportHook
from tensor2robot_tpu_torch.hooks.hook_builder import HookBuilder, TrainHook

__all__ = ['AsyncExportHookBuilder', 'DEFAULT_EXPORT_DIRNAME']

DEFAULT_EXPORT_DIRNAME = os.path.join('export', 'latest_exporter')


class AsyncExportHookBuilder(HookBuilder):
  """Builds the hook that exports every ``save_steps`` into ``export_dir``
  (``<model_dir>/export/latest_exporter`` by default). ``save_secs`` is
  taken for the JAX signature's sake; the trainer counts steps."""

  def __init__(self, export_dir: str = '', save_secs: int = 90,
               save_steps: int = 500, exports_to_keep: int = 5,
               export_generator=None):
    del save_secs
    self._export_dir = export_dir
    self._save_steps = save_steps
    self._exports_to_keep = exports_to_keep
    self._export_generator = export_generator

  def create_hooks(self, t2r_model, trainer) -> List[TrainHook]:
    del t2r_model
    export_dir = self._export_dir or os.path.join(trainer.model_dir,
                                                  DEFAULT_EXPORT_DIRNAME)
    return [CheckpointExportHook(export_dir,
                                 export_every_steps=self._save_steps,
                                 exports_to_keep=self._exports_to_keep,
                                 export_generator=self._export_generator)]
