"""Training hooks of the port (the JAX package's ``hooks/``): periodic
exports, lagged target-network exports and variable logging."""

from tensor2robot_tpu_torch.hooks.hook_builder import HookBuilder, TrainHook
from tensor2robot_tpu_torch.hooks.checkpoint_hooks import (
    CheckpointExportHook,
    LaggedCheckpointExportHook,
)
from tensor2robot_tpu_torch.hooks.async_export_hook_builder import (
    AsyncExportHookBuilder,
)
from tensor2robot_tpu_torch.hooks.td3 import TD3Hooks
from tensor2robot_tpu_torch.hooks.variable_logger_hook import (
    VariableLoggerHook,
)

__all__ = [
    'AsyncExportHookBuilder',
    'CheckpointExportHook',
    'HookBuilder',
    'LaggedCheckpointExportHook',
    'TD3Hooks',
    'TrainHook',
    'VariableLoggerHook',
]
