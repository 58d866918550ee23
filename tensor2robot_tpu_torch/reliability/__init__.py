"""The port's fault-tolerance layer (copies of the JAX package's
``reliability/`` modules): bounded retry, deterministic fault injection at
named sites, the corrupt-record quarantine and preemption-safe shutdown.
The trainer, the checkpoint manager, the record reader, the device feed,
the replay service and the RL loop wire them in at their sites
(``fault_injection``'s note)."""

from tensor2robot_tpu_torch.reliability.errors import (
    CHECKPOINT_SKIP_ERRORS,
    CorruptCheckpointError,
    CorruptionBudgetExceeded,
    CorruptRecordError,
    InjectedFault,
    NonFiniteLossError,
    RetryError,
    TrainingPreempted,
    TRANSIENT_IO_ERRORS,
)
from tensor2robot_tpu_torch.reliability.fault_injection import (
    FaultInjector,
    SITE_CKPT_RESTORE,
    SITE_CKPT_SAVE,
    SITE_DATA_READ,
    SITE_STEP_NAN,
    configure_fault_injector,
    get_injector,
    set_injector,
)
from tensor2robot_tpu_torch.reliability.preemption import graceful_shutdown
from tensor2robot_tpu_torch.reliability.quarantine import RecordQuarantine
from tensor2robot_tpu_torch.reliability.retry import RetryPolicy, retry

__all__ = [
    'CHECKPOINT_SKIP_ERRORS',
    'CorruptCheckpointError',
    'CorruptRecordError',
    'CorruptionBudgetExceeded',
    'FaultInjector',
    'InjectedFault',
    'NonFiniteLossError',
    'RecordQuarantine',
    'RetryError',
    'RetryPolicy',
    'SITE_CKPT_RESTORE',
    'SITE_CKPT_SAVE',
    'SITE_DATA_READ',
    'SITE_STEP_NAN',
    'TRANSIENT_IO_ERRORS',
    'TrainingPreempted',
    'configure_fault_injector',
    'get_injector',
    'graceful_shutdown',
    'retry',
    'set_injector',
]
