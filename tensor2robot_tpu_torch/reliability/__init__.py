"""The port's fault-tolerance layer: bounded retry, deterministic fault
injection at named sites, and the corrupt-record quarantine (copies of the
JAX package's ``reliability/`` modules that the replay service and the RL
loop use)."""

from tensor2robot_tpu_torch.reliability.errors import (
    CorruptionBudgetExceeded,
    CorruptRecordError,
    RetryError,
    TRANSIENT_IO_ERRORS,
)
from tensor2robot_tpu_torch.reliability.fault_injection import (
    FaultInjector,
    set_injector,
)
from tensor2robot_tpu_torch.reliability.quarantine import RecordQuarantine
from tensor2robot_tpu_torch.reliability.retry import RetryPolicy, retry

__all__ = [
    'CorruptRecordError',
    'CorruptionBudgetExceeded',
    'FaultInjector',
    'RecordQuarantine',
    'RetryError',
    'RetryPolicy',
    'TRANSIENT_IO_ERRORS',
    'retry',
    'set_injector',
]
