"""The deadline batcher under its historical name: a re-export of
:mod:`tensor2robot_tpu_torch.serving.batching`, as the JAX package's
``serving/batcher.py`` re-exports its ``serving/batching.py``."""

from tensor2robot_tpu_torch.serving.batching import (
    DeadlineBatcher,
    PendingRequest,
    pad_batch,
    split_outputs,
)

__all__ = ['DeadlineBatcher', 'PendingRequest', 'pad_batch',
           'split_outputs']
