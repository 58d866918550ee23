"""Admission control under its historical name: a re-export of
:mod:`tensor2robot_tpu_torch.serving.batching`, as the JAX package's
``serving/admission.py`` re-exports its ``serving/batching.py``."""

from tensor2robot_tpu_torch.serving.batching import (
    SERVING_REJECTED_COUNTER,
    AdmissionController,
    RequestRejected,
)

__all__ = ['AdmissionController', 'RequestRejected',
           'SERVING_REJECTED_COUNTER']
