"""Batched, SLO-tracked policy serving on the GPU.

``PolicyServer`` (`server.py`) coalesces concurrent requests into padded
batches (`batching.py`), runs them through one batch function and reports
latency against an SLO; `frontend.py` is its HTTP/JSON door and
``python -m tensor2robot_tpu_torch.serving.serve`` its entry point.
"""

from tensor2robot_tpu_torch.serving.batching import (
    AdmissionController,
    DeadlineBatcher,
    PendingRequest,
    RequestRejected,
    pad_batch,
    split_outputs,
)
from tensor2robot_tpu_torch.serving.server import (
    SERVING_RECORD_KIND,
    PolicyServer,
    ServeResult,
    ServingConfig,
)

__all__ = [
    'AdmissionController',
    'DeadlineBatcher',
    'PendingRequest',
    'PolicyServer',
    'RequestRejected',
    'SERVING_RECORD_KIND',
    'ServeResult',
    'ServingConfig',
    'pad_batch',
    'split_outputs',
]
