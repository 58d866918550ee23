"""Batched, SLO-tracked policy serving on the GPU, one server or a fleet.

``PolicyServer`` (`server.py`) coalesces concurrent requests into padded
batches (`batching.py`; `batcher.py` and `admission.py` re-export parts of
it under the JAX package's older names for callers that import those),
runs them through one batch function and
reports latency against an SLO. ``ServingFleet`` (`fleet.py`) runs N of
them behind the telemetry-weighted ``FleetRouter`` (`router.py`), with
ejection and exactly-once retry, autoscaling and rolling swaps;
`fleet_bench.py` measures its scaling curve. `frontend.py` is the HTTP/JSON
door of either, and ``python -m tensor2robot_tpu_torch.serving.serve`` the
entry point.
"""

from tensor2robot_tpu_torch.serving.batching import (
    SERVING_REJECTED_COUNTER,
    AdmissionController,
    DeadlineBatcher,
    PendingRequest,
    RequestRejected,
    pad_batch,
    split_outputs,
)
from tensor2robot_tpu_torch.serving.fleet import (
    SERVING_FLEET_BENCH_KEYS,
    SERVING_FLEET_RECORD_KIND,
    SERVING_FLEET_SCHEMA,
    ServingFleet,
    ServingFleetConfig,
    replica_host_meta,
    router_host_meta,
)
from tensor2robot_tpu_torch.serving.router import (
    FleetRouter,
    HttpReplicaHandle,
    LocalReplicaHandle,
    ReplicaHandle,
    ReplicaUnreachable,
    RoutedResult,
    RouterConfig,
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
    'FleetRouter',
    'HttpReplicaHandle',
    'LocalReplicaHandle',
    'PendingRequest',
    'PolicyServer',
    'ReplicaHandle',
    'ReplicaUnreachable',
    'RequestRejected',
    'RoutedResult',
    'RouterConfig',
    'SERVING_FLEET_BENCH_KEYS',
    'SERVING_FLEET_RECORD_KIND',
    'SERVING_FLEET_SCHEMA',
    'SERVING_RECORD_KIND',
    'SERVING_REJECTED_COUNTER',
    'ServeResult',
    'ServingConfig',
    'ServingFleet',
    'ServingFleetConfig',
    'pad_batch',
    'split_outputs',
    'replica_host_meta',
    'router_host_meta',
]
