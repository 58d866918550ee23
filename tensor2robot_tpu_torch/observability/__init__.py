"""Metrics and telemetry files of the port (copies of the JAX package's
jax-free readers and writers, with the same names and record kinds)."""

from tensor2robot_tpu_torch.observability.registry import (
    DEFAULT_LATENCY_BUCKETS_MS,
    DEFAULT_SECONDS_BUCKETS,
    SLO_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    TelemetryRegistry,
    get_registry,
    set_registry,
)
from tensor2robot_tpu_torch.observability.telemetry_file import (
    TelemetryLogger,
    discover_hosts,
    read_heartbeat,
    read_telemetry,
)

__all__ = [
    'Counter',
    'DEFAULT_LATENCY_BUCKETS_MS',
    'DEFAULT_SECONDS_BUCKETS',
    'Gauge',
    'Histogram',
    'SLO_LATENCY_BUCKETS_MS',
    'TelemetryLogger',
    'TelemetryRegistry',
    'discover_hosts',
    'get_registry',
    'read_heartbeat',
    'read_telemetry',
    'set_registry',
]
