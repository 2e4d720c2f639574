"""Streams, health probes, tracing and timing helpers of the port."""

from datasketch_tpu_torch.utils.health import HealthMonitor, device_healthcheck
from datasketch_tpu_torch.utils.pipeline import stream_batches
from datasketch_tpu_torch.utils.profiling import device_sync, time_op, trace

__all__ = [
    "trace",
    "time_op",
    "device_sync",
    "stream_batches",
    "device_healthcheck",
    "HealthMonitor",
]
