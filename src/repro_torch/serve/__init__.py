"""``repro_torch.serve`` — the continuously-running robust-aggregation
service, the port of the JAX package's ``repro.serve``.

Simulated worker clients push ``(worker_id, round, update)`` messages into a
bounded ring buffer; the server drains them through the session's per-round
step (MLMC estimation + aggregation + optimizer update, on a card the
replay of the round's level graph), checkpoints the carry on an interval,
and exposes health / throughput / staleness metrics over a lightweight HTTP
endpoint plus a structured JSONL metrics log. A worker that misses its
round deadline is masked as dynamically Byzantine for that round, a full
ring applies backpressure to submitters, and shutdown is a graceful drain
with a bitwise-resumable final checkpoint. Only the server's round loop
issues CUDA work.
"""
from repro_torch.serve.client import SimulatedWorkers, worker_payloads
from repro_torch.serve.health import HealthEndpoint
from repro_torch.serve.metrics import MetricsLog, ServeMetrics
from repro_torch.serve.ring import RingBuffer
from repro_torch.serve.server import AggregationServer, ServeConfig, Update

__all__ = [
    "AggregationServer", "ServeConfig", "Update", "RingBuffer",
    "ServeMetrics", "MetricsLog", "HealthEndpoint",
    "SimulatedWorkers", "worker_payloads",
]
