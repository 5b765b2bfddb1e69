"""Instrument bundle for the fleet's sockets transport.

Counterpart of ``paddle_tpu/observability/transport_metrics.py`` (the
port's own copy, the same names, help texts and buckets): one
:class:`TransportMetrics` per fleet router that owns remote replica
connections (``paddle_tpu_torch/fleet/transport.py``), created against the
registry the replicas and the router publish to, so ``GET /metrics`` on a
:class:`~paddle_tpu_torch.fleet.FleetServer` stays one aggregated
exposition.

The counters are incremented inside
:class:`~paddle_tpu_torch.fleet.transport.Connection`, under its lock,
never by a scrape-time callback.
"""

from __future__ import annotations

from .events import EventRing
from .metrics import MetricsRegistry, default_registry

__all__ = ["TransportMetrics"]


class TransportMetrics:
    """All instruments the sockets transport records into."""

    def __init__(self, registry: MetricsRegistry = None, ring=None):
        r = registry if registry is not None else default_registry()
        self.registry = r
        self.ring = ring if ring is not None else EventRing()

        self.reconnects = r.counter(
            "paddle_tpu_transport_reconnects_total",
            "Re-dials of a replica agent connection after a drop "
            "(the first dial of a fresh connection is not counted)")
        self.retries = r.counter(
            "paddle_tpu_transport_retries_total",
            "Idempotent RPC attempts re-sent after a transport "
            "failure (exponential backoff + seeded jitter between "
            "attempts)")
        self.heartbeat_misses = r.counter(
            "paddle_tpu_transport_heartbeat_misses_total",
            "RPC attempts that failed to complete a round-trip "
            "(timeout, reset, injected fault) — each one ages the "
            "replica's lease toward expiry")
        self.frames = r.counter(
            "paddle_tpu_transport_frames_total",
            "Completed request/response frame round-trips")
        self.bytes = r.counter(
            "paddle_tpu_transport_bytes_total",
            "Wire bytes moved (request + response frames, KV blob "
            "payloads included)")
        self.rtt_seconds = r.histogram(
            "paddle_tpu_transport_rtt_seconds",
            "Round-trip time of completed RPCs (send first byte to "
            "response fully parsed)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
