"""paddle_tpu_torch.observability — metrics, events and per-request
tracing for the port's serving stack.

Counterpart of ``paddle_tpu/observability`` (the port keeps its own copy:
it imports nothing of ``paddle_tpu``), with the same metric names, label
sets and JSON shapes (docs/OBSERVABILITY.md), so ``tools/metrics_dump.py``
reads a port server unchanged:

* :mod:`.metrics` — thread-safe registry of Counter/Gauge/Histogram
  instruments, Prometheus text exposition (``GET /metrics``) and a JSON
  snapshot (``GET /stats``).
* :mod:`.events` — bounded structured-event ring (``GET /events``) with
  chrome-trace export.
* :mod:`.engine_metrics` — the instrument bundle the continuous-batching
  engine records into (JAX's whole catalogue).
* :mod:`.fleet_metrics` — the fleet router's bundle (replica states,
  routing decisions, failovers, quota rejections, scaling).
* :mod:`.disagg_metrics` — the disaggregated prefill / decode bundle
  (hand-off pages, bytes and latency, the in-flight gauge, routing
  decisions, colocated fallbacks).
* :mod:`.transport_metrics` — the sockets transport's bundle (reconnects,
  retries, heartbeat misses, frames, wire bytes, round-trip times).
* :mod:`.tracing` — per-request tracing: phase clocks accrued at scheduler
  mutation points, materialized as spans at retirement, kept by a bounded
  tail-sampling :class:`TraceStore` (``GET /traces``, ``GET /trace/<rid>``).

Everything is host-side: instrumentation launches no kernel and adds no
device sync — values are recorded from numbers the engine already holds
on the host.
"""

from .events import EventRing, default_ring            # noqa: F401
from .metrics import (Counter, Gauge, Histogram,       # noqa: F401
                      MetricsRegistry, default_registry)
from .engine_metrics import (EngineMetrics,            # noqa: F401
                             bind_engine_gauges)
from .fleet_metrics import FleetMetrics                # noqa: F401
from .disagg_metrics import DisaggMetrics              # noqa: F401
from .transport_metrics import TransportMetrics        # noqa: F401
from .tracing import (PHASES, TraceContext, Tracer,    # noqa: F401
                      TraceStore, advance_phase, default_tracer,
                      finalize_request_trace, phase_clocks)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "EventRing", "default_ring",
           "EngineMetrics", "bind_engine_gauges", "FleetMetrics",
           "DisaggMetrics", "TransportMetrics", "PHASES",
           "TraceContext", "Tracer",
           "TraceStore", "advance_phase", "default_tracer",
           "finalize_request_trace", "phase_clocks"]
