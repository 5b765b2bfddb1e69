"""Instrument bundle for disaggregated prefill / decode serving.

Counterpart of ``paddle_tpu/observability/disagg_metrics.py`` (the port's
own copy): one :class:`DisaggMetrics` per hand-off pipeline, the in-process
:class:`~paddle_tpu_torch.models.disagg.DisaggCoordinator` or a
:class:`~paddle_tpu_torch.fleet.FleetRouter` with prefill and decode roles,
created against the registry the engines share, so ``GET /metrics`` on the
serving front is one aggregated exposition (duplicate names resolve to the
shared instruments).

The registry is label-free, so ``disagg_routed_total{decision="prefill"}``
is one instrument per decision.  The in-flight gauge is set from inside
the pipeline's step, under the coordinator's or router's lock, never by a
scrape-time callback reading the hand-off queue unlocked.
"""

from __future__ import annotations

from .events import EventRing
from .metrics import MetricsRegistry, default_registry

__all__ = ["DisaggMetrics"]

# handoff latency: staging flush + adopt of a few pages (tens of us on
# CPU smoke) .. a long context shipped over a slow link
_HANDOFF_BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                    0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 10.0)


class DisaggMetrics:
    """All instruments the disaggregation tier records into."""

    def __init__(self, registry: MetricsRegistry = None, ring=None):
        r = registry if registry is not None else default_registry()
        self.registry = r
        self.ring = ring if ring is not None else EventRing()

        # -- handoff traffic (ship + restore, the bytes the cost
        #    model prices against the prefill stall) -------------------
        self.handoff_pages = r.counter(
            "paddle_tpu_disagg_handoff_pages_total",
            "KV pages shipped prefill->decode through completed "
            "handoffs (staging gather + batched restore scatter)")
        self.handoff_bytes = r.counter(
            "paddle_tpu_disagg_handoff_bytes_total",
            "Bytes of KV context shipped through completed handoffs "
            "(page_bytes per page; int8 scale planes included)")
        self.handoff_seconds = r.histogram(
            "paddle_tpu_disagg_handoff_seconds",
            "Per-handoff wall: staging-flush materialisation + "
            "decode-side adopt (the restore scatter itself rides the "
            "decode engine's admission)", buckets=_HANDOFF_BUCKETS)
        self.handoff_inflight = r.gauge(
            "paddle_tpu_disagg_handoff_inflight_count",
            "Handoffs in flight: exported-not-yet-shipped + shipped-"
            "not-yet-admitted (the bounded queue backpressuring "
            "prefill admission)")

        # -- per-request routing decisions (flattening of
        #    disagg_routed_total{decision=...}) ------------------------
        self.routed_prefill = r.counter(
            "paddle_tpu_disagg_routed_prefill_total",
            "Requests the bytes-vs-FLOPs cost model sent to a prefill "
            "engine (handoff beats stalling the decode device)")
        self.routed_colocated = r.counter(
            "paddle_tpu_disagg_routed_colocated_total",
            "Requests the cost model kept colocated on the decode "
            "engine (short prompts: the prefill stall is cheaper "
            "than shipping the pages)")

        # -- degradation ------------------------------------------------
        self.colocated_fallback = r.counter(
            "paddle_tpu_disagg_colocated_fallback_total",
            "Disagg-routed requests degraded to a colocated "
            "re-prefill on the decode side (handoff ship/restore "
            "fault, receiving host tier full, or a dead engine "
            "mid-handoff) — token-exact, never a dropped request")
