"""Instrument bundle for the fleet router tier.

Counterpart of ``paddle_tpu/observability/fleet_metrics.py`` (the port's
own copy): one :class:`FleetMetrics` per
:class:`~paddle_tpu_torch.fleet.FleetRouter`, every counter and gauge of
the replica-routing layer under JAX's names, created against one registry
(normally the one the replica engines share, so ``GET /metrics`` on a
:class:`~paddle_tpu_torch.fleet.FleetServer` is the fleet's aggregate).

The registry is label-free, so a labelled series such as
``fleet_replicas{state="ready"}`` is one instrument per state or reason.
The per-state gauges are set from inside the router's step, under its
lock, rather than read by scrape-time callbacks: a callback would read the
replica table from the scrape thread outside that lock, the role gauges
included.
"""

from __future__ import annotations

from .events import EventRing
from .metrics import MetricsRegistry, default_registry

__all__ = ["FleetMetrics"]


class FleetMetrics:
    """All instruments the fleet router records into.

    ``registry=None`` uses the process-wide default registry; pass the
    registry the replica engines share for one aggregated ``/metrics``
    (:class:`~paddle_tpu_torch.fleet.FleetRouter` does so when its
    replicas carry metrics).
    """

    def __init__(self, registry: MetricsRegistry = None, ring=None):
        r = registry if registry is not None else default_registry()
        self.registry = r
        self.ring = ring if ring is not None else EventRing()

        # -- replica lifecycle (per-state flattening of
        #    fleet_replicas{state=...}) ---------------------------------
        self.replicas = r.gauge(
            "paddle_tpu_fleet_replicas_count",
            "Engine replicas the router owns (all states)")
        self.replicas_ready = r.gauge(
            "paddle_tpu_fleet_replicas_ready_count",
            "Replicas in state READY (admitting + decoding)")
        self.replicas_degraded = r.gauge(
            "paddle_tpu_fleet_replicas_degraded_count",
            "Replicas in state DEGRADED (serving but deprioritized "
            "by routing — e.g. stalled by a replica_slow fault)")
        self.replicas_draining = r.gauge(
            "paddle_tpu_fleet_replicas_draining_count",
            "Replicas in state DRAINING (finishing in-flight work, "
            "refusing new admissions; restart/replace follows)")
        self.replicas_dead = r.gauge(
            "paddle_tpu_fleet_replicas_dead_count",
            "Replicas in state DEAD (died and not yet replaced)")
        self.pending_failovers = r.gauge(
            "paddle_tpu_fleet_pending_failovers_count",
            "Accepted requests orphaned by a replica death, waiting "
            "for re-placement on a healthy replica")

        # -- engine roles (per-role flattening of
        #    fleet_replicas{role=...} — disaggregated serving lanes) ----
        self.role_prefill = r.gauge(
            "paddle_tpu_fleet_role_prefill_count",
            "Replicas serving the PREFILL lane of a disaggregated "
            "fleet (admission waves + KV handoff export, no decode)")
        self.role_decode = r.gauge(
            "paddle_tpu_fleet_role_decode_count",
            "Replicas serving the DECODE lane (adopt KV handoffs "
            "through the zero-prefill restore path + colocated "
            "short-prompt traffic)")
        self.role_unified = r.gauge(
            "paddle_tpu_fleet_role_unified_count",
            "Replicas serving both phases colocated (the pre-disagg "
            "default)")

        # -- routing decisions (per-reason flattening of
        #    fleet_routed_total{reason=...}) ----------------------------
        self.routed_prefix = r.counter(
            "paddle_tpu_fleet_routed_prefix_total",
            "Requests routed to the replica whose two-tier cache "
            "already holds their prompt prefix (prefix-affinity hit)")
        self.routed_least_loaded = r.counter(
            "paddle_tpu_fleet_routed_least_loaded_total",
            "Requests placed on the least-loaded READY replica (no "
            "prefix owner, or the owner was unavailable/full)")
        self.routed_failover = r.counter(
            "paddle_tpu_fleet_routed_failover_total",
            "Re-placements of requests orphaned by a replica death "
            "(the transparent resubmission path)")
        self.routed_disagg = r.counter(
            "paddle_tpu_fleet_routed_disagg_total",
            "Requests the bytes-vs-FLOPs cost model placed on a "
            "prefill-role replica (disaggregated admission; the KV "
            "handoff to a decode lane follows)")

        # -- degradation ------------------------------------------------
        self.failovers = r.counter(
            "paddle_tpu_fleet_failovers_total",
            "Requests orphaned by a replica death before their first "
            "streamed token and queued for transparent resubmission")
        self.rejected = r.counter(
            "paddle_tpu_fleet_rejected_total",
            "Submissions rejected at the ROUTER because every "
            "admitting replica's bounded queue refused (HTTP 429 "
            "with the aggregate Retry-After: min over READY replicas)")
        self.replica_deaths = r.counter(
            "paddle_tpu_fleet_replica_deaths_total",
            "Replica deaths observed by the router (escaped step "
            "exceptions, exhausted supervisor budgets, injected "
            "replica_death faults)")
        self.replica_replaces = r.counter(
            "paddle_tpu_fleet_replica_replaces_total",
            "Replicas rebuilt from their factory (auto-replace after "
            "death, or restart at the end of a drain)")
        self.replica_drains = r.counter(
            "paddle_tpu_fleet_replica_drains_total",
            "drain() calls: replicas taken out of rotation to finish "
            "in-flight work before a restart/replace")

        # -- QoS + autoscaling (SLO guardrails) -------------------------
        self.quota_rejected = r.counter(
            "paddle_tpu_fleet_quota_rejected_total",
            "Submissions rejected at the ROUTER because the tenant "
            "was over its token-rate quota (QuotaExceededError; "
            "never charged against any replica)")
        self.scale_up = r.counter(
            "paddle_tpu_fleet_scale_up_total",
            "Replicas ADDED to the fleet through "
            "FleetRouter.add_replica() (the autoscaler's grow verb)")
        self.scale_down = r.counter(
            "paddle_tpu_fleet_scale_down_total",
            "Replicas RETIRED from the fleet through "
            "FleetRouter.retire_replica() — drained first, then "
            "removed from rotation permanently (the autoscaler's "
            "shrink verb)")
        self.replicas_retired = r.gauge(
            "paddle_tpu_fleet_replicas_retired_count",
            "Replicas in terminal state RETIRED (scaled down; their "
            "slot in the replica table is kept for stable indexing "
            "but they own no engine)")
        self.autoscaler_desired = r.gauge(
            "paddle_tpu_fleet_autoscaler_desired_replicas_count",
            "The FleetAutoscaler's current desired replica count "
            "(bounded by min/max_replicas; 0 when no autoscaler is "
            "attached)")
