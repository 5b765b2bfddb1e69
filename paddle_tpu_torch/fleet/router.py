"""Replica router: lifecycle-managed fleet serving over N engines.

Counterpart of ``paddle_tpu/fleet/router.py`` for in-process replicas.  Each
replica is one
:class:`~paddle_tpu_torch.models.serving_engine.ContinuousBatchingEngine`
behind an :class:`~paddle_tpu_torch.models.serving_engine.EngineSupervisor`,
wrapped in a :class:`ReplicaHandle` with the fleet's state machine::

    STARTING -> READY <-> DEGRADED        (replica_slow stalls)
                  |  \\-> DRAINING -> (drained) -> replace -> READY
                  |                            \\-> RETIRED (scale-down)
                  \\--> DEAD -> (auto_replace) -> READY

Routing (``submit``): the replica that last served the prompt's full-page
prefix first (its prefix cache turns the prefill into a hit), else the
READY replica with the fewest requests (ties by queued tokens), DEGRADED
ones last.  A replica whose queue would refuse the request's class is
skipped, not surfaced: the router raises ``QueueFullError`` only when every
admitting replica refused, with the least ``retry_after`` of the READY
replicas.  Tenant quotas are charged once, here, before placement.

Failover (``step``): a replica death (an escaped step exception, a spent
restart budget, an injected ``replica_death`` fault) orphans its requests.
One that has streamed nothing is placed again under the same fleet rid and
deadline and completes with the same tokens (greedy decoding does not
depend on placement); one that has streamed ends with ``status ==
"error"``.  Dead replicas rebuild from their factory (``auto_replace``);
``drain`` restarts a replica once its work is done; ``add_replica`` and
``retire_replica`` grow and shrink the fleet.  A replaced or retired
replica's engine is dropped with its decode graphs, so its KV pool goes
back to the allocator.

Roles (``roles=``, one a factory; ``"unified"`` by default): a
``"prefill"`` replica (its factory builds a
:class:`~paddle_tpu_torch.models.disagg.PrefillEngine`) takes the requests
the bytes-against-FLOPs cost model sends through a hand-off; the router
takes its exported records and ships them, one tick later, through
``handoff_transport`` (by default in process:
``DecodeEngine.admit_handoff``) to the least-loaded ``"decode"`` replica (a
:class:`~paddle_tpu_torch.models.disagg.DecodeEngine`).  Short prompts
place on decode or unified replicas directly.  A failed ship or restore
(a ``kv_handoff`` fault, a full host tier) degrades the request to a
colocated re-prefill on a decode replica that keeps its first token; a
replica death mid-hand-off reclaims the records and fails the requests
over.

In-process replicas share one process and one card: a replica factory
should close over one weight set (no copy per replica) and build its own
``PagedKVCache``.  A :class:`~paddle_tpu_torch.fleet.remote.RemoteSpec` in
place of a factory puts the replica behind a socket (its own thread or OS
process, or an agent someone else runs), driven through a
:class:`~paddle_tpu_torch.fleet.remote.RemoteReplicaHandle` with the same
states, routing and failover; its hand-offs ship over the wire.  A replica
in its own process has its own CUDA context, so a sticky CUDA error there
is one replica's death, not the router's.

Thread safety: every public method takes ``_lock``; the replica engines
are touched only under it.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..models import graphed_step
from ..models.disagg import handoff_wins
from ..models.serving_engine import (PRIORITIES, EngineDeadError,
                                     EngineSupervisor, QueueFullError,
                                     QuotaExceededError, Request,
                                     TenantQuotas, _drive_to_completion,
                                     _release_engine_claims)
from ..observability import (DisaggMetrics, FleetMetrics, MetricsRegistry,
                             TransportMetrics, advance_phase,
                             finalize_request_trace, phase_clocks)
from ..testing import faults

__all__ = ["FleetRouter", "ReplicaHandle", "REPLICA_STATES"]

REPLICA_STATES = ("STARTING", "READY", "DEGRADED", "DRAINING", "DEAD",
                  "RETIRED")
ROLES = ("unified", "prefill", "decode")

def _check_role(h: "ReplicaHandle") -> None:
    """A prefill replica's engine exports hand-offs, a decode replica's
    adopts them: refuse a factory that built anything else."""
    eng = h.engine
    if h.role == "prefill" and not hasattr(eng, "take_handoffs"):
        raise ValueError(
            f"replica {h.idx} has role='prefill' but its factory built "
            f"{type(eng).__name__} — a prefill lane needs a "
            f"models.disagg.PrefillEngine (it exports KV handoff records "
            f"instead of decoding)")
    if h.role == "decode" and not hasattr(eng, "admit_handoff"):
        raise ValueError(
            f"replica {h.idx} has role='decode' but its factory built "
            f"{type(eng).__name__} — a decode lane needs a "
            f"models.disagg.DecodeEngine (it adopts KV handoffs through "
            f"the zero-prefill restore path)")


class ReplicaHandle:
    """One replica owned by the router: a supervisor-wrapped engine, its
    fleet state and the local -> fleet rid map.  Touched only under the
    router's lock."""

    remote = False      # RemoteReplicaHandle (fleet/remote.py): True
    # scale-down mark: the drain (or death) ends in RETIRED, not a replace
    retiring = False

    def __init__(self, idx: int, factory: Callable, *,
                 max_restarts: int = 3, window_s: float = 60.0,
                 backoff_s: float = 0.0, role: str = "unified"):
        self.idx = idx
        # the serving lane: "prefill" exports hand-offs, "decode" adopts
        # them, "unified" serves both phases
        self.role = role
        self._factory = factory
        self._sup_kw = dict(max_restarts=max_restarts,
                            window_s=window_s, backoff_s=backoff_s)
        self.state = "STARTING"
        self.error: Optional[str] = None
        self.deaths = 0
        self.replaces = 0
        self.drains = 0
        self.slow_ticks = 0
        # local engine rid -> fleet rid (a fresh engine starts a fresh rid
        # space, so replace clears it)
        self.local_rids: Dict[int, int] = {}
        # the snapshot row a RETIRED replica keeps after its engine went
        self._final_row: Optional[dict] = None
        self.supervisor: Optional[EngineSupervisor] = \
            EngineSupervisor(factory, **self._sup_kw)
        self.state = "READY"

    @property
    def engine(self):
        """The replica's engine; None once RETIRED (its pool given back)."""
        sup = self.supervisor
        return sup.engine if sup is not None else None

    def load(self):
        """Placement key: (requests on the replica, queued tokens)."""
        eng = self.supervisor.engine
        return (len(eng._active) + len(eng._queue), eng.queued_tokens())

    @property
    def admitting(self) -> bool:
        """READY admits; DEGRADED as a last resort (the router's candidate
        order); DRAINING, DEAD and RETIRED never."""
        return self.state in ("READY", "DEGRADED")

    def kill(self, error: str) -> None:
        """DEAD after an escaped failure: the engine's page and swap claims
        are released (the router triages its requests)."""
        self.state = "DEAD"
        self.error = error
        self.deaths += 1
        _release_engine_claims(self.supervisor.engine)
        self.local_rids.clear()

    def _drop(self) -> None:
        """Give back what the engine holds on the card, before another is
        built: its page and swap claims and the decode graphs keyed by its
        params and pools (with their private memory pools); the pool itself
        goes with the last reference, dropped here."""
        eng = self.supervisor.engine
        self.supervisor = None
        _release_engine_claims(eng)
        graphed_step.forget(eng.params, eng._pools())

    def replace(self) -> None:
        """Rebuild from the factory (after a death, or at the end of a
        drain): fresh supervisor, engine and local rid space."""
        self.state = "STARTING"
        self.local_rids.clear()
        self._drop()
        self.supervisor = EngineSupervisor(self._factory, **self._sup_kw)
        self.replaces += 1
        self.error = None
        self.state = "READY"

    def drain(self) -> None:
        """Out of rotation: the supervisor refuses submissions while
        ``step()`` finishes the work in flight; the router replaces (or
        retires) the replica once ``drained``."""
        self.supervisor.drain()
        self.state = "DRAINING"
        self.drains += 1

    @property
    def drained(self) -> bool:
        return self.state == "DRAINING" and self.supervisor.drained

    def row(self) -> dict:
        """This replica's row of the fleet snapshot."""
        if self.state == "RETIRED":
            return dict(self._final_row, state="RETIRED", retiring=False,
                        deaths=self.deaths, replaces=self.replaces,
                        drains=self.drains, slow_ticks=self.slow_ticks,
                        error=self.error)
        eng = self.supervisor.engine
        return {
            "idx": self.idx, "state": self.state, "role": self.role,
            "active": len(eng._active),
            "queued": len(eng._queue),
            "queued_tokens": eng.queued_tokens(),
            "occupancy": round(len(eng._active) / eng.B, 4),
            "decode_steps": eng.decode_steps,
            "tokens_generated": eng.tokens_generated,
            "requests_finished": eng.requests_finished,
            "prefix_hit_pages": eng.cache.prefix_hits,
            "retry_after_s": round(eng.retry_after_s(), 3),
            "restarts": self.supervisor.restarts,
            "deaths": self.deaths, "replaces": self.replaces,
            "drains": self.drains, "slow_ticks": self.slow_ticks,
            "retiring": self.retiring,
            "error": self.error}

    def retire(self) -> None:
        """Terminal scale-down: the engine and its pool and graphs go, the
        handle keeps its slot (fleet indices never shift) and its last
        snapshot row.  Never routed to, stepped or replaced again."""
        self._final_row = self.row()
        self.state = "RETIRED"
        self.retiring = False
        self._drop()
        self.local_rids.clear()


@dataclass
class _FleetRequest:
    """The router's record of one accepted request: where it lives, how
    much the client has seen (the failover test) and its deadline."""
    rid: int                          # fleet rid (the client's)
    prompt: np.ndarray
    max_new_tokens: int
    stop_sequences: Optional[list]
    deadline: float                   # absolute monotonic; 0.0 = none
    t_submit: float
    replica: int = -1                 # replica idx (-1 pending)
    local_rid: int = -1
    streamed: int = 0                 # tokens drained to the fleet stream
    failovers: int = 0
    # the router's cancel mark: the engine's dies with a dead replica, and
    # a cancelled request must never be revived by a failover
    cancelled: bool = False
    # the fleet trace (id = fleet rid) and the instant a death orphaned
    # the request (the failover_gap span's start; 0.0 = not orphaned)
    trace: Optional[object] = None
    t_orphan: float = 0.0
    # the speculative toggle, class and tenant ride every placement
    spec: Optional[bool] = None
    priority: str = "normal"
    tenant: Optional[str] = None


class FleetRouter:
    """In-process router over N engine replicas, driven like an engine
    (``submit`` / ``step`` / ``finished`` / ``drain_stream`` / ``cancel``)
    and speaking the same ``Request`` results, so ``GenerationServer``'s
    drive loop (and :class:`~paddle_tpu_torch.fleet.FleetServer`) works
    unchanged.

    ``factories``: one zero-argument engine factory per replica, or a
    :class:`~paddle_tpu_torch.fleet.remote.RemoteSpec` for a replica behind
    a socket (the agent's hello decides its role).  Engines
    built on one shared ``MetricsRegistry`` give an aggregated
    ``/metrics``; the router then publishes its fleet instruments to the
    same registry.  ``prefix_routing=False`` places by load alone;
    ``auto_replace=False`` leaves dead replicas down until :meth:`replace`.
    ``tenant_quotas`` meters tenants at the router (build the replica
    engines without quotas, or a request pays twice).  ``tracer`` gives
    every accepted request one trace under its fleet rid, continued across
    failovers and hand-offs.

    ``roles`` (one a factory) grows disaggregated lanes (the module
    docstring); ``handoff_gbps`` / ``handoff_chip_flops`` are the cost
    model's knobs, ``max_inflight_handoffs`` bounds the hand-offs in flight
    fleet-wide (past it, long prompts place colocated) and
    ``handoff_transport(record, decode_handle) -> local rid`` replaces the
    in-process ship."""

    def __init__(self, factories: Sequence[Callable], *,
                 prefix_routing: bool = True,
                 auto_replace: bool = True,
                 max_restarts: int = 3,
                 restart_window_s: float = 60.0,
                 restart_backoff_s: float = 0.0,
                 roles: Optional[Sequence[str]] = None,
                 handoff_transport: Optional[Callable] = None,
                 handoff_gbps: float = 10.0,
                 handoff_chip_flops: Optional[float] = None,
                 max_inflight_handoffs: int = 8,
                 tenant_quotas: Optional[TenantQuotas] = None,
                 metrics_registry=None, metrics_ring=None,
                 tracer=None):
        if not factories:
            raise ValueError("FleetRouter needs >= 1 replica factory")
        roles = ["unified"] * len(factories) if roles is None \
            else list(roles)
        if len(roles) != len(factories):
            raise ValueError(
                f"roles ({len(roles)}) must match factories "
                f"({len(factories)})")
        bad = [r for r in roles if r not in ROLES]
        if bad:
            raise ValueError(
                f"unknown replica role(s) {bad}: expected 'unified', "
                f"'prefill' or 'decode'")
        self._lock = threading.Lock()
        self.quotas = tenant_quotas
        # add_replica() builds with the same restart budget
        self._restart_kw = dict(max_restarts=max_restarts,
                                window_s=restart_window_s,
                                backoff_s=restart_backoff_s)
        self.tracer = tracer
        self.prefix_routing = bool(prefix_routing)
        self.auto_replace = bool(auto_replace)
        self._replicas: List[ReplicaHandle] = []
        try:
            for i, (f, role) in enumerate(zip(factories, roles)):
                self._replicas.append(self._new_handle(i, f, role))
            for h in self._replicas:
                _check_role(h)
        except BaseException:
            # a failed construction must not leak the agents (processes,
            # threads, ports) that the remote handles started
            self._kill_remote(self._replicas, "fleet construction failed")
            raise
        self._has_remote = any(h.remote for h in self._replicas)
        # a remote replica's role is the one its agent's hello gave
        self._has_prefill_lane = any(h.role == "prefill"
                                     for h in self._replicas)
        self.handoff_transport = handoff_transport \
            if handoff_transport is not None else self._transport_default
        self.handoff_gbps = float(handoff_gbps)
        self.handoff_chip_flops = handoff_chip_flops
        self.max_inflight_handoffs = int(max_inflight_handoffs)
        self._handoffs: deque = deque()   # (record, freq) awaiting ship
        self._page = int(self._replicas[0].engine.cache.page)
        self._requests: Dict[int, _FleetRequest] = {}
        self._pending: deque = deque()    # orphans awaiting re-placement
        self._stream: List = []           # (fleet rid, token)
        self._finished: List[Request] = []
        self._prefix_owner: Dict[int, int] = {}   # prefix hash -> idx
        self._prefix_cap = 4096
        self._next_rid = 0
        self._now = time.monotonic        # seam: tests pin the clock
        # plain counters, exact with metrics off
        self.routed = {"prefix": 0, "least_loaded": 0, "failover": 0,
                       "disagg": 0}
        # the cost model's verdicts on a fleet with a prefill lane
        self.disagg_decisions = {"disagg": 0, "colocated": 0}
        self.failovers = 0
        self.rejected = 0
        self.quota_rejected = 0
        self.deaths = 0
        self.replaces = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.route_errors = 0
        self.handoffs_shipped = 0
        self.handoff_pages = 0
        self.handoff_bytes = 0
        self.colocated_fallbacks = 0      # degraded hand-offs
        if metrics_registry is False:
            self.metrics = None
        else:
            if metrics_registry is None:
                # the replicas' registry when they have one: /metrics on
                # the fleet front is then the aggregate
                for h in self._replicas:
                    m = h.engine.metrics
                    if m is not None:
                        metrics_registry = m.registry
                        if metrics_ring is None:
                            metrics_ring = m.ring
                        break
            self.metrics = FleetMetrics(
                metrics_registry if metrics_registry is not None
                else MetricsRegistry(), ring=metrics_ring)
        # the hand-off instruments exist only with a prefill lane: a
        # unified fleet's exposition is unchanged
        self.disagg_metrics = None
        if self._has_prefill_lane and self.metrics is not None:
            self.disagg_metrics = DisaggMetrics(self.metrics.registry,
                                                ring=self.metrics.ring)
        # the transport instruments exist only with a remote replica: an
        # in-process fleet's exposition is unchanged
        self.transport_metrics = None
        if self._has_remote:
            self._wire_transport_metrics_locked()
        self._update_gauges_locked()

    def _new_handle(self, idx: int, factory, role: str):
        """A replica handle: remote for a ``RemoteSpec``, else in-process."""
        if getattr(factory, "is_remote_spec", False):
            from .remote import RemoteReplicaHandle
            return RemoteReplicaHandle(idx, factory, role=role)
        return ReplicaHandle(idx, factory, role=role, **self._restart_kw)

    @staticmethod
    def _kill_remote(handles, why: str) -> None:
        for h in handles:
            if h.remote:
                try:
                    h.kill(why)
                except Exception:
                    pass

    def _wire_transport_metrics_locked(self) -> None:
        """Give every remote replica's connection the transport
        instruments, built on the fleet's registry the first time."""
        if self.metrics is None:
            return
        if self.transport_metrics is None:
            self.transport_metrics = TransportMetrics(
                self.metrics.registry, ring=self.metrics.ring)
        for h in self._replicas:
            if h.remote:
                h.set_transport_metrics(self.transport_metrics)

    # -- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               stop_sequences=None,
               deadline_s: Optional[float] = None,
               spec: Optional[bool] = None,
               priority: str = "normal",
               tenant: Optional[str] = None) -> int:
        """Route and queue a request -> its fleet rid (stable across
        failovers).  ``ValueError`` for a request no replica could hold,
        ``QuotaExceededError`` when ``tenant`` is over its bucket, and
        ``QueueFullError`` only when every admitting replica refused
        ``priority`` (with the least ``retry_after`` of the READY
        replicas)."""
        with self._lock:
            return self._submit_locked(prompt, max_new_tokens,
                                       stop_sequences, deadline_s,
                                       spec, priority, tenant)

    def cancel(self, rid: int) -> bool:
        """Cancel a fleet request wherever it lives: on a replica (retired
        at that engine's next step) or pending a failover (retired now).
        False for an unknown or finished rid."""
        with self._lock:
            freq = self._requests.get(rid)
            if freq is None:
                return False
            # marked here too: the engine's mark dies with its replica
            freq.cancelled = True
            if freq.replica >= 0:
                ok = self._replicas[freq.replica].supervisor.cancel(
                    freq.local_rid)
                # a prefill-lane request may have been exported this tick
                # (record not yet taken): the mark reclaims it at the take
                return ok or self._replicas[freq.replica].role == "prefill"
            src = None
            for i, (rec, f) in enumerate(self._handoffs):
                if f is freq:
                    # mid-hand-off: reclaim the record now
                    del self._handoffs[i]
                    rec.discard()
                    src = rec.request
                    break
            self._pending = deque(q for q in self._pending
                                  if q is not freq)
            self._finish_synth_locked(freq, "cancelled", None, src=src)
            return True

    def finished(self) -> List[Request]:
        with self._lock:
            out, self._finished = self._finished, []
            return out

    def drain_stream(self) -> List:
        with self._lock:
            out, self._stream = self._stream, []
            return out

    def has_work(self) -> bool:
        with self._lock:
            return self._has_work_locked()

    def accepting(self) -> bool:
        """Readiness: some replica admits with queue capacity."""
        with self._lock:
            return self._accepting_locked()

    def fleet_snapshot(self) -> dict:
        """The ``/fleet`` document: each replica's state and load, and the
        routing and degradation counters."""
        with self._lock:
            return self._snapshot_locked()

    # -- lifecycle verbs --------------------------------------------------
    def drain(self, idx: int) -> None:
        """Drain replica ``idx``: out of rotation, its work finishes, then
        it rebuilds and is READY again."""
        with self._lock:
            h = self._replicas[idx]
            h.drain()
            if self.metrics is not None:
                self.metrics.replica_drains.inc()
                self.metrics.ring.emit("replica_drain", replica=idx)
            self._update_gauges_locked()

    def replace(self, idx: int) -> None:
        """Rebuild replica ``idx`` from its factory now."""
        with self._lock:
            h = self._replicas[idx]
            if h.state == "RETIRED":
                raise ValueError(
                    f"replica {idx} is RETIRED (scaled down); grow through "
                    f"add_replica() instead")
            self._replace_locked(h)

    def add_replica(self, factory: Callable, *,
                    role: str = "unified") -> int:
        """Grow the fleet by one replica of ``role`` built from ``factory``
        (an engine factory or a ``RemoteSpec``), routable from the next
        ``submit`` or ``step`` -> its index."""
        if role not in ROLES:
            raise ValueError(
                f"unknown replica role {role!r}: expected 'unified', "
                f"'prefill' or 'decode'")
        with self._lock:
            idx = len(self._replicas)
            h = self._new_handle(idx, factory, role)
            try:
                _check_role(h)
            except BaseException:
                self._kill_remote([h], "add_replica validation failed")
                raise
            self._replicas.append(h)
            if h.remote:
                self._has_remote = True
                self._wire_transport_metrics_locked()
            if h.role == "prefill":
                self._has_prefill_lane = True
                if self.metrics is not None and self.disagg_metrics is None:
                    self.disagg_metrics = DisaggMetrics(
                        self.metrics.registry, ring=self.metrics.ring)
            self.scale_ups += 1
            if self.metrics is not None:
                self.metrics.scale_up.inc()
                self.metrics.ring.emit("fleet_scale_up", replica=idx,
                                       role=role, remote=h.remote)
            self._update_gauges_locked()
            return idx

    def retire_replica(self, idx: int) -> None:
        """Shrink the fleet by one replica: it drains, then the next
        ``step()`` parks it RETIRED.  A no-op on a retiring or RETIRED
        replica; the last live replica cannot be retired."""
        with self._lock:
            h = self._replicas[idx]
            if h.state == "RETIRED" or h.retiring:
                return
            survivors = [r for r in self._replicas
                         if r.idx != idx and
                         r.state not in ("DEAD", "RETIRED") and
                         not r.retiring]
            if not survivors:
                raise ValueError(
                    f"cannot retire replica {idx}: it is the last live "
                    f"replica ({self._states_locked()})")
            h.retiring = True
            if h.state == "DEAD":
                # nothing to drain: the next step retires it
                self._update_gauges_locked()
                return
            if h.state != "DRAINING":
                h.drain()
                if self.metrics is not None:
                    self.metrics.replica_drains.inc()
                    self.metrics.ring.emit("replica_drain", replica=idx,
                                           retiring=True)
            self._update_gauges_locked()

    def _retire_locked(self, h: ReplicaHandle) -> None:
        """Complete a scale-down (caller holds ``_lock``)."""
        h.retire()
        self._prefix_owner = {k: v for k, v in self._prefix_owner.items()
                              if v != h.idx}
        self.scale_downs += 1
        if self.metrics is not None:
            self.metrics.scale_down.inc()
            self.metrics.ring.emit("fleet_scale_down", replica=h.idx)

    # -- engine-compatible drive loop -------------------------------------
    def step(self) -> int:
        """One fleet tick: replace dead or drained replicas, place the
        orphans again, step every serving replica (the ``replica_death``
        and ``replica_slow`` sites) and merge each one's stream and
        finished requests -> the active requests fleet-wide."""
        with self._lock:
            return self._step_locked()

    def run_to_completion(self, max_steps: int = 10_000):
        return _drive_to_completion(self, max_steps)

    # -- locked internals (caller holds _lock) ----------------------------
    def _submit_locked(self, prompt, max_new_tokens, stop_sequences,
                       deadline_s, spec=None, priority="normal",
                       tenant=None) -> int:
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}: expected one of "
                f"{PRIORITIES}")
        prompt = np.asarray(prompt, np.int64)
        now = self._now()
        if self.quotas is not None:
            # before any placement: an over-budget tenant costs no routing
            # and no replica counter, and its 429 carries the bucket's hint
            try:
                self.quotas.charge(tenant,
                                   len(prompt) + int(max_new_tokens),
                                   now=now)
            except QuotaExceededError:
                self.quota_rejected += 1
                if self.metrics is not None:
                    self.metrics.quota_rejected.inc()
                    self.metrics.ring.emit("fleet_quota_rejected",
                                           tenant=tenant)
                raise
        deadline = 0.0 if deadline_s is None else now + float(deadline_s)
        freq = _FleetRequest(self._next_rid, prompt, int(max_new_tokens),
                             stop_sequences, deadline, now, spec=spec,
                             priority=priority, tenant=tenant)
        if self.tracer is not None:
            # the router owns the trace: replicas report phase spans into
            # it, and it closes at the finished-merge under the fleet rid
            freq.trace = self.tracer.begin_trace(
                str(freq.rid), managed=True, prompt_len=len(prompt),
                max_new_tokens=int(max_new_tokens))
        # place before committing the rid: a rejected submit burns none
        try:
            if self._disagg_wins_locked(len(prompt), int(max_new_tokens)):
                try:
                    self._place_locked(freq, failover=False,
                                       lane="prefill")
                    self._count_disagg_placement_locked(True)
                except ValueError:
                    # malformed or oversized: every lane would refuse it
                    raise
                except Exception:
                    # the prefill lane is saturated, down or faulting:
                    # colocation beats shedding (the 429 belongs to the
                    # serve lane alone)
                    self._place_locked(freq, failover=False)
                    self._count_disagg_placement_locked(False)
            else:
                self._place_locked(freq, failover=False)
                if self._has_prefill_lane:
                    self._count_disagg_placement_locked(False)
        except BaseException:
            if freq.trace is not None:
                freq.trace.close(status="rejected",
                                 error="no replica accepted "
                                       "(validation or backpressure)")
            raise
        self._next_rid += 1
        self._requests[freq.rid] = freq
        return freq.rid

    def _disagg_wins_locked(self, prompt_len: int,
                            max_new_tokens: int = 0) -> bool:
        """The disaggregation verdict (pure; counted once a placement
        lands): the cost model prices the prefill stall a decode replica
        would pay against the hand-off's copies; short prompts, a full
        in-flight pipeline and a request the decode lane's pool could never
        hold (so ``submit()``'s ``ValueError`` refuses it up front) stay
        colocated."""
        if not self._has_prefill_lane:
            return False
        ref = next((h for h in self._replicas
                    if h.role != "prefill" and h.engine is not None), None)
        if ref is None:
            return False              # nowhere to decode: placement fails
        cache = ref.engine.cache
        row_cap = min(cache.pages_max, cache.num_pages - 1) * cache.page
        if prompt_len + max_new_tokens > row_cap:
            return False
        return self._inflight_handoffs_locked() \
            < self.max_inflight_handoffs and \
            handoff_wins(prompt_len, ref.engine, self.handoff_gbps,
                         self.handoff_chip_flops)

    def _count_disagg_placement_locked(self, disagg: bool) -> None:
        self.disagg_decisions["disagg" if disagg else "colocated"] += 1
        if self.disagg_metrics is not None:
            (self.disagg_metrics.routed_prefill if disagg
             else self.disagg_metrics.routed_colocated).inc()

    def _inflight_handoffs_locked(self) -> int:
        """Hand-offs anywhere in the fleet: exported and untaken on prefill
        replicas, pending at the router, adopted and not yet admitted on
        decode replicas."""
        n = len(self._handoffs)
        for h in self._replicas:
            if h.state in ("DEAD", "RETIRED"):
                continue
            if h.role == "prefill":
                n += len(h.engine._handoff_ready)
            elif h.role == "decode":
                n += h.engine.pending_handoffs()
        return n

    def _candidates_locked(self, freq: _FleetRequest, lane: str = "serve"):
        """Routing order within ``lane`` (``"serve"``: decode and unified
        replicas; ``"prefill"``: the disaggregated admission lane): the
        prefix owner first (READY only), then READY by load, then DEGRADED
        by load -> ``(candidates, prefix_hit_idx, prefix_key)``."""
        def in_lane(h):
            return (h.role == "prefill") == (lane == "prefill")

        ready = sorted((h for h in self._replicas
                        if h.state == "READY" and in_lane(h)),
                       key=lambda h: h.load())
        degraded = sorted((h for h in self._replicas
                           if h.state == "DEGRADED" and in_lane(h)),
                          key=lambda h: h.load())
        cands = ready + degraded
        prefix_hit = None
        key = self._prefix_key(freq.prompt) if self.prefix_routing \
            else None
        if key is not None:
            owner = self._prefix_owner.get(key)
            for h in cands:
                if h.idx == owner and h.state == "READY":
                    cands.remove(h)
                    cands.insert(0, h)
                    prefix_hit = h.idx
                    break
        return cands, prefix_hit, key

    def _place_locked(self, freq: _FleetRequest, failover: bool,
                      lane: str = "serve") -> None:
        """Hand ``freq`` to the best replica of ``lane`` that takes it;
        raises when none did (``QueueFullError`` with the least READY
        ``retry_after`` when every refusal was backpressure).  A failover
        always places on the serve lane: a re-prefill there is token-exact,
        a second hand-off would pay the copies again."""
        cands, prefix_hit, key = self._candidates_locked(freq, lane)
        if not cands:
            raise EngineDeadError(
                f"no replica available: {self._states_locked()}")
        now = self._now()
        deadline_s = None if freq.deadline == 0.0 \
            else max(freq.deadline - now, 1e-6)
        queue_full = False
        last_exc: Optional[BaseException] = None
        for h in cands:
            if h.engine.queue_capacity_reason(
                    len(freq.prompt), priority=freq.priority) is not None:
                # a side-effect-free, class-aware probe: a full replica is a
                # routing event, not a rejection on its engine's counters
                queue_full = True
                continue
            try:
                faults.fire("route_dispatch")
                extra = {}
                if h.remote:
                    # the wire's idempotency key: a submit retried after an
                    # ambiguous timeout dedups on the agent by fleet rid
                    extra["fleet_rid"] = freq.rid
                if freq.spec is not None:
                    # only an explicit toggle rides: replicas without a
                    # speculative lane take default traffic
                    extra["spec"] = freq.spec
                local = h.supervisor.submit(
                    freq.prompt, max_new_tokens=freq.max_new_tokens,
                    stop_sequences=freq.stop_sequences,
                    deadline_s=deadline_s, trace=freq.trace,
                    priority=freq.priority, tenant=freq.tenant, **extra)
            except ValueError:
                # malformed or oversized: every replica would refuse it
                raise
            except QueueFullError as e:
                queue_full = True
                last_exc = e
                continue
            except Exception as e:
                # a route_dispatch fault or a refusing replica: try the next
                self.route_errors += 1
                last_exc = e
                continue
            h.local_rids[local] = freq.rid
            freq.replica, freq.local_rid = h.idx, local
            reason = ("disagg" if lane == "prefill"
                      else "failover" if failover
                      else "prefix" if prefix_hit == h.idx
                      else "least_loaded")
            if freq.trace is not None:
                ctx = freq.trace
                if failover and freq.t_orphan:
                    # orphaned -> placed again, in the same trace as both
                    # replicas' spans (a hand-off that waited out decode-
                    # lane backpressure is no death's gap)
                    gap = ("failover_gap" if freq.failovers
                           else "pending_replacement")
                    ctx.span(gap, freq.t_orphan, time.monotonic(),
                             phase=gap, to_replica=h.idx)
                    freq.t_orphan = 0.0
                ctx.event("route", reason=reason, replica=h.idx)
                ctx.default_attrs["replica"] = h.idx
            self.routed[reason] += 1
            if key is not None:
                # this replica holds the prefix's pages now
                self._prefix_owner[key] = h.idx
                while len(self._prefix_owner) > self._prefix_cap:
                    self._prefix_owner.pop(next(iter(self._prefix_owner)))
            if self.metrics is not None:
                m = self.metrics
                {"prefix": m.routed_prefix,
                 "least_loaded": m.routed_least_loaded,
                 "failover": m.routed_failover,
                 "disagg": m.routed_disagg}[reason].inc()
            return
        if queue_full:
            # every admitting replica refused: the least hint of the READY
            # replicas (the soonest any capacity frees), finite on every
            # path, zero READY replicas included
            ready = [h for h in self._replicas if h.state == "READY"]
            hints = [h.engine.retry_after_s() for h in (ready or cands)]
            agg = min(hints) if hints else 1.0
            if not failover:
                # client-visible 429s only: a failover retry keeps the
                # orphan pending
                self.rejected += 1
                if self.metrics is not None:
                    self.metrics.rejected.inc()
                    self.metrics.ring.emit("fleet_rejected",
                                           replicas=len(cands),
                                           retry_after=agg)
            raise QueueFullError(
                f"fleet saturated: all {len(cands)} admitting replicas "
                f"rejected class {freq.priority!r}", retry_after=agg)
        raise last_exc if last_exc is not None else EngineDeadError(
            f"no replica accepted: {self._states_locked()}")

    def _step_locked(self) -> int:
        now = self._now()
        # 1. lifecycle: revive the dead, finish completed drains; a
        # retiring replica ends RETIRED instead of replaced
        for h in self._replicas:
            if h.state == "RETIRED":
                continue
            if h.state == "DEAD":
                if h.retiring:
                    self._retire_locked(h)
                elif self.auto_replace:
                    self._replace_locked(h)
            elif h.drained:
                if h.retiring:
                    self._retire_locked(h)
                else:
                    self._replace_locked(h)
        # 2. place the orphans again before stepping
        self._flush_pending_locked(now)
        # 2b. ship the hand-offs taken last tick (their staged copies rode
        # under the dispatches since)
        if self._handoffs:
            self._ship_handoffs_locked(now)
        # 3. step every serving replica, then merge its outputs
        active = 0
        for h in self._replicas:
            if h.state in ("DEAD", "RETIRED"):
                continue
            if faults.active("replica_slow"):
                # the replica stalls this tick; routing steers around it
                if h.state == "READY":
                    h.state = "DEGRADED"
                h.slow_ticks += 1
                continue
            if h.state == "DEGRADED":
                h.state = "READY"
            if not h.supervisor.has_work():
                continue
            try:
                faults.fire("replica_death")
                h.supervisor.step()
            except Exception as exc:
                self._on_death_locked(h, exc)
                continue
            if h.role == "prefill":
                # take the wave's records: popping the local rid hands the
                # request to the router and keeps the merges below off it
                # (its first token streams at the decode side's admission,
                # so it stays failover-eligible until then)
                for rec in h.engine.take_handoffs():
                    rid = h.local_rids.pop(rec.request.rid, None)
                    freq = None if rid is None \
                        else self._requests.get(rid)
                    if freq is None or freq.cancelled:
                        rec.discard()
                        if freq is not None:
                            self._finish_synth_locked(
                                freq, "cancelled", None, src=rec.request)
                        continue
                    freq.replica, freq.local_rid = -1, -1
                    self._handoffs.append((rec, freq))
            for local, tok in h.supervisor.drain_stream():
                rid = h.local_rids.get(local)
                if rid is None:
                    continue          # already triaged away
                freq = self._requests.get(rid)
                if freq is not None:
                    freq.streamed += 1
                self._stream.append((rid, tok))
            for req in h.supervisor.finished():
                rid = h.local_rids.pop(req.rid, None)
                if rid is None:
                    continue
                freq = self._requests.pop(rid, None)
                req.rid = rid         # the fleet rid
                if freq is not None:
                    # latency from the client's submission, not the last
                    # placement
                    req.t_submit = freq.t_submit
                    if freq.trace is not None:
                        if h.remote:
                            # the agent accrued the phase clocks without a
                            # tracer (only the trace id rode the wire): the
                            # spans are built here, on this clock
                            try:
                                freq.trace.report_request(
                                    req, replica=h.idx, remote=True)
                            except Exception:
                                pass
                        try:
                            freq.trace.close(
                                status=req.status, error=req.error,
                                tokens=len(req.generated),
                                failovers=freq.failovers,
                                clocks=phase_clocks(req))
                        except Exception:
                            pass
                self._finished.append(req)
            active += len(h.engine._active)
        # a drain that completed this tick ends now: an idle fleet is not
        # stepped again until new work arrives
        for h in self._replicas:
            if h.drained:
                if h.retiring:
                    self._retire_locked(h)
                else:
                    self._replace_locked(h)
        self._update_gauges_locked()
        return active

    def _on_death_locked(self, h: ReplicaHandle,
                         exc: BaseException) -> None:
        """Triage a replica death: orphans that streamed nothing fail over
        (same rid and deadline), the others end with an error; the replica
        is DEAD until replaced."""
        text = f"replica {h.idx} died: {type(exc).__name__}: {exc}"
        self.deaths += 1
        local_map = dict(h.local_rids)
        orphans = list(local_map.values())
        # the dead replica's phase intervals go into each orphan's trace
        # before the engine's structures are released
        self._harvest_dead_traces_locked(h, local_map)
        h.kill(text)
        n_failover = 0
        now = time.monotonic()
        for rid in orphans:
            freq = self._requests.get(rid)
            if freq is None:
                continue
            freq.replica, freq.local_rid = -1, -1
            if freq.cancelled:
                self._finish_synth_locked(freq, "cancelled", None)
            elif freq.streamed == 0:
                freq.failovers += 1
                freq.t_orphan = now
                self.failovers += 1
                n_failover += 1
                self._pending.append(freq)
            else:
                self._finish_synth_locked(freq, "error", text)
        if self.metrics is not None:
            m = self.metrics
            m.replica_deaths.inc()
            m.failovers.inc(n_failover)
            m.ring.emit("replica_death", replica=h.idx, error=text,
                        failovers=n_failover,
                        errored=len(orphans) - n_failover)

    def _harvest_dead_traces_locked(self, h: ReplicaHandle,
                                    local_map: Dict[int, int]) -> None:
        """Report the dead replica's accrued phase intervals into each
        orphan's fleet trace (tagged with the replica and ``died=True``).
        Best effort: tracing must not break a failover."""
        if self.tracer is None or h.remote:
            return                    # its requests live in the agent
        try:
            eng = h.supervisor.engine
            by_local = {r.rid: r for r in list(eng._queue)}
            by_local.update((r.rid, r) for r in list(eng._active.values()))
            by_local.update((r.rid, r) for r in list(eng._admitting))
            for ent in eng._mixed_pref.values():
                by_local[ent["req"].rid] = ent["req"]
            for rec in getattr(eng, "_handoff_ready", ()):
                by_local[rec.request.rid] = rec.request
            now = time.monotonic()
            for local, rid in local_map.items():
                freq = self._requests.get(rid)
                req = by_local.get(local)
                if freq is None or freq.trace is None or req is None:
                    continue
                if req.t_phase and req.phase != "done":
                    advance_phase(req, "done", now=now)
                freq.trace.report_request(req, replica=h.idx, died=True)
        except Exception:
            pass

    def _replace_locked(self, h: ReplicaHandle) -> None:
        h.replace()
        # the rebuilt cache is cold: its prefix keys stop steering traffic
        self._prefix_owner = {k: v for k, v in self._prefix_owner.items()
                              if v != h.idx}
        self.replaces += 1
        if self.metrics is not None:
            self.metrics.replica_replaces.inc()
            self.metrics.ring.emit("replica_replace", replica=h.idx)

    def _flush_pending_locked(self, now: float) -> None:
        """Place every orphan again.  Backpressure keeps it pending (an
        accepted request is never 429'd); a dead fleet with auto-replace
        waits for the revival; anything else ends it with an error."""
        keep: deque = deque()
        while self._pending:
            freq = self._pending.popleft()
            if freq.cancelled:
                self._finish_synth_locked(freq, "cancelled", None)
                continue
            if freq.deadline and now >= freq.deadline:
                self._finish_synth_locked(freq, "expired", None)
                continue
            try:
                self._place_locked(freq, failover=True)
            except QueueFullError:
                keep.append(freq)
            except EngineDeadError as e:
                if self.auto_replace:
                    keep.append(freq)
                else:
                    self._finish_synth_locked(freq, "error", str(e))
            except Exception as e:
                self._finish_synth_locked(
                    freq, "error",
                    f"failover placement failed: {type(e).__name__}: {e}")
        self._pending = keep

    # -- the KV hand-off (disaggregated lanes) ----------------------------
    def _transport_default(self, rec, h: ReplicaHandle) -> int:
        """The in-process hand-off transport: materialise on the source
        side, adopt into the destination's host tier (both halves of the
        ``kv_handoff`` fault site fire inside) -> the decode-side local rid.
        A remote decode replica's ``admit_handoff`` ships the record over the
        wire; a caller's ``handoff_transport`` replaces this seam, and the
        routing, failover and backpressure decisions above it stay as they
        are."""
        eng = h.engine
        if not hasattr(eng, "admit_handoff"):
            raise RuntimeError(
                f"replica {h.idx} (role {h.role!r}) cannot adopt a KV "
                f"handoff — ship targets need a DecodeEngine")
        rec.materialize()
        return eng.admit_handoff(rec)

    def _ship_handoffs_locked(self, now: float) -> None:
        """Ship every pending hand-off to the least-loaded READY decode
        replica.  Backpressure (every target's queue full) keeps the record
        pending; any other failure (a ``kv_handoff`` fault, a full host
        tier, no decode replica up) degrades the request to a colocated
        re-prefill: ``admit_degraded`` on a decode replica (keeping the
        first token), else a failover placement."""
        keep: deque = deque()
        while self._handoffs:
            rec, freq = self._handoffs.popleft()
            if freq.cancelled:
                rec.discard()
                self._finish_synth_locked(freq, "cancelled", None,
                                          src=rec.request)
                continue
            if freq.deadline and now >= freq.deadline:
                rec.discard()
                self._finish_synth_locked(freq, "expired", None,
                                          src=rec.request)
                continue
            targets = sorted((h for h in self._replicas
                              if h.role == "decode" and h.state == "READY"),
                             key=lambda h: h.load())
            t0 = time.perf_counter()
            shipped = queue_full = False
            for h in targets:
                try:
                    local = self.handoff_transport(rec, h)
                except QueueFullError:
                    queue_full = True
                    continue
                except Exception:
                    # a consumed fault or a full host tier poisons this
                    # record's ship: degrade rather than try the next target
                    # with a half-materialised record
                    queue_full = False
                    break
                h.local_rids[local] = freq.rid
                freq.replica, freq.local_rid = h.idx, local
                shipped = True
                dt = time.perf_counter() - t0
                if freq.trace is not None:
                    t1 = time.monotonic()
                    freq.trace.span("handoff_ship", t1 - dt, t1,
                                    pages=rec.pages, bytes=rec.nbytes,
                                    to_replica=h.idx)
                    freq.trace.default_attrs["replica"] = h.idx
                self.handoffs_shipped += 1
                self.handoff_pages += rec.pages
                self.handoff_bytes += rec.nbytes
                if self.disagg_metrics is not None:
                    m = self.disagg_metrics
                    m.handoff_pages.inc(rec.pages)
                    m.handoff_bytes.inc(rec.nbytes)
                    m.handoff_seconds.observe(dt)
                break
            if shipped:
                continue
            if queue_full:
                keep.append((rec, freq))       # retry next tick
                continue
            rec.discard()
            self.colocated_fallbacks += 1
            if freq.trace is not None:
                freq.trace.event("handoff_degraded")
            if self.disagg_metrics is not None:
                self.disagg_metrics.colocated_fallback.inc()
                self.disagg_metrics.ring.emit("kv_handoff_fallback",
                                              rid=freq.rid)
            placed = False
            for h in targets:
                try:
                    local = h.engine.admit_degraded(rec.request)
                except Exception:
                    continue
                h.local_rids[local] = freq.rid
                freq.replica, freq.local_rid = h.idx, local
                if freq.trace is not None:
                    freq.trace.default_attrs["replica"] = h.idx
                placed = True
                break
            if not placed:
                freq.t_orphan = time.monotonic()
                self._pending.append(freq)
        self._handoffs = keep

    def _finish_synth_locked(self, freq: _FleetRequest, status: str,
                             error: Optional[str],
                             src: Optional[Request] = None) -> None:
        """The terminal message of a request no engine owns any more (an
        orphan cancelled or expired while pending, a death mid-stream, a
        record triaged mid-hand-off): the client always gets a status.
        ``src``, the engine-side request a record carried, reports its
        phase intervals into the trace before the close."""
        self._requests.pop(freq.rid, None)
        req = Request(freq.rid, freq.prompt, freq.max_new_tokens,
                      stop_sequences=freq.stop_sequences,
                      t_submit=freq.t_submit)
        req.done = True
        req.status = status
        req.error = error
        req.t_finish = self._now()
        if freq.trace is not None:
            if src is not None:
                finalize_request_trace(freq.trace, src, status=status,
                                       error=error,
                                       failovers=freq.failovers)
            else:
                try:
                    freq.trace.close(status=status, error=error,
                                     failovers=freq.failovers)
                except Exception:
                    pass
        self._finished.append(req)

    def _has_work_locked(self) -> bool:
        # undelivered terminal messages count: a cancel() can make one
        # outside step() while the fleet is idle
        if self._pending or self._finished or self._handoffs:
            return True
        return any(h.state not in ("DEAD", "RETIRED")
                   and h.supervisor.has_work() for h in self._replicas)

    def _accepting_locked(self) -> bool:
        # a prefill replica never serves a request end to end: readiness
        # needs a decode or unified replica with room
        return any(h.admitting and h.role != "prefill" and
                   h.engine.queue_capacity_reason() is None
                   for h in self._replicas)

    def _states_locked(self) -> dict:
        out = {s: 0 for s in REPLICA_STATES}
        for h in self._replicas:
            out[h.state] += 1
        return out

    def _roles_locked(self) -> dict:
        out = {r: 0 for r in ROLES}
        for h in self._replicas:
            out[h.role] += 1
        return out

    def _snapshot_locked(self) -> dict:
        doc = {"replicas": [h.row() for h in self._replicas],
               "states": self._states_locked(),
               "roles": self._roles_locked(),
               "routed": dict(self.routed),
               "failovers": self.failovers,
               "rejected": self.rejected,
               "quota_rejected": self.quota_rejected,
               "deaths": self.deaths,
               "replaces": self.replaces,
               "scale_ups": self.scale_ups,
               "scale_downs": self.scale_downs,
               "route_errors": self.route_errors,
               "pending_failovers": len(self._pending),
               "requests_live": len(self._requests)}
        if self._has_prefill_lane:
            doc["disagg"] = {
                "decisions": dict(self.disagg_decisions),
                "handoffs_shipped": self.handoffs_shipped,
                "handoff_pages": self.handoff_pages,
                "handoff_bytes": self.handoff_bytes,
                "handoffs_inflight": self._inflight_handoffs_locked(),
                "colocated_fallbacks": self.colocated_fallbacks}
        if self._has_remote:
            # the wire counters summed over the remote replicas
            agg = {"reconnects": 0, "retries": 0, "heartbeat_misses": 0,
                   "frames": 0, "bytes": 0}
            for h in self._replicas:
                c = getattr(h, "conn", None)
                if not h.remote or c is None:
                    continue
                agg["reconnects"] += c.reconnects
                agg["retries"] += c.retries
                agg["heartbeat_misses"] += c.heartbeat_misses
                agg["frames"] += c.frames
                agg["bytes"] += c.bytes_sent + c.bytes_recv
            doc["transport"] = agg
        return doc

    def _update_gauges_locked(self) -> None:
        if self.metrics is None:
            return
        states = self._states_locked()
        m = self.metrics
        m.replicas.set(len(self._replicas))
        m.replicas_ready.set(states["READY"])
        m.replicas_degraded.set(states["DEGRADED"])
        m.replicas_draining.set(states["DRAINING"])
        m.replicas_dead.set(states["DEAD"])
        m.replicas_retired.set(states["RETIRED"])
        m.pending_failovers.set(len(self._pending))
        roles = self._roles_locked()
        m.role_prefill.set(roles["prefill"])
        m.role_decode.set(roles["decode"])
        m.role_unified.set(roles["unified"])
        if self.disagg_metrics is not None:
            self.disagg_metrics.handoff_inflight.set(
                self._inflight_handoffs_locked())

    def _prefix_key(self, prompt: np.ndarray) -> Optional[int]:
        """Affinity key: the prompt's full pages (what the prefix cache can
        reuse); a prompt shorter than a page has none."""
        full = (len(prompt) // self._page) * self._page
        if full == 0:
            return None
        return zlib.crc32(np.ascontiguousarray(prompt[:full]).tobytes())
