"""paddle_tpu_torch.fleet: the replica router tier over N serving engines.

Counterpart of ``paddle_tpu/fleet`` for in-process replicas:

* :class:`FleetRouter` owns N :class:`ReplicaHandle` s (each an engine
  behind an ``EngineSupervisor``, with the states ``STARTING`` /
  ``READY`` / ``DEGRADED`` / ``DRAINING`` / ``DEAD`` / ``RETIRED``) and
  routes every request by prefix affinity, then load; it sheds only when
  the whole fleet refuses, charges tenant quotas once, and moves a request
  orphaned by a replica death before its first streamed token to a
  healthy replica under the same rid and deadline.
* :class:`FleetAutoscaler` grows and shrinks the fleet from its queued
  tokens (hysteresis, streaks, cooldown, a settle guard).
* :class:`FleetServer` is the HTTP front over the router: the
  ``/generate[_stream]`` protocol, the aggregated ``/metrics`` and a
  ``/fleet`` document.

Replicas take a role: ``"unified"`` (both phases), or ``"prefill"`` and
``"decode"`` (the disaggregated lanes: the router ships each prefill
replica's KV hand-off records to a decode replica through
``handoff_transport``, in process by default).  The fault plane's
``route_dispatch``, ``replica_death``, ``replica_slow`` and ``kv_handoff``
sites drive the degraded paths.  Replicas behind sockets and the sockets
transport are not ported yet (ROADMAP.md queue 1 item 8).
"""

from .autoscaler import FleetAutoscaler                # noqa: F401
from .router import (REPLICA_STATES, FleetRouter,      # noqa: F401
                     ReplicaHandle)
from .server import FleetServer                        # noqa: F401

__all__ = ["FleetRouter", "FleetAutoscaler", "ReplicaHandle",
           "FleetServer", "REPLICA_STATES"]
