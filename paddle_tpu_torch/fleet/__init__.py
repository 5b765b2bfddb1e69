"""paddle_tpu_torch.fleet: the replica router tier over N serving engines.

Counterpart of ``paddle_tpu/fleet``:

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
``handoff_transport``, in process by default).

With a :class:`RemoteSpec` in place of an engine factory, a replica lives
behind a TCP socket (its own thread, OS process or host):
:class:`ReplicaAgent` hosts one supervisor-wrapped engine and speaks the
frame protocol of :mod:`.transport` (JSON control headers, raw KV blobs;
JAX's frames byte for byte), and :class:`RemoteReplicaHandle` sits in the
router beside the in-process handles.  Liveness is a lease, RPCs retry with
backoff and seeded jitter, and submission is idempotent (keyed on the fleet
rid).  The fault plane's ``route_dispatch``, ``replica_death``,
``replica_slow`` and ``kv_handoff`` sites, and the transport's
``conn_drop``, ``frame_truncate``, ``net_delay`` and ``agent_kill``, drive
the degraded paths.
"""

from .autoscaler import FleetAutoscaler                # noqa: F401
from .router import (REPLICA_STATES, FleetRouter,      # noqa: F401
                     ReplicaHandle)
from .server import FleetServer                        # noqa: F401
from .remote import (RemoteReplicaHandle, RemoteSpec,  # noqa: F401
                     ReplicaAgent, spawn_agent_process)
from .transport import (Connection, LeaseExpiredError,  # noqa: F401
                        ProtocolError, TransportError,
                        open_connection)

__all__ = ["FleetRouter", "FleetAutoscaler", "ReplicaHandle",
           "FleetServer",
           "REPLICA_STATES", "RemoteSpec", "RemoteReplicaHandle",
           "ReplicaAgent", "spawn_agent_process", "Connection",
           "open_connection", "TransportError", "ProtocolError",
           "LeaseExpiredError"]
