"""HTTP front for the fleet: ``GenerationServer`` over a
:class:`~paddle_tpu_torch.fleet.router.FleetRouter`.

Counterpart of ``paddle_tpu/fleet/server.py``.  The router speaks the
engine's drive surface (``submit`` / ``step`` / ``finished`` /
``drain_stream`` / ``cancel``), so ``/generate``, ``/generate_stream``,
``/cancel``, the token fan-out, the 429 with ``Retry-After`` (the router's
fleet-wide hint), the 504s and the disconnect cancellation are the
server's own.  What is fleet-shaped:

* ``/fleet``: each replica's state and load and the routing counters
  (:meth:`FleetRouter.fleet_snapshot`);
* ``/health``: live and ready plus the same document;
* ``/health/ready``: true while any replica admits with queue capacity
  (a draining or dead replica takes only itself out of rotation);
* ``/metrics`` and ``/stats``: the registry the replicas and the router
  share, the fleet's aggregate.
"""

from __future__ import annotations

import json
import time
import urllib.parse

from ..inference.serving import GenerationServer, _GenHandler
from .router import FleetRouter

__all__ = ["FleetServer"]


class _FleetHandler(_GenHandler):
    server_version = "paddle_tpu_torch-fleetserving/0.1"

    def do_GET(self):
        srv: "FleetServer" = self.server.owner
        path = urllib.parse.urlsplit(self.path).path.rstrip("/")
        if path == "/fleet":
            self._reply(200, json.dumps(srv.fleet_state()).encode())
            return
        _GenHandler.do_GET(self)


class FleetServer(GenerationServer):
    """Continuous-batching serving over HTTP across N engine replicas: the
    :class:`FleetRouter` is the drive target, so concurrent requests route
    by prefix affinity and load, shed only when the whole fleet is
    saturated, and survive replica deaths by failover.

    >>> router = FleetRouter([factory] * 3)
    >>> srv = FleetServer(router)
    >>> port = srv.start()
    >>> # ... generate_http / generate_http_stream as usual ...
    >>> srv.stop()
    """

    handler_class = _FleetHandler

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0, poll_s: float = 0.002):
        super().__init__(engine=router, host=host, port=port,
                         poll_s=poll_s)
        # the last /fleet document and when it was built, served while the
        # drive thread holds the lock
        self._fleet_last = None

    @property
    def router(self) -> FleetRouter:
        return self._engine

    def fleet_state(self) -> dict:
        """The ``/fleet`` document, with ``/health``'s bounded wait: after
        ``_READY_PROBE_WAIT_S`` without the lock the last document is
        served with ``stale_s`` (the first scrape waits)."""
        if not self._lock.acquire(timeout=self._READY_PROBE_WAIT_S):
            last = self._fleet_last
            if last is not None:
                doc, built_t = last
                stale = dict(doc)
                stale["stale_s"] = round(time.monotonic() - built_t, 3)
                return stale
            self._lock.acquire()
        try:
            doc = self._engine.fleet_snapshot()
        finally:
            self._lock.release()
        self._fleet_last = (doc, time.monotonic())
        return doc

    def _is_ready_locked(self) -> bool:
        """Ready while any replica admits with capacity (caller holds the
        lock)."""
        if not self.is_live() or self._fatal is not None:
            return False
        return self._engine.accepting()

    def _health_locked(self):
        """The fleet ``/health`` document (caller holds the lock)."""
        return ({"status": "ok" if self._fatal is None else "failed",
                 "error": self._fatal,
                 "live": self.is_live(),
                 "ready": self._is_ready_locked(),
                 "fleet": self._engine.fleet_snapshot()}, None)
