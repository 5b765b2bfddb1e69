"""Fleet autoscaler: a closed control loop over the router.

Counterpart of ``paddle_tpu/fleet/autoscaler.py``.
:class:`FleetAutoscaler` watches the fleet's queued tokens per live
replica (and optionally a TTFT p99 probe) against a band, grows the fleet
through :meth:`FleetRouter.add_replica` when it runs hot and shrinks it
through :meth:`FleetRouter.retire_replica` when it runs cold.

Stability is the design:

* **hysteresis**: separate high and low watermarks; the band between them
  takes no action;
* **streaks**: a decision needs ``up_consecutive`` / ``down_consecutive``
  agreeing ticks;
* **cooldown**: after any action the controller holds for ``cooldown_s``;
* **settle guard**: while the fleet is mid-transition (a STARTING or DEAD
  replica, a drain that is not a retirement, pending failovers) the tick
  is skipped and the streaks reset, so a replica dying mid-ramp is the
  router's ``auto_replace`` to fix (one replacement) and never also a
  scale-up.

Thread safety: ``tick()`` takes the autoscaler's own lock and touches the
router only through its public (router-locked) verbs.  Lock order:
autoscaler, then router; never call the autoscaler under the router's
lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Closed-loop replica-count controller for one routing role.

    ``router``: the :class:`~paddle_tpu_torch.fleet.FleetRouter` to
    scale.  ``factory``: what :meth:`FleetRouter.add_replica` builds on
    scale up, an engine factory or a
    :class:`~paddle_tpu_torch.fleet.remote.RemoteSpec`.
    ``min_replicas`` / ``max_replicas``: hard bounds on LIVE replicas
    of ``role`` (retired slots never count).
    ``high_queued_tokens`` / ``low_queued_tokens``: per-live-replica
    queued-token watermarks (the hysteresis band; low < high).
    ``ttft_p99_s``: optional zero-arg probe returning the current
    fleet TTFT p99 in seconds — when it exceeds ``ttft_slo_s`` the
    tick counts as hot even below the token watermark.
    ``up_consecutive`` / ``down_consecutive``: agreeing-tick streaks a
    decision needs (down defaults slower than up: adding capacity
    under SLO pressure is urgent, removing it never is).
    ``cooldown_s``: hold time after any scale action.

    Drive it explicitly: ``tick()`` once per fleet step, or from any
    periodic thread (it takes the autoscaler lock, then the router's).
    """

    def __init__(self, router, factory: Callable, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 high_queued_tokens: float = 256.0,
                 low_queued_tokens: float = 32.0,
                 ttft_p99_s: Optional[Callable[[], float]] = None,
                 ttft_slo_s: Optional[float] = None,
                 up_consecutive: int = 2,
                 down_consecutive: int = 4,
                 cooldown_s: float = 5.0,
                 role: str = "unified"):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 — an empty "
                             "fleet cannot serve")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if low_queued_tokens >= high_queued_tokens:
            raise ValueError(
                f"hysteresis band inverted: low_queued_tokens "
                f"{low_queued_tokens} >= high_queued_tokens "
                f"{high_queued_tokens}")
        self.router = router
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_queued_tokens = float(high_queued_tokens)
        self.low_queued_tokens = float(low_queued_tokens)
        self.ttft_p99_s = ttft_p99_s
        self.ttft_slo_s = ttft_slo_s
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.role = role
        self._lock = threading.Lock()
        self._now = time.monotonic       # seam: tests pin the clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale = -float("inf")
        # decision accounting (plain counters — exact with metrics off)
        self.scale_ups = 0
        self.scale_downs = 0
        self.ticks = 0
        self.skipped_settling = 0
        self.skipped_cooldown = 0
        self.desired = 0

    # -- the control loop -------------------------------------------------
    def tick(self) -> Optional[str]:
        """One controller evaluation.  Returns ``"up:<idx>"`` /
        ``"down:<idx>"`` when a scale action fired, else ``None``
        (dead band, streak still building, cooldown, settle guard, or
        at a bound)."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Optional[str]:
        """CONTRACT: caller holds the autoscaler lock (the router
        lock is taken INSIDE, through the router's public verbs)."""
        self.ticks += 1
        snap = self.router.fleet_snapshot()
        rows = [r for r in snap["replicas"] if r["role"] == self.role]
        live = [r for r in rows
                if r["state"] in ("READY", "DEGRADED")
                and not r["retiring"]]
        self.desired = len(live)
        self._publish_desired()
        # settle guard: a fleet mid-transition is not a signal.  A
        # replica dying mid-ramp shows up as DEAD (+ pending
        # failovers) for a tick and is auto-replaced by the router —
        # scaling on top of that replacement is how controllers
        # oscillate, so the streaks reset and the trend re-proves
        # itself on a settled fleet.
        settling = (
            snap["pending_failovers"] > 0
            or any(r["state"] in ("STARTING", "DEAD")
                   or (r["state"] == "DRAINING" and not r["retiring"])
                   for r in rows))
        if settling or not live:
            self.skipped_settling += 1
            self._up_streak = self._down_streak = 0
            return None
        qt = sum(r["queued_tokens"] for r in live) / len(live)
        ttft = None
        if self.ttft_p99_s is not None and self.ttft_slo_s is not None:
            try:
                ttft = float(self.ttft_p99_s())
            except Exception:
                ttft = None           # a broken probe must not scale
        hot = qt > self.high_queued_tokens or \
            (ttft is not None and ttft > self.ttft_slo_s)
        cold = qt < self.low_queued_tokens and \
            (ttft is None or ttft <= self.ttft_slo_s)
        if hot:
            self._up_streak += 1
            self._down_streak = 0
        elif cold:
            self._down_streak += 1
            self._up_streak = 0
        else:                          # dead band: no trend either way
            self._up_streak = self._down_streak = 0
            return None
        now = self._now()
        if now - self._last_scale < self.cooldown_s:
            self.skipped_cooldown += 1
            return None
        if hot and self._up_streak >= self.up_consecutive \
                and len(live) < self.max_replicas:
            idx = self.router.add_replica(self.factory,
                                          role=self.role)
            self.scale_ups += 1
            self.desired = len(live) + 1
            self._up_streak = 0
            self._last_scale = now
            self._publish_desired()
            return f"up:{idx}"
        if cold and self._down_streak >= self.down_consecutive \
                and len(live) > self.min_replicas:
            # retire the least-loaded live replica: its in-flight
            # work drains token-exact before the slot parks RETIRED
            victim = min(live, key=lambda r: (r["queued_tokens"],
                                              r["active"], -r["idx"]))
            self.router.retire_replica(victim["idx"])
            self.scale_downs += 1
            self.desired = len(live) - 1
            self._down_streak = 0
            self._last_scale = now
            self._publish_desired()
            return f"down:{victim['idx']}"
        return None

    def _publish_desired(self) -> None:
        m = getattr(self.router, "metrics", None)
        if m is not None:
            m.autoscaler_desired.set(float(self.desired))

    def snapshot(self) -> dict:
        """Controller state for dashboards/tests (no router calls —
        safe from any thread)."""
        with self._lock:
            return {"desired": self.desired,
                    "ticks": self.ticks,
                    "scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "skipped_settling": self.skipped_settling,
                    "skipped_cooldown": self.skipped_cooldown,
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak,
                    "min_replicas": self.min_replicas,
                    "max_replicas": self.max_replicas}
