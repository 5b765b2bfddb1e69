"""Deterministic fault-injection plane for the port's serving stack.

The port's own copy of ``paddle_tpu/testing/faults.py`` (stdlib only; the
port imports nothing of ``paddle_tpu``).  Production code consults *named
sites* at the points where a failure would surface; a test arms a rule on a
site and the consult raises.  The sites the port wires:

=====================  ==================================================
site                   consulted by
=====================  ==================================================
``step_dispatch``      ``ContinuousBatchingEngine`` once per decode
                       dispatch, before the step runs: ``_decode_sync``
                       before the eager step (before the pools are
                       reassigned), ``_launch`` (the overlap and horizon
                       lanes) before the ring slot, the state upload and
                       any graph capture or replay, ``_decode_mixed``
                       (the mixed tick) after its host stream assembly,
                       before the ring slot, the staging upload and the
                       call, and every speculative round
                       (``_decode_spec_sync`` before its uploads and call,
                       ``_dispatch_spec_async`` before the ring slot, the
                       state upload and any graph capture or replay)
``prefill_dispatch``   the admission lanes before each prefill dispatch
                       (packed, batched, and once per chunk on the
                       chunked lane): slots and pages are already
                       claimed, so this exercises the mid-admission
                       quarantine path
``stream_write``       the ``/generate_stream`` chunk writer: simulates a
                       client disconnect (``BrokenPipeError``) without a
                       real socket close
``swap_out``           ``PagedKVCache.swap_out_row`` before any change: a
                       ``RuntimeError`` degrades the preemption to
                       recompute
``swap_in``            ``PagedKVCache.swap_in_row`` before any change: a
                       ``RuntimeError`` drops the record and the request
                       resumes recompute-style; any other exception is a
                       wave fault (the quarantine discards the record)
``host_pool_full``     ``HostPagePool.alloc`` (an exception rule fails the
                       allocator) and ``PagedKVCache.host_available`` (a
                       condition rule reads 0: the cost model and the
                       swap-out precondition degrade to recompute)
``route_dispatch``     ``FleetRouter`` before handing a request to the
                       chosen replica: the router tries the next
                       candidate; with none left the submit raises
``replica_death``      the router's per-replica step, once per stepped
                       replica: an exception rule kills the replica
                       (DEAD; requests that streamed nothing fail over,
                       the others end with an error; ``auto_replace``
                       rebuilds it)
``replica_slow``       a condition rule at the same seam: while it
                       matches the replica skips its step and turns
                       DEGRADED (routing steers around it); READY again
                       once it stops matching
``kv_handoff``         the disaggregated prefill / decode hand-off, two
                       halves a hand-off: the ship half in
                       ``HandoffRecord.materialize`` (before the staging
                       flush and the host read) and the restore half in
                       ``DecodeEngine.admit_handoff`` (before the record
                       adopts into the receiving host tier).  Either
                       failure degrades the request to a colocated
                       re-prefill on the decode side (counted in
                       ``disagg_colocated_fallback_total``), never a
                       dropped request
``conn_drop``          the sockets transport's client connection
                       (``fleet/transport.py``), once a frame: an
                       exception rule resets the connection mid-call;
                       idempotent ops re-dial and retry with backoff,
                       others surface the ambiguity
``frame_truncate``     the same seam, a condition rule: the client sends
                       a cut frame and drops; the agent drops that
                       connection (its ``ProtocolError`` path) and keeps
                       serving, the client retries over a fresh dial
``net_delay``          the same seam, a condition rule: the frame leaves
                       ``NET_DELAY_S`` late, so a tighter RPC timeout
                       trips (a stalled link)
``agent_kill``         ``RemoteReplicaHandle``'s per-tick sync
                       (``fleet/remote.py``), a condition rule: the
                       handle SIGKILLs its agent process (or tears down
                       the in-thread agent) before the sync; the lease
                       expires and the router's death path takes over.
                       The plane is per process: a spawned agent arms
                       its own from ``fault_spec`` in its spawn config
=====================  ==================================================

Faults are deterministic: rules match by call index (``nth`` = exactly
the n-th consult, ``every`` = every K-th consult, the default = every
consult), disarm after ``times`` matches, and probabilistic rules
(``p=``) draw from a private ``random.Random(seed)``, so a seeded run
replays exactly; the same rules on JAX's plane and on this one match the
same consults.  No rule relies on wall-clock time.

The plane is off unless installed: a consulted site costs one ``is None``
check.  Tests use the context manager::

    from paddle_tpu_torch.testing import faults

    with faults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("injected"), nth=3)
        ...                     # the 3rd decode dispatch raises
    assert fp.counts["step_dispatch"] >= 3
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["FaultPlane", "FaultRule", "plane", "install", "uninstall",
           "get", "fire", "active"]


class FaultRule:
    """One armed fault: which consults it matches and what it does.

    ``exc``: exception instance or class to raise at :meth:`FaultPlane.
    fire` (``None`` = a pure condition flag, visible through
    :meth:`FaultPlane.active` — e.g. ``host_pool_full``).
    ``nth``: match exactly the n-th consult of the site (1-based).
    ``every``: match every K-th consult.
    ``p``/``seed``: match each consult with probability ``p`` drawn
    from a private deterministic stream.
    ``times``: disarm after this many matches (``None`` = unlimited).
    """

    def __init__(self, exc=None, nth: Optional[int] = None,
                 every: Optional[int] = None, times: Optional[int] = None,
                 p: Optional[float] = None, seed: int = 0):
        if nth is not None and nth < 1:
            raise ValueError("nth is 1-based")
        if every is not None and every < 1:
            raise ValueError("every must be >= 1")
        self.exc = exc
        self.nth = nth
        self.every = every
        self.p = p
        self.times = times
        self.matches = 0
        self._rng = random.Random(seed)

    def _matches_call(self, n: int) -> bool:
        """Does consult #``n`` (1-based, per site) trip this rule?"""
        if self.times is not None and self.matches >= self.times:
            return False
        if self.nth is not None and n != self.nth:
            return False
        if self.every is not None and n % self.every != 0:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        self.matches += 1
        return True

    def _make_exc(self):
        exc = self.exc
        return exc() if isinstance(exc, type) else exc


class FaultPlane:
    """A set of armed :class:`FaultRule` per site plus per-site consult
    counters.  Thread-safe: the serving stack consults from the engine
    thread and HTTP handler threads concurrently."""

    def __init__(self):
        self._rules: Dict[str, List[FaultRule]] = {}
        self.counts: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}       # site -> rules tripped
        self._lock = threading.Lock()

    def inject(self, site: str, exc=None, *, nth: Optional[int] = None,
               every: Optional[int] = None, times: Optional[int] = None,
               p: Optional[float] = None, seed: int = 0) -> FaultRule:
        """Arm a rule; returns it (its ``matches`` count is live)."""
        rule = FaultRule(exc, nth=nth, every=every, times=times, p=p,
                         seed=seed)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return rule

    def clear(self, site: Optional[str] = None) -> None:
        """Disarm ``site``'s rules (all sites when ``None``).  Consult
        counters survive — they are observability, not state."""
        with self._lock:
            if site is None:
                self._rules.clear()
            else:
                self._rules.pop(site, None)

    def _consult(self, site: str) -> Optional[FaultRule]:
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
            for rule in self._rules.get(site, ()):
                if rule._matches_call(n):
                    self.fired[site] = self.fired.get(site, 0) + 1
                    return rule
        return None

    def fire(self, site: str) -> None:
        """Count one consult of ``site``; raise if an armed
        exception-rule matches this call."""
        rule = self._consult(site)
        if rule is not None and rule.exc is not None:
            raise rule._make_exc()

    def active(self, site: str) -> bool:
        """Count one consult of ``site``; True when a condition rule
        matches this call (exception rules also read as active — a
        site may consult state-style)."""
        return self._consult(site) is not None


# -- process-wide installation (OFF by default: hot paths pay one
#    ``is None`` check per consulted site) --------------------------------
_PLANE: Optional[FaultPlane] = None


def install(p: Optional[FaultPlane] = None) -> FaultPlane:
    """Install ``p`` (or a fresh plane) process-wide and return it."""
    global _PLANE
    _PLANE = p if p is not None else FaultPlane()
    return _PLANE


def uninstall() -> None:
    global _PLANE
    _PLANE = None


def get() -> Optional[FaultPlane]:
    """The installed plane, or ``None`` when fault injection is off."""
    return _PLANE


@contextmanager
def plane():
    """``with faults.plane() as fp: fp.inject(...)`` — installs a fresh
    plane for the block and uninstalls it on exit (exception-safe, so a
    failing test never leaks armed faults into the next one)."""
    fp = install()
    try:
        yield fp
    finally:
        if _PLANE is fp:
            uninstall()


# -- the consult seams production code calls ------------------------------
def fire(site: str) -> None:
    """No-op unless a plane is installed; otherwise consult ``site``
    and raise if an exception rule matches."""
    if _PLANE is not None:
        _PLANE.fire(site)


def active(site: str) -> bool:
    """False unless a plane is installed; otherwise consult ``site``
    and report whether a rule matches this call."""
    return _PLANE is not None and _PLANE.active(site)
