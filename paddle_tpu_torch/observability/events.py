"""Bounded structured-event ring buffer + chrome-trace export.

Counterpart of ``paddle_tpu/observability/events.py`` (the port's own
copy).  The metrics registry answers "how much / how fast"; this ring
answers "what happened, in what order" — submissions, admissions,
preemptions, retirements — without unbounded growth (serving runs for
days; the ring keeps the last ``capacity`` events and drops the oldest).

Events are plain dicts (JSON lines on export).  Timestamps carry BOTH
clocks: ``ts`` is ``timeit.default_timer()`` (the monotonic clock the
per-request traces align to) and ``wall`` is ``time.time()`` (for humans
and cross-host correlation).  ``seq`` increments per event so a tailer
(tools/metrics_dump.py) can poll ``/events?since=<seq>`` without
duplicates.

``span()`` opens a ``torch.profiler.record_function`` range (the span
shows up in a live ``torch.profiler`` capture) and additionally emits a
ring event with the measured duration.

The JAX ring also merges the JAX profiler's buffered host spans into
:meth:`EventRing.chrome_events`; the port has no profiler package yet, so
there is nothing to merge and the chrome export holds the ring's events
alone.
"""

from __future__ import annotations

import json
import threading
import time
import timeit
from collections import deque
from typing import List, Optional

__all__ = ["EventRing", "default_ring"]

# record_function resolved ONCE at first use: re-running the import
# statement inside every span __enter__ would put an import-machinery
# round-trip on the hot span path (pinned by
# tests/test_torch_observability.py::test_ring_span_no_import_in_hot_path)
_RECORD_FUNCTION = None


def _record_function():
    global _RECORD_FUNCTION
    if _RECORD_FUNCTION is None:
        import torch.profiler
        _RECORD_FUNCTION = torch.profiler.record_function
    return _RECORD_FUNCTION


class _RingSpan:
    """Context manager: a ``record_function`` range + ring event on
    exit."""

    def __init__(self, ring: "EventRing", name: str, fields: dict):
        self._ring = ring
        self._name = name
        self._fields = fields
        self._rec = None
        self._t0 = 0.0

    def __enter__(self):
        self._rec = _record_function()(self._name)
        self._rec.__enter__()
        self._t0 = timeit.default_timer()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = timeit.default_timer() - self._t0
        if self._rec is not None:
            self._rec.__exit__(None, None, None)
        self._ring.emit(self._name, dur_s=dur, **self._fields)
        return False


class EventRing:
    """Thread-safe bounded ring of structured events."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0         # events pushed out of the ring

    def emit(self, name: str, **fields) -> dict:
        ev = {"name": name,
              "ts": timeit.default_timer(),
              "wall": time.time(),
              "tid": threading.get_ident()}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        return ev

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring — read from scrape threads
        (``/stats``) while the engine thread emits, so the counter
        lives behind the lock like the ring itself."""
        with self._lock:
            return self._dropped

    def span(self, name: str, **fields) -> _RingSpan:
        return _RingSpan(self, name, fields)

    def recent(self, n: Optional[int] = None,
               since: int = 0) -> List[dict]:
        """Last ``n`` events (all by default), optionally only those
        with ``seq > since`` (the tail-follow protocol)."""
        return self.recent_with_gap(n=n, since=since)[0]

    def recent_with_gap(self, n: Optional[int] = None,
                        since: int = 0):
        """``(events, gap)``: the tail-follow batch plus the number
        of events that fell off the ring BETWEEN ``since`` and the
        oldest retained event.  Without the gap figure a follower
        polling ``/events?since=`` across a ring wrap silently skips
        the lost events and reads a burst as a quiet stream — the
        ``dropped`` delta makes the loss visible
        (tools/metrics_dump.py prints a ``[gap: N events lost]``
        marker)."""
        with self._lock:
            evs = list(self._events)
            seq = self._seq
        gap = 0
        if since:
            # seq of the oldest event still in the ring; an empty
            # ring means everything up to seq is gone
            oldest = evs[0]["seq"] if evs else seq + 1
            if since + 1 < oldest:
                gap = oldest - since - 1
            evs = [e for e in evs if e["seq"] > since]
        if n is not None:
            evs = evs[-n:] if n > 0 else []   # n=0 is "none", not all
        return evs, gap

    def drain(self) -> List[dict]:
        with self._lock:
            evs = list(self._events)
            self._events.clear()
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_jsonl(self, n: Optional[int] = None) -> str:
        return "\n".join(json.dumps(e) for e in self.recent(n))

    def chrome_events(self) -> List[dict]:
        """The ring as chrome trace-event dicts — the building block
        :meth:`export_chrome_trace` writes out and the per-trace
        Perfetto export (observability/tracing.py) merges onto.  JAX's
        form also merges its profiler's buffered host spans (its
        ``include_profiler_spans``); the port has no profiler package
        yet, so there is nothing to merge and no such argument."""
        import os
        pid = os.getpid()
        trace_events = []
        for ev in self.recent():
            args = {k: v for k, v in ev.items()
                    if k not in ("name", "ts", "tid", "wall", "seq",
                                 "dur_s")
                    and isinstance(v, (str, int, float, bool,
                                       type(None)))}
            if "dur_s" in ev:
                trace_events.append({
                    "name": ev["name"], "ph": "X", "cat": "event",
                    "ts": (ev["ts"] - ev["dur_s"]) * 1e6,
                    "dur": ev["dur_s"] * 1e6,
                    "pid": pid, "tid": ev["tid"], "args": args})
            else:
                trace_events.append({
                    "name": ev["name"], "ph": "i", "cat": "event",
                    "ts": ev["ts"] * 1e6, "s": "t",
                    "pid": pid, "tid": ev["tid"], "args": args})
        return trace_events

    def export_chrome_trace(self, path: str) -> str:
        """Write a chrome trace: ring events as instants (spans when
        they carry ``dur_s``) on one timeline (open in Perfetto /
        chrome://tracing)."""
        trace = {"traceEvents":
                 self.chrome_events(),
                 "displayTimeUnit": "ms"}
        import os.path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return path


_default_ring = EventRing()


def default_ring() -> EventRing:
    """The process-wide ring servers and a bench emit into."""
    return _default_ring
