"""End-to-end per-request tracing with tail sampling.

Counterpart of ``paddle_tpu/observability/tracing.py`` (the port's own
copy, the same documents and the same retention).  The metrics registry
answers "how much / how fast" in aggregate and the event ring answers
"what happened, in what order" process-wide; neither can answer the
question a TTFT-p99 investigation actually asks: *where did THIS
request's time go*.  This module is the request-scoped layer:

* :class:`TraceContext` — the propagated handle one request carries
  across every boundary it crosses (HTTP ingress → engine → stream
  completion).  It rides on the ``Request`` object itself, so the trace
  id — the rid — stays with the request.
* :class:`Tracer` — thread-safe registry of LIVE traces.  Spans carry
  a parent id, BOTH clocks (``time.monotonic`` for durations,
  wall-clock anchored at trace start for humans) and structured
  attributes.
* :class:`TraceStore` — bounded retention with TAIL-BASED sampling:
  error / cancelled / expired / faulted traces and anything slower than
  ``keep_slower_than_ms`` are ALWAYS kept; the fast-and-boring majority
  is deterministically sampled (1 in ``sample_every``).  Exposed over
  HTTP as ``GET /trace/<rid>`` and ``GET /traces`` (docs/OBSERVABILITY.md,
  "Tracing").

Hot-path discipline: decode steps are NOT spans — that would melt the
steady-state overlap pipeline.  Engines accrue per-request PHASE
CLOCKS (:func:`advance_phase`) only at the scheduler mutation points
that already flush the pipeline (admission, preemption, retirement),
and the closed intervals materialize as synthetic spans once, at
retirement (:meth:`TraceContext.report_request`).  No kernel launch and
no added host sync.

Everything here is stdlib-only and JSON-ready (spans are plain
dicts).
"""

from __future__ import annotations

import threading
import time
import timeit
from typing import Dict, List, Optional

__all__ = ["PHASES", "TraceContext", "Tracer", "TraceStore",
           "advance_phase", "phase_clocks", "finalize_request_trace",
           "chrome_trace_for", "default_tracer"]

# the per-request lifecycle phases the serving stack accrues (the
# span-accounting contract: for a served request the closed intervals
# chain gaplessly from submit to finish, so their durations sum to
# the request's wall time — pinned by tests/test_tracing.py)
PHASES = ("queued", "prefill", "decode_active", "preempted",
          "swapped", "handoff_inflight", "failover_gap", "stream")


def advance_phase(req, phase: str, now: Optional[float] = None) -> None:
    """Close the request's open lifecycle-phase interval and open
    ``phase``: appends one ``(phase, t0, t1)`` tuple to
    ``req.phase_log``.  O(1) host work, called only at scheduler
    mutation points (admission, preemption, retirement) —
    NEVER per decode token, so steady-state overlap keeps its
    zero-added-host-syncs discipline."""
    if now is None:
        now = time.monotonic()
    if req.t_phase:
        req.phase_log.append((req.phase, req.t_phase, now))
    req.phase = phase
    req.t_phase = now


def phase_clocks(req) -> Dict[str, float]:
    """Seconds accrued per phase over the request's closed intervals
    (the span-accounted latency breakdown; for a finalized request
    these sum to ``t_finish - t_submit`` within float error)."""
    out: Dict[str, float] = {}
    for phase, t0, t1 in req.phase_log:
        out[phase] = out.get(phase, 0.0) + max(t1 - t0, 0.0)
    return out


def finalize_request_trace(ctx: "TraceContext", req, close: bool = True,
                           status: Optional[str] = None,
                           error: Optional[str] = None,
                           **extra) -> None:
    """The ONE close-out sequence every trace owner uses: close the
    request's open phase interval at its finish instant, materialize
    the intervals as spans, and — when ``close`` — seal the trace
    with the phase-clock summary.  The one close-out path, so every
    owner's close semantics stay the same.  Never raises: tracing must
    not be able to break retirement."""
    try:
        if req.t_phase and req.phase != "done":
            advance_phase(req, "done",
                          now=req.t_finish if req.t_finish else None)
        ctx.report_request(req)
        if close:
            ctx.close(
                status=req.status if status is None else status,
                error=req.error if error is None else error,
                clocks=phase_clocks(req), **extra)
    except Exception:
        pass


def _copy_doc(doc: dict) -> dict:
    """JSON-safe copy of a trace document (private ``_``-keys
    stripped, spans AND their attrs detached from the live object —
    a reader serializing the copy must never race ``_seal``'s
    root-attr update or a late span's attrs)."""
    out = {k: v for k, v in doc.items() if not k.startswith("_")}
    out["attrs"] = dict(doc["attrs"])
    out["spans"] = [dict(s, attrs=dict(s.get("attrs") or {}))
                    for s in doc["spans"]]
    return out


def _summary(doc: dict, status: Optional[str] = None) -> dict:
    return {"trace_id": doc["trace_id"],
            "status": status if status is not None else doc["status"],
            "duration_ms": doc["duration_ms"],
            "spans": len(doc["spans"]),
            "wall0": doc["wall0"],
            "attrs": dict(doc["attrs"])}


def chrome_trace_for(doc: dict, ring=None) -> dict:
    """One trace as a Perfetto/chrome-tracing document, optionally
    MERGED with the event ring's timeline — request phases and engine
    events side by side.  Span timestamps are
    ``time.monotonic``; the ring runs on ``timeit.default_timer`` —
    both are CLOCK_MONOTONIC on the platforms we run, so a one-shot
    offset sample aligns them to well under a millisecond."""
    import os
    off = timeit.default_timer() - time.monotonic()
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = []
    for span in doc["spans"]:
        attrs = dict(span.get("attrs") or {})
        # one track per replica / engine segment, "request" otherwise
        track = attrs.get("replica", attrs.get("engine", "request"))
        tid = tids.setdefault(str(track), len(tids))
        events.append({
            "name": span["name"], "ph": "X", "cat": "trace",
            "ts": (span["t0"] + off) * 1e6,
            "dur": max(float(span.get("dur_s") or 0.0), 0.0) * 1e6,
            "pid": pid, "tid": tid,
            "args": dict(attrs, span_id=span["id"],
                         parent=span["parent"],
                         trace_id=doc["trace_id"])})
    if ring is not None:
        events.extend(ring.chrome_events())
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class TraceContext:
    """The propagated half of a trace: carried on ``Request`` objects.
    All methods delegate to the owning :class:`Tracer` (internally
    locked); the context itself holds no shared mutable state beyond
    ``default_attrs``, which only the component that owns the request
    at that moment writes.

    ``managed=True`` means a component above the engine owns the
    trace's lifecycle — engines report spans but never close it."""

    __slots__ = ("tracer", "trace_id", "managed", "default_attrs")

    def __init__(self, tracer: "Tracer", trace_id: str,
                 managed: bool = False):
        self.tracer = tracer
        self.trace_id = trace_id
        self.managed = bool(managed)
        # merged into every span this context reports (an owner may
        # stamp e.g. {"engine": name} so engine-side phase spans land
        # on their own track)
        self.default_attrs: Dict[str, object] = {}

    def span(self, name: str, t0: float, t1: float,
             parent: Optional[int] = None, **attrs) -> Optional[int]:
        a = dict(self.default_attrs)
        a.update(attrs)
        return self.tracer.add_span(self.trace_id, name, t0, t1,
                                    parent=parent, attrs=a)

    def event(self, name: str, **attrs) -> Optional[int]:
        """Zero-duration span at now (admission-lane markers,
        preemptions)."""
        now = time.monotonic()
        return self.span(name, now, now, **attrs)

    def report_request(self, req, **attrs) -> None:
        """Materialize the request's closed phase intervals as
        synthetic spans — called ONCE, at retirement, never per decode
        step."""
        for phase, t0, t1 in req.phase_log:
            self.span(phase, t0, t1, phase=phase, **attrs)

    def close(self, status: str = "ok", error: Optional[str] = None,
              **attrs) -> bool:
        return self.tracer.finish_trace(self.trace_id, status=status,
                                        error=error, **attrs)


class Tracer:
    """Thread-safe registry of live traces.  ``begin_trace`` mints a
    :class:`TraceContext`; ``finish_trace`` seals the document and
    offers it to the :class:`TraceStore`'s tail-sampling retention.
    ``max_live`` bounds the in-flight table: a trace whose request
    never retires (a lost waiter) is evicted as ``status=
    "abandoned"`` instead of pinning host memory forever."""

    def __init__(self, store: Optional["TraceStore"] = None,
                 max_live: int = 2048):
        self._lock = threading.Lock()
        self._live: Dict[str, dict] = {}
        self.store = store if store is not None else TraceStore()
        self.max_live = int(max_live)

    def begin_trace(self, trace_id, managed: bool = False,
                    **attrs) -> TraceContext:
        now = time.monotonic()
        wall = time.time()
        evicted = None
        with self._lock:
            tid = str(trace_id)
            if tid in self._live:
                # distinct engines sharing one tracer can collide on
                # their local rid spaces — disambiguate, never clobber
                n = 1
                while f"{tid}#{n}" in self._live:
                    n += 1
                tid = f"{tid}#{n}"
            doc = {"trace_id": tid, "status": "live", "error": None,
                   "t0": now, "wall0": wall, "duration_ms": None,
                   "attrs": dict(attrs),
                   "spans": [{"id": 0, "parent": None,
                              "name": "request", "t0": now,
                              "dur_s": 0.0, "attrs": {}}],
                   "_next": 1}
            self._live[tid] = doc
            if len(self._live) > self.max_live:
                evicted = self._live.pop(next(iter(self._live)))
        if evicted is not None:
            _seal(evicted, "abandoned", "trace never finished "
                  "(live-table bound)", time.monotonic())
            self.store.offer(evicted)
        return TraceContext(self, tid, managed=managed)

    def add_span(self, trace_id, name: str, t0: float, t1: float,
                 parent: Optional[int] = None,
                 attrs: Optional[dict] = None) -> Optional[int]:
        span = {"parent": 0 if parent is None else int(parent),
                "name": str(name), "t0": float(t0),
                "dur_s": max(float(t1) - float(t0), 0.0),
                "attrs": dict(attrs or {})}
        with self._lock:
            doc = self._live.get(str(trace_id))
            if doc is not None:
                span["id"] = doc["_next"]
                doc["_next"] += 1
                doc["spans"].append(span)
                return span["id"]
        # late span on an already-finished trace (the serving front's
        # terminal-delivery "stream" span): lands iff retention kept it
        return self.store.late_span(str(trace_id), span)

    def annotate(self, trace_id, **attrs) -> None:
        with self._lock:
            doc = self._live.get(str(trace_id))
            if doc is not None:
                doc["attrs"].update(attrs)

    def finish_trace(self, trace_id, status: str = "ok",
                     error: Optional[str] = None, **attrs) -> bool:
        """Seal + offer to the store; returns whether tail retention
        kept the trace.  False (and a no-op) for unknown/already-
        finished ids — closing twice is harmless."""
        with self._lock:
            doc = self._live.pop(str(trace_id), None)
        if doc is None:
            return False
        _seal(doc, status, error, time.monotonic(), attrs)
        return self.store.offer(doc)

    def get(self, trace_id) -> Optional[dict]:
        """Full span-tree document, live (tagged ``in_flight``) or
        retained."""
        with self._lock:
            doc = self._live.get(str(trace_id))
            if doc is not None:
                out = _copy_doc(doc)
                out["in_flight"] = True
                return out
        return self.store.get(trace_id)

    def index(self, min_ms: float = 0.0,
              status: Optional[str] = None,
              limit: int = 50) -> List[dict]:
        """Summaries, newest first: live traces (``status="live"``)
        then the store's retained tail."""
        out: List[dict] = []
        if status in (None, "live"):
            now = time.monotonic()
            with self._lock:
                live = [dict(_summary(d, status="live"),
                             duration_ms=round((now - d["t0"]) * 1e3,
                                               3))
                        for d in self._live.values()]
            out.extend(s for s in reversed(live)
                       if s["duration_ms"] >= min_ms)
        if status != "live":
            out.extend(self.store.index(min_ms=min_ms, status=status,
                                        limit=limit))
        return out[:max(int(limit), 0)]

    def export_chrome_trace(self, trace_id, ring=None,
                            path: Optional[str] = None
                            ) -> Optional[dict]:
        return _export_chrome(self.get(trace_id), ring, path)


def _export_chrome(doc: Optional[dict], ring,
                   path: Optional[str]) -> Optional[dict]:
    """Shared tail of Tracer/TraceStore.export_chrome_trace: build
    the merged document and optionally write it."""
    if doc is None:
        return None
    trace = chrome_trace_for(doc, ring=ring)
    if path is not None:
        import json
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def _seal(doc: dict, status: str, error: Optional[str], now: float,
          attrs: Optional[dict] = None) -> None:
    doc["status"] = str(status)
    doc["error"] = error
    if attrs:
        doc["attrs"].update(attrs)
    doc["duration_ms"] = round((now - doc["t0"]) * 1e3, 3)
    root = doc["spans"][0]
    root["dur_s"] = max(now - doc["t0"], 0.0)
    root["attrs"]["status"] = doc["status"]


class TraceStore:
    """Bounded trace retention with TAIL-BASED sampling.

    A finished trace is ALWAYS kept when its status is abnormal
    (anything but ``"ok"`` — error/cancelled/expired/faulted/
    abandoned), when its attrs carry ``failovers > 0`` or
    ``force_keep``, or when it ran longer than
    ``keep_slower_than_ms``; the fast-and-ok majority keeps exactly 1
    in ``sample_every`` (deterministic counter, not RNG — tests and
    repro runs see the same retention).  ``capacity`` bounds the
    store FIFO (oldest retained trace evicts first), so serving for
    days cannot grow host memory.

    ``metrics_registry`` (or a later :meth:`bind_metrics`) publishes
    ``paddle_tpu_trace_{retained,sampled_out}_total`` and the
    ``paddle_tpu_trace_store_traces_count`` gauge — the gauge is SET
    after each offer under no lock (Gauge is internally locked), so a
    scrape never runs a closure over the store."""

    def __init__(self, capacity: int = 256,
                 keep_slower_than_ms: float = 500.0,
                 sample_every: int = 10,
                 metrics_registry=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        self._traces: Dict[str, dict] = {}      # insertion-ordered
        self.capacity = int(capacity)
        self.keep_slower_than_ms = float(keep_slower_than_ms)
        self.sample_every = max(int(sample_every), 1)
        self._n_ok = 0                # fast-ok traces seen (sampling)
        self.retained = 0
        self.sampled_out = 0
        self.evicted = 0
        self.m_retained = self.m_sampled = self.m_count = None
        if metrics_registry is not None:
            self.bind_metrics(metrics_registry)

    def bind_metrics(self, registry) -> None:
        """Publish the store's counters/gauge to ``registry``
        (documented in docs/OBSERVABILITY.md; naming lint covers
        them)."""
        self.m_retained = registry.counter(
            "paddle_tpu_trace_retained_total",
            "Finished traces kept by tail-based retention (abnormal "
            "status, failed-over, or slower than the latency "
            "threshold always kept; fast-ok sampled 1 in N)")
        self.m_sampled = registry.counter(
            "paddle_tpu_trace_sampled_out_total",
            "Fast, ok-status traces dropped by the deterministic "
            "sampler")
        self.m_count = registry.gauge(
            "paddle_tpu_trace_store_traces_count",
            "Traces currently retained in the bounded store")

    # -- retention --------------------------------------------------------
    def offer(self, doc: dict) -> bool:
        """Apply tail retention to a sealed trace document.
        ``"rejected"`` (backpressure-refused submits) rides the
        fast-ok sampler rather than the always-keep rule: a
        saturated server produces hundreds of span-less rejected
        traces per second, and letting them flood the FIFO would
        evict the error/slow traces an incident investigation
        actually needs (rejections are already counters)."""
        with self._lock:
            keep = (doc.get("status") not in ("ok", "rejected")
                    or (doc.get("duration_ms") or 0.0)
                    >= self.keep_slower_than_ms
                    or (doc.get("attrs") or {}).get("failovers", 0)
                    or (doc.get("attrs") or {}).get("force_keep"))
            if not keep:
                keep = self._n_ok % self.sample_every == 0
                self._n_ok += 1
            if keep:
                tid = doc["trace_id"]
                if tid in self._traces:
                    # id reuse (multiple fronts sharing one store, or
                    # a rid re-minted after a rejection): re-key the
                    # OLDER retained trace instead of overwriting it
                    # — /trace/<rid> serves the newest, the older
                    # stays reachable via the index
                    n = 1
                    while f"{tid}#{n}" in self._traces:
                        n += 1
                    old = self._traces.pop(tid)
                    old["trace_id"] = f"{tid}#{n}"
                    self._traces[old["trace_id"]] = old
                self._traces[tid] = doc
                self.retained += 1
                while len(self._traces) > self.capacity:
                    self._traces.pop(next(iter(self._traces)))
                    self.evicted += 1
                n = len(self._traces)
            else:
                self.sampled_out += 1
                n = len(self._traces)
        if self.m_retained is not None:
            (self.m_retained if keep else self.m_sampled).inc()
            self.m_count.set(n)
        return bool(keep)

    def late_span(self, trace_id: str, span: dict) -> Optional[int]:
        """Append a span to an already-retained trace (no-op when
        retention dropped it)."""
        with self._lock:
            doc = self._traces.get(trace_id)
            if doc is None:
                return None
            span["id"] = doc["_next"]
            doc["_next"] += 1
            doc["spans"].append(span)
            return span["id"]

    # -- reads ------------------------------------------------------------
    def get(self, trace_id) -> Optional[dict]:
        with self._lock:
            doc = self._traces.get(str(trace_id))
            return None if doc is None else _copy_doc(doc)

    def index(self, min_ms: float = 0.0,
              status: Optional[str] = None,
              limit: int = 50) -> List[dict]:
        with self._lock:
            docs = list(self._traces.values())
        out = []
        for doc in reversed(docs):              # newest first
            if (doc["duration_ms"] or 0.0) < min_ms:
                continue
            if status is not None and doc["status"] != status:
                continue
            out.append(_summary(doc))
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        """Retention counters + an approximate retained-bytes figure
        (a store-RSS reading; JSON length is the honest proxy
        for a store whose documents ARE json)."""
        import json
        with self._lock:
            docs = [_copy_doc(d) for d in self._traces.values()]
            out = {"traces": len(docs), "retained": self.retained,
                   "sampled_out": self.sampled_out,
                   "evicted": self.evicted}
        out["approx_bytes"] = sum(
            len(json.dumps(d, default=str)) for d in docs)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def export_chrome_trace(self, trace_id, ring=None,
                            path: Optional[str] = None
                            ) -> Optional[dict]:
        return _export_chrome(self.get(trace_id), ring, path)


_default_tracer = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer a bench publishes into (servers default
    to a private Tracer per front, like their registries)."""
    return _default_tracer
