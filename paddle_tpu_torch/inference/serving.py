"""Serving over HTTP: an exported model behind ``POST /predict``, and LLM
generation over the continuous-batching engine, each behind a stdlib
``ThreadingHTTPServer``.

Counterpart of ``paddle_tpu/inference/serving.py``.  :class:`DevicePool`
holds one ``Predictor`` replica per visible CUDA device (or the devices the
caller names, the CPU among them) over one loaded program, and
round-robins ``run`` across them; each replica replays a CUDA graph per
input signature, and the graph's lock is held from the copy of a request's
inputs in to the copy of its outputs out, so concurrent requests on one
replica get their own answers.  :class:`InferenceServer` serves ``POST
/predict`` (an ``.npz`` of ``x0..xN`` in, of ``out0..outN`` out; 400 for a
malformed body or an arity / shape mismatch, 500 for a failure of the
program), ``GET /health`` (the devices and the requests served) and the
observability endpoints below; :func:`predict_http` is its client.

``GenerationServer`` / ``_GenHandler`` and the clients ``generate_http`` /
``generate_http_stream``:

* ``POST /generate`` blocks for the whole completion, ``POST
  /generate_stream`` streams one JSON line per token (HTTP/1.1 chunked
  NDJSON), ``POST /cancel`` retires a request;
* ``GET /health/live``, ``/health/ready`` and ``/health``, a view over
  the engine's metrics registry (over a speculative engine, as JAX's,
  with ``spec_rounds``, ``spec_drafted``, ``spec_accepted``,
  ``spec_acceptance`` and ``gamma``);
* ``GET /metrics`` (Prometheus text exposition), ``/stats`` (the
  registry's JSON snapshot), ``/events`` (the event ring's tail,
  ``?n=&since=``), ``/traces`` (``?min_ms=&status=&limit=``) and
  ``/trace/<rid>`` (a request's span tree; ``?format=perfetto`` for a
  chrome trace merged with the ring), as docs/OBSERVABILITY.md describes
  them, so ``tools/metrics_dump.py`` reads this server unchanged;
* 400 for a bad or oversized request or an unknown priority class, 429
  with ``Retry-After`` when the admission queue is full or the tenant is
  over its token quota (the bucket's refill time), 500 with the fault's
  text for a request whose wave faulted, 503 once the engine died, 504
  for an expired deadline.

A body may name a ``priority`` class and a ``tenant``; a completion that
overload shedding admitted degraded carries ``"degraded": true`` in the
``/generate`` reply and the stream's last line.

With ``engine_factory`` the drive loop steps an ``EngineSupervisor``: an
exception that escapes the engine's own quarantine rebuilds the engine
and only the requests whose pages died fail.

Nothing here imports beyond the standard library, numpy, torch and the
port's engine, inference and observability packages.
"""

from __future__ import annotations

import contextlib
import io
import json
import queue as _queue
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..models.serving_engine import (ContinuousBatchingEngine,
                                     EngineSupervisor, QueueFullError)
from ..observability import (MetricsRegistry, TraceStore, Tracer,
                             default_ring)
from ..testing import faults
from . import Config, Predictor

__all__ = ["DevicePool", "InferenceServer", "predict_http",
           "GenerationServer", "generate_http", "generate_http_stream"]


def _http_metrics(registry):
    """HTTP-front counters (single registration site, JAX's two names)."""
    return {
        "predict": registry.counter(
            "paddle_tpu_http_predict_requests_total",
            "Successful POST /predict calls"),
        "generate": registry.counter(
            "paddle_tpu_http_generate_requests_total",
            "Accepted POST /generate[_stream] submissions"),
    }


def _snap_val(snap: dict, name: str, default=0):
    """Read one scalar out of a registry snapshot (gauges may be None
    when a scrape callback failed)."""
    m = snap.get(name)
    if m is None:
        return default
    v = m.get("value")
    return default if v is None else v


def _serve_observability(handler, path: str, registry, ring,
                         tracer=None) -> bool:
    """The observability GET endpoints: ``/metrics``, ``/stats``,
    ``/events`` (ring tail; ``?n=`` limit, ``?since=<seq>`` for followers,
    with the ``gap`` of events the ring dropped past the cursor) and, with
    a tracer, ``/traces`` and ``/trace/<rid>``.  None takes the server
    lock: the registry's instruments lock themselves and the callback
    gauges read host state only.  Returns True when the path was
    handled."""
    if path == "/metrics":
        handler._reply(200, registry.render_prometheus().encode(),
                       "text/plain; version=0.0.4")
        return True
    if path == "/stats":
        body = {"metrics": registry.snapshot(),
                "events_buffered": len(ring),
                "events_dropped": ring.dropped}
        handler._reply(200, json.dumps(body).encode())
        return True
    if path == "/events":
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(handler.path).query)
        try:
            since = int(q["since"][0]) if "since" in q else 0
            # a since-follower gets everything new by default: an implicit
            # cap would advance its cursor past dropped burst events
            n = int(q["n"][0]) if "n" in q else (None if since else 100)
        except ValueError:
            handler._reply(400, b"bad query", "text/plain")
            return True
        evs, gap = ring.recent_with_gap(n=n, since=since)
        body = {"events": evs, "gap": gap, "dropped": ring.dropped}
        handler._reply(200, json.dumps(body).encode())
        return True
    if tracer is not None and path == "/traces":
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(handler.path).query)
        try:
            min_ms = float(q["min_ms"][0]) if "min_ms" in q else 0.0
            limit = int(q["limit"][0]) if "limit" in q else 50
            status = q["status"][0] if "status" in q else None
        except ValueError:
            handler._reply(400, b"bad query", "text/plain")
            return True
        body = {"traces": tracer.index(min_ms=min_ms, status=status,
                                       limit=limit)}
        handler._reply(200, json.dumps(body).encode())
        return True
    if tracer is not None and path.startswith("/trace/"):
        rid = path[len("/trace/"):]
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(handler.path).query)
        if q.get("format", ["json"])[0] == "perfetto":
            doc = tracer.export_chrome_trace(rid, ring=ring)
        else:
            doc = tracer.get(rid)
        if doc is None:
            handler._reply(404, b"no such trace (dropped by tail "
                                b"sampling, or never begun)", "text/plain")
        else:
            handler._reply(200, json.dumps(doc).encode())
        return True
    return False


class DevicePool:
    """Replica-per-device predictor pool: one Predictor loads the program
    and the others share it (a copy on each other device); ``run``
    round-robins, so concurrent callers fan out across devices."""

    def __init__(self, config: Config, devices: Optional[List] = None):
        import torch
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError(
                    "DevicePool: no CUDA device is visible; name the devices "
                    "(devices=['cpu']) to serve on the CPU")
        self._devices = [torch.device(d) for d in devices]
        first = Predictor(config, device=self._devices[0])
        self._replicas = [first] + [
            Predictor(config, _shared_from=first, device=d)
            for d in self._devices[1:]]
        self._rr = 0
        self._lock = threading.Lock()

    @property
    def device_names(self) -> List[str]:
        return [str(d) for d in self._devices]

    def run(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
        with self._lock:
            i = self._rr
            self._rr = (self._rr + 1) % len(self._replicas)
        return self.run_on(i, inputs)

    def run_on(self, idx: int,
               inputs: List[np.ndarray]) -> List[np.ndarray]:
        # the stateless form: Predictor.run stages its result on the
        # predictor, which concurrent server threads sharing a replica
        # would race
        return self._replicas[idx]._execute(inputs)


def _pack_npz(arrays: List[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"out{i}": a for i, a in enumerate(arrays)})
    return buf.getvalue()


def _unpack_npz(body: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(body)) as z:
        names = sorted(z.files,
                       key=lambda n: int("".join(c for c in n
                                                 if c.isdigit()) or 0))
        return [z[n] for n in names]


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch-serving/0.1"

    def log_message(self, *a):
        pass

    def _reply(self, code, body, ctype="application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv: "InferenceServer" = self.server.owner
        path = urllib.parse.urlsplit(self.path).path.rstrip("/")
        if path in ("", "/health"):
            with srv._count_lock:
                count = srv.request_count
            meta = {"status": "ok", "devices": srv.pool.device_names,
                    "requests": count}
            self._reply(200, json.dumps(meta).encode(), "application/json")
        elif not _serve_observability(self, path, srv.registry, srv.ring):
            self._reply(404, b"not found", "text/plain")

    def do_POST(self):
        srv: "InferenceServer" = self.server.owner
        if self.path.rstrip("/") != "/predict":
            self._reply(404, b"not found", "text/plain")
            return
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        try:
            inputs = _unpack_npz(body)
        except Exception as e:
            self._reply(400, f"bad payload: {type(e).__name__}".encode(),
                        "text/plain")
            return
        try:
            outs = srv.pool.run(inputs)
        except ValueError as e:
            # arity / shape mismatch: the caller's fault
            self._reply(400, f"bad request: {e}".encode(), "text/plain")
            return
        except Exception:
            # a failure of the program is the server's: 500, so a load
            # balancer retries elsewhere; no internal detail in the body
            self._reply(500, b"inference failed", "text/plain")
            return
        with srv._count_lock:
            srv.request_count += 1
        srv._http_counters["predict"].inc()
        self._reply(200, _pack_npz(outs))


class InferenceServer:
    """``POST /predict`` (npz in and out) over a :class:`DevicePool`.

    >>> srv = InferenceServer(Config(prog_file="m.pt2"))
    >>> port = srv.start()            # background thread
    >>> outs = predict_http(f"http://127.0.0.1:{port}", [x])
    >>> srv.stop()
    """

    def __init__(self, config: Config, devices=None,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics_registry=None):
        self.pool = DevicePool(config, devices)
        self._host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.request_count = 0
        self._count_lock = threading.Lock()
        # a registry of the server's own by default (exact scrapes); pass
        # observability.default_registry() to publish process-wide
        self.registry = metrics_registry if metrics_registry \
            is not None else MetricsRegistry()
        self.ring = default_ring()
        self._http_counters = _http_metrics(self.registry)

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.owner = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def predict_http(url: str, inputs: List[np.ndarray],
                 timeout: float = 30.0) -> List[np.ndarray]:
    """Client for :class:`InferenceServer` (stdlib urllib)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"x{i}": a for i, a in enumerate(inputs)})
    req = urllib.request.Request(
        url.rstrip("/") + "/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return _unpack_npz(r.read())


class _GenHandler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch-genserving/0.1"
    # chunked Transfer-Encoding (the /generate_stream response) only
    # exists in HTTP/1.1
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _reply(self, code, body, ctype="application/json", headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv: "GenerationServer" = self.server.owner
        path = urllib.parse.urlsplit(self.path).path.rstrip("/")
        if path == "/health/live":
            # LIVENESS: the serving loop thread is running
            ok = srv.is_live()
            self._reply(200 if ok else 503,
                        b'{"live": true}' if ok else b'{"live": false}')
        elif path == "/health/ready":
            # READINESS: live, engine healthy, admission queue below its
            # bound
            ok = srv.is_ready()
            self._reply(200 if ok else 503,
                        b'{"ready": true}' if ok else b'{"ready": false}')
        elif path in ("", "/health"):
            self._reply(200, json.dumps(srv.health_snapshot()).encode())
        elif not _serve_observability(self, path, srv.registry, srv.ring,
                                      srv.tracer):
            self._reply(404, b"not found", "text/plain")

    def do_POST(self):
        srv: "GenerationServer" = self.server.owner
        path = self.path.rstrip("/")
        if path not in ("/generate", "/generate_stream", "/cancel"):
            self._reply(404, b"not found", "text/plain")
            return
        n = int(self.headers.get("Content-Length", "0"))
        if path == "/cancel":
            try:
                rid = int(json.loads(self.rfile.read(n))["rid"])
            except Exception as e:
                self._reply(400, f"bad payload: {type(e).__name__}".encode(),
                            "text/plain")
                return
            ok = srv.cancel(rid)
            self._reply(200, json.dumps(
                {"rid": rid, "cancelled": bool(ok)}).encode())
            return
        try:
            req = json.loads(self.rfile.read(n))
            prompt = [int(t) for t in req["prompt"]]
            max_new = int(req.get("max_new_tokens", 64))
            deadline = req.get("deadline_s")
            deadline = None if deadline is None else float(deadline)
            priority = str(req.get("priority", "normal"))
            tenant = req.get("tenant")
            tenant = None if tenant is None else str(tenant)
        except Exception as e:
            self._reply(400, f"bad payload: {type(e).__name__}: {e}"
                        .encode(), "text/plain")
            return
        try:
            rid, q = srv.submit(prompt, max_new, deadline_s=deadline,
                                priority=priority, tenant=tenant)
        except ValueError as e:     # empty, oversized, or an unknown class
            self._reply(400, f"rejected: {e}".encode(), "text/plain")
            return
        except QueueFullError as e:       # backpressure: come back later
            # Retry-After takes whole seconds: round the hint up
            self._reply(429, f"queue full: {e}".encode(), "text/plain",
                        [("Retry-After",
                          str(max(1, int(-(-e.retry_after // 1)))))])
            return
        except RuntimeError as e:         # engine died: retry elsewhere
            self._reply(503, f"engine unavailable: {e}".encode(),
                        "text/plain")
            return
        if path == "/generate":
            toks = []
            while True:
                kind, payload = q.get()
                if kind == "tok":
                    toks.append(payload)
                elif kind == "err":
                    code, text = payload
                    self._reply(code, text.encode(), "text/plain")
                    return
                else:
                    doc = {"rid": rid, "tokens": payload}
                    if kind == "done_degraded":
                        # overload shedding halved this request's budget
                        doc["degraded"] = True
                    self._reply(200, json.dumps(doc).encode())
                    return

        # STREAMING: one JSON line per token as the engine produces it
        def chunk(data: bytes):
            faults.fire("stream_write")   # an injected client disconnect
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        try:
            # headers inside the protected block: a client that vanished
            # raises right here, and the request must still cancel
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while True:
                kind, payload = q.get()
                if kind == "tok":
                    chunk(json.dumps({"rid": rid, "token": payload})
                          .encode() + b"\n")
                    continue
                if kind == "err":
                    doc = {"rid": rid, "done": True, "error": payload[1]}
                else:
                    doc = {"rid": rid, "done": True, "tokens": payload}
                    if kind == "done_degraded":
                        doc["degraded"] = True
                chunk(json.dumps(doc).encode() + b"\n")
                chunk(b"")                   # terminal chunk: 0\r\n\r\n
                return
        except (BrokenPipeError, ConnectionResetError):
            pass                 # client gone: cancel below
        finally:
            # a no-op after normal completion, a cancellation after a
            # disconnect or handler error
            srv.cancel(rid)


class GenerationServer:
    """Continuous-batching LLM serving over HTTP: requests arriving
    concurrently batch into the engine's decode step; ``/generate``
    blocks for the full completion, ``/generate_stream`` streams one
    JSON line per token the step it is produced.

    Build it from ``(cfg, params, cache, **engine_kw)`` or pass a built
    ``engine=``.  ``start()`` returns the bound port (``port=0`` picks a
    free one) and starts two daemon threads: the HTTP listener and the
    drive loop, which owns every engine step.

    ``/metrics``, ``/stats``, ``/events`` and ``/health`` read the
    engine's registry and ring (``metrics_registry`` rides in
    ``engine_kw``, as in JAX: a registry private to the engine by
    default; an engine built with ``metrics_registry=False`` leaves an
    empty registry here).  ``tracer`` is on by default: a
    ``Tracer(TraceStore(...))`` publishing its store's counters to the
    same registry, handed to the engine unless the engine brought its
    own (then the server adopts that one); ``tracer=False`` turns it
    off.

    ``engine_factory`` (a callable returning a fresh engine) turns on
    crash recovery: the drive loop steps an :class:`EngineSupervisor`
    (``max_restarts`` per ``restart_window_s``, exponential
    ``restart_backoff_s``), and ``engine`` follows its restarts.  The
    factory should share one ``metrics_registry`` across builds so
    ``/metrics`` survives restarts.  Without a factory the first escaped
    exception is fatal: pending requests get 500 with its text, new
    submits 503."""

    handler_class = _GenHandler
    # how long a readiness probe or /health scrape waits for the server
    # lock before serving the last verdict built under it (a step, a
    # first capture, can hold the lock for a while)
    _READY_PROBE_WAIT_S = 0.05

    def __init__(self, cfg=None, params=None, cache=None, mesh=None,
                 host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.002, engine=None,
                 engine_factory=None, max_restarts: int = 3,
                 restart_window_s: float = 60.0,
                 restart_backoff_s: float = 0.05, tracer=None,
                 **engine_kw):
        self._supervisor = None
        self._engine = None
        if engine_factory is not None:
            self._supervisor = EngineSupervisor(
                engine_factory, max_restarts=max_restarts,
                window_s=restart_window_s, backoff_s=restart_backoff_s)
        elif engine is not None:
            self._engine = engine
        else:
            self._engine = ContinuousBatchingEngine(cfg, params, cache,
                                                    mesh=mesh, **engine_kw)
        engine = self.engine
        self._host, self._port = host, port
        self._poll_s = poll_s
        self._lock = threading.Lock()
        # handler threads blocked on the lock (see _turn)
        self._waiting: list = []
        self._queues = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._drive_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._fatal: Optional[str] = None
        # the last readiness verdict and /health document built under the
        # lock (the second with the monotonic instant it was built),
        # served when a probe cannot get the lock promptly
        self._ready_last = False
        self._health_last: Optional[tuple] = None
        m = engine.metrics
        if m is not None:
            self.registry, self.ring = m.registry, m.ring
        else:
            self.registry, self.ring = MetricsRegistry(), default_ring()
        self._http_counters = _http_metrics(self.registry)
        # one tracer for the server and its engine: hand the server's down
        # when the engine has none, adopt the engine's when it brought one
        self._tracing = tracer is not False
        if tracer is False:
            self.tracer = None
        elif tracer is not None or engine.tracer is not None:
            self.tracer = tracer
        else:
            self.tracer = Tracer(TraceStore(metrics_registry=self.registry))
        self._attach_tracer()

    @property
    def engine(self):
        """The current engine (after a supervisor restart, the rebuilt
        one: rids and lifecycle state carry over)."""
        return self._supervisor.engine if self._supervisor is not None \
            else self._engine

    @property
    def _driver(self):
        """What the drive loop steps: the supervisor or the bare
        engine."""
        return self._supervisor if self._supervisor is not None \
            else self._engine

    @property
    def restarts(self) -> int:
        return self._supervisor.restarts \
            if self._supervisor is not None else 0

    def _rebind_observability(self) -> None:
        """After a supervisor restart, follow the current engine's
        registry and ring, so ``/metrics``, ``/stats`` and ``/health``
        read the engine that serves (a no-op when the factory shares one
        registry across builds), and keep one tracer.  Caller holds the
        lock."""
        m = self.engine.metrics
        if m is not None and m.registry is not self.registry:
            self.registry, self.ring = m.registry, m.ring
            self._http_counters = _http_metrics(self.registry)
        self._attach_tracer()

    def _attach_tracer(self) -> None:
        """Keep the server and its engine on one tracer: hand the
        server's down when the engine has none, adopt the engine's when it
        brought its own.  Caller holds the lock (or is the
        constructor)."""
        if not self._tracing:
            return                    # tracer=False: the surface is off
        eng = self.engine
        if eng.tracer is None:
            if self.tracer is not None:
                eng.tracer = self.tracer
        elif eng.tracer is not self.tracer:
            self.tracer = eng.tracer
            if self.tracer.store.m_retained is None:
                self.tracer.store.bind_metrics(self.registry)

    @contextlib.contextmanager
    def _turn(self):
        """The server lock for a handler thread (a submit, a cancel).  The
        drive loop takes the lock again right after a step, sooner than a
        blocked thread wakes, so a busy engine could starve a cancel: the
        waiter shows itself in ``_waiting`` and the loop leaves it a
        turn."""
        self._waiting.append(None)
        try:
            with self._lock:
                yield
        finally:
            self._waiting.pop()

    def is_live(self) -> bool:
        """The drive loop thread is running."""
        t = self._drive_thread
        return t is not None and t.is_alive()

    def is_ready(self) -> bool:
        """Live, engine healthy, and the admission queue below its bound
        (the same predicate ``submit()`` refuses by).  Waits at most
        ``_READY_PROBE_WAIT_S`` for the server lock, else serves the last
        verdict computed under it."""
        if not self._lock.acquire(timeout=self._READY_PROBE_WAIT_S):
            return self._ready_last
        try:
            r = self._is_ready_locked()
            self._ready_last = r
            return r
        finally:
            self._lock.release()

    def _is_ready_locked(self) -> bool:
        if not self.is_live() or self._fatal is not None:
            return False
        if self._supervisor is not None and \
                self._supervisor.state != "READY":
            # draining or dead: probes pull the node out of rotation
            return False
        return self.engine.queue_capacity_reason() is None

    def health_snapshot(self) -> dict:
        """The ``/health`` document: JAX's keys as a view over the metrics
        registry, plus the engine's ``host_syncs`` and
        ``pipeline_flushes``.  The handful of engine reads the registry
        does not carry happen under the server lock; the registry
        snapshot runs after it is released.  When the drive thread holds
        the lock past ``_READY_PROBE_WAIT_S`` the last document is served
        with ``stale_s``, its age in seconds (the very first scrape
        waits).  With ``metrics_registry=False`` the same keys are read
        from the engine's attributes under the lock."""
        if not self._lock.acquire(timeout=self._READY_PROBE_WAIT_S):
            last = self._health_last
            if last is not None:
                doc, built_t = last
                stale = dict(doc)
                stale["stale_s"] = round(time.monotonic() - built_t, 3)
                return stale
            self._lock.acquire()
        try:
            h, view = self._health_locked()
        finally:
            self._lock.release()
        if h is None:
            fixed, extra, args = view
            h = {**fixed, **self._health_from_registry(
                self.registry.snapshot(), *args), **extra}
        self._health_last = (h, time.monotonic())
        return h

    def _health_locked(self):
        """The locked half of :meth:`health_snapshot` (caller holds the
        lock): ``(doc, None)`` when the document is whole, else ``(None,
        (fixed, extra, args))`` for the registry view built after the lock
        is released."""
        eng = self.engine
        fixed = {"status": "ok" if self._fatal is None else "failed",
                 "error": self._fatal,
                 "live": self.is_live(),
                 "ready": self._is_ready_locked(),
                 "restarts": self.restarts,
                 "step_faults": eng.step_faults}
        extra = {"host_syncs": eng.host_syncs,
                 "pipeline_flushes": eng.pipeline_flushes}
        if eng.metrics is None:
            return {**fixed, **self._health_from_engine(eng), **extra}, None
        # a speculative engine's gamma (configuration, moved by an
        # adaptive retune); None on the other lanes.  A drive target
        # without a lane's knob (a DisaggCoordinator) reads JAX's defaults
        gamma = eng.gamma if hasattr(eng, "spec_rounds") else None
        return None, (fixed, extra,
                      (getattr(eng, "decode_horizon", 1),
                       getattr(eng, "mixed_token_budget", 0), gamma))

    @staticmethod
    def _health_from_engine(eng) -> dict:
        """The registry view's counts read from the engine's attributes
        (no registry to view); caller holds the server lock.  A
        speculative engine adds its round and acceptance counts and
        gamma."""
        mixed_ticks = getattr(eng, "mixed_ticks", 0)
        mixed_tokens = getattr(eng, "mixed_prefill_tokens", 0)
        h = {"requests_cancelled": eng.requests_cancelled,
                "requests_expired": eng.requests_expired,
                "requests_rejected": eng.requests_rejected,
                "requests_faulted": eng.requests_faulted,
                "queued_tokens": eng.queued_tokens(),
                "active": len(eng._active)
                + len(getattr(eng, "_mixed_pref", ())),
                "queued": len(eng._queue),
                "free_pages": eng.cache.free_pages(),
                "decode_steps": eng.decode_steps,
                "tokens_generated": eng.tokens_generated,
                "prefill_calls": eng.prefill_calls,
                "preemptions": eng.preemptions,
                "prefix_hits": eng.cache.prefix_hits,
                "swap_out_pages": eng.cache.swap_out_pages,
                "swap_in_pages": eng.cache.swap_in_pages,
                "prefill_tokens_avoided": eng.prefill_tokens_avoided,
                "mixed_ticks": mixed_ticks,
                "mixed_prefill_tokens": mixed_tokens,
                "mixed_budget_utilization": round(
                    mixed_tokens / max(
                        mixed_ticks * getattr(eng, "mixed_token_budget", 0),
                        1), 4),
                "decode_horizon": getattr(eng, "decode_horizon", 1),
                "horizon_trimmed_tokens":
                    getattr(eng, "horizon_trimmed_tokens", 0),
                "requests_finished": eng.requests_finished}
        if hasattr(eng, "spec_rounds"):
            h["spec_rounds"] = eng.spec_rounds
            h["spec_drafted"] = eng.spec_drafted
            h["spec_accepted"] = eng.spec_accepted
            h["spec_acceptance"] = round(
                eng.spec_accepted / max(eng.spec_drafted, 1), 4)
            h["gamma"] = eng.gamma
        return h

    @staticmethod
    def _health_from_registry(snap: dict, decode_horizon: int,
                              mixed_budget: int = 0,
                              gamma: Optional[int] = None) -> dict:
        """JAX's registry view (``_health_from_registry``) over one
        snapshot: every count is read from the instrumentation, none
        from engine attributes (``mixed_budget``, the engine's
        ``mixed_token_budget``, and ``gamma``, a speculative engine's, are
        configuration; with ``gamma`` the spec fields join)."""
        def v(name):
            return int(_snap_val(snap, name))

        h = {
            "requests_cancelled": v(
                "paddle_tpu_engine_requests_cancelled_total"),
            "requests_expired": v(
                "paddle_tpu_engine_requests_expired_total"),
            "requests_rejected": v(
                "paddle_tpu_engine_requests_rejected_total"),
            "requests_faulted": v(
                "paddle_tpu_engine_requests_faulted_total"),
            "queued_tokens": v("paddle_tpu_engine_queued_tokens_count"),
            "active": v("paddle_tpu_engine_active_requests_count"),
            "queued": v("paddle_tpu_engine_queued_requests_count"),
            "free_pages": v("paddle_tpu_kvcache_free_pages_count"),
            "occupancy": _snap_val(
                snap, "paddle_tpu_engine_batch_occupancy_ratio"),
            "decode_steps": v("paddle_tpu_engine_decode_steps_total"),
            "tokens_generated": v(
                "paddle_tpu_engine_tokens_generated_total"),
            "prefill_calls": v(
                "paddle_tpu_engine_prefill_dispatches_total"),
            "preemptions": v("paddle_tpu_engine_preemptions_total"),
            "prefix_hits": v("paddle_tpu_kvcache_prefix_hit_pages_total"),
            "swap_out_pages": v("paddle_tpu_kvcache_swap_out_pages_total"),
            "swap_in_pages": v("paddle_tpu_kvcache_swap_in_pages_total"),
            "prefill_tokens_avoided": v(
                "paddle_tpu_engine_prefill_tokens_avoided_total"),
            "mixed_ticks": v("paddle_tpu_engine_mixed_ticks_total"),
            "mixed_prefill_tokens": v(
                "paddle_tpu_engine_mixed_piggybacked_prefill_tokens_total"),
            "mixed_budget_utilization": round(
                v("paddle_tpu_engine_mixed_piggybacked_prefill_tokens_total")
                / max(v("paddle_tpu_engine_mixed_ticks_total")
                      * mixed_budget, 1), 4),
            "decode_horizon": decode_horizon,
            "horizon_trimmed_tokens": v(
                "paddle_tpu_engine_horizon_trimmed_tokens_total"),
            "requests_finished": v(
                "paddle_tpu_engine_requests_finished_total")}
        if gamma is not None:                       # speculative
            h["spec_rounds"] = v("paddle_tpu_engine_spec_rounds_total")
            h["spec_drafted"] = v(
                "paddle_tpu_engine_spec_drafted_tokens_total")
            h["spec_accepted"] = v(
                "paddle_tpu_engine_spec_accepted_tokens_total")
            h["spec_acceptance"] = round(
                h["spec_accepted"] / max(h["spec_drafted"], 1), 4)
            h["gamma"] = gamma
        if "paddle_tpu_disagg_handoff_pages_total" in snap:
            # a disaggregated front (DisaggCoordinator, or a fleet with
            # prefill and decode roles): the hand-off pipeline
            h["handoff_pages"] = v("paddle_tpu_disagg_handoff_pages_total")
            h["handoff_inflight"] = v(
                "paddle_tpu_disagg_handoff_inflight_count")
            h["disagg_colocated_fallbacks"] = v(
                "paddle_tpu_disagg_colocated_fallback_total")
        return h

    def submit(self, prompt, max_new_tokens, deadline_s=None,
               priority="normal", tenant=None):
        t0 = time.monotonic()
        with self._turn():
            if self._fatal is not None:
                raise RuntimeError(f"engine died: {self._fatal}")
            q = _queue.Queue()
            rid = self._driver.submit(prompt, max_new_tokens=max_new_tokens,
                                      deadline_s=deadline_s,
                                      priority=priority, tenant=tenant)
            self._queues[rid] = q
        self._http_counters["generate"].inc()
        if self.tracer is not None:
            # the handler-side wall of the accepted submission (the engine
            # began the trace under the same rid)
            self.tracer.add_span(str(rid), "http_ingress", t0,
                                 time.monotonic())
        return rid, q

    def cancel(self, rid: int) -> bool:
        """Cancel a request (HTTP disconnects and POST /cancel land here);
        a still-attached waiter gets 499.  No-op on finished rids."""
        with self._turn():
            return self._driver.cancel(rid)

    def _drive(self):
        """Engine thread: step while there is work and fan tokens out to
        each request's queue, all under the lock.  Finished requests fan
        out by status (ok -> tokens, expired -> 504, cancelled -> 499,
        error -> 500 with the fault's text).  A step exception the
        supervisor cannot absorb (or any, without one) fails every
        pending request loudly with its text and ends the loop (new
        submits then get 503)."""
        while not self._stop.is_set():
            try:
                with self._lock:
                    eng = self._driver
                    worked = eng.has_work()
                    if worked:
                        eng.step()
                        if self._supervisor is not None:
                            self._rebind_observability()
                        for rid, tok in eng.drain_stream():
                            q = self._queues.get(rid)
                            if q is not None:
                                q.put(("tok", tok))
                        for req in eng.finished():
                            q = self._queues.pop(req.rid, None)
                            if self.tracer is not None and req.t_finish:
                                # terminal delivery, retirement -> waiter
                                # fan-out: a late span, kept iff tail
                                # retention kept the trace
                                self.tracer.add_span(
                                    str(req.rid), "stream", req.t_finish,
                                    time.monotonic(),
                                    attrs={"phase": "stream",
                                           "status": req.status})
                            if q is None:
                                continue
                            if req.status == "ok":
                                q.put(("done_degraded"
                                       if getattr(req, "degraded", False)
                                       else "done", list(req.generated)))
                            elif req.status == "expired":
                                q.put(("err", (504, "deadline exceeded")))
                            elif req.status == "cancelled":
                                q.put(("err", (499, "cancelled")))
                            else:
                                q.put(("err", (
                                    500, "generation failed: "
                                    f"{req.error or 'engine fault'}")))
            except Exception as e:                # engine wedged
                text = f"{type(e).__name__}: {e}"
                with self._lock:
                    dead, self._queues = self._queues, {}
                    self._fatal = text
                for q in dead.values():
                    q.put(("err", (500, f"generation failed: {text}")))
                return
            if not worked or self._waiting:
                time.sleep(self._poll_s)

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          self.handler_class)
        self._httpd.owner = self
        for target in (self._httpd.serve_forever, self._drive):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        self._drive_thread = self._threads[-1]
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(timeout=10.0)


def _gen_body(prompt, max_new_tokens, deadline_s) -> bytes:
    body = {"prompt": [int(t) for t in prompt],
            "max_new_tokens": max_new_tokens}
    if deadline_s is not None:
        body["deadline_s"] = float(deadline_s)
    return json.dumps(body).encode()


def generate_http(url: str, prompt, max_new_tokens: int = 64,
                  timeout: float = 120.0, deadline_s=None):
    """Blocking client for :class:`GenerationServer` ``/generate``."""
    req = urllib.request.Request(
        url.rstrip("/") + "/generate",
        data=_gen_body(prompt, max_new_tokens, deadline_s),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())["tokens"]


def generate_http_stream(url: str, prompt, max_new_tokens: int = 64,
                         timeout: float = 120.0, deadline_s=None):
    """Streaming client: yields tokens as the server emits them.  Raises
    ``RuntimeError`` when the terminal message carries an ``error``."""
    req = urllib.request.Request(
        url.rstrip("/") + "/generate_stream",
        data=_gen_body(prompt, max_new_tokens, deadline_s),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            if not line.strip():
                continue
            msg = json.loads(line)
            if msg.get("done"):
                if msg.get("error"):
                    raise RuntimeError(
                        f"generation failed mid-stream: {msg['error']}")
                return
            yield msg["token"]
