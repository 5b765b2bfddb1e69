"""LLM generation serving over HTTP: the continuous-batching engine behind a
stdlib ``ThreadingHTTPServer``.

Counterpart of ``paddle_tpu/inference/serving.py``'s ``GenerationServer`` /
``_GenHandler`` and its clients ``generate_http`` / ``generate_http_stream``:

* ``POST /generate`` blocks for the whole completion, ``POST
  /generate_stream`` streams one JSON line per token (HTTP/1.1 chunked
  NDJSON), ``POST /cancel`` retires a request;
* ``GET /health/live``, ``/health/ready`` and a minimal ``/health``;
* 400 for a bad or oversized request, 429 with ``Retry-After`` when the
  admission queue is full, 503 once the engine died, 504 for an expired
  deadline.

``/metrics``, ``/stats``, ``/events`` and ``/trace*`` wait for the port's
observability slice; priority classes and tenants (the QoS slice) are
refused with 400.  Nothing here imports beyond the standard library, numpy
and the port's engine.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..models.serving_engine import ContinuousBatchingEngine, QueueFullError

__all__ = ["GenerationServer", "generate_http", "generate_http_stream"]


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
        else:
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
            if req.get("priority", "normal") != "normal" or \
                    req.get("tenant") is not None:
                raise ValueError("priority classes and tenants are not "
                                 "supported by this server")
        except Exception as e:
            self._reply(400, f"bad payload: {type(e).__name__}: {e}"
                        .encode(), "text/plain")
            return
        try:
            rid, q = srv.submit(prompt, max_new, deadline_s=deadline)
        except ValueError as e:           # empty / oversized for the pool
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
                    self._reply(200, json.dumps(
                        {"rid": rid, "tokens": payload}).encode())
                    return

        # STREAMING: one JSON line per token as the engine produces it
        def chunk(data: bytes):
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
    drive loop, which owns every engine step."""

    def __init__(self, cfg=None, params=None, cache=None, mesh=None,
                 host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.002, engine=None, **engine_kw):
        if engine is None:
            engine = ContinuousBatchingEngine(cfg, params, cache, mesh=mesh,
                                              **engine_kw)
        self.engine = engine
        self._host, self._port = host, port
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._queues = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._drive_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._fatal: Optional[str] = None

    def is_live(self) -> bool:
        """The drive loop thread is running."""
        t = self._drive_thread
        return t is not None and t.is_alive()

    def is_ready(self) -> bool:
        """Live, engine healthy, and the admission queue below its bound
        (the same predicate ``submit()`` refuses by)."""
        with self._lock:
            return (self.is_live() and self._fatal is None
                    and self.engine.queue_capacity_reason() is None)

    def health_snapshot(self) -> dict:
        """The ``/health`` document, read under the server lock."""
        with self._lock:
            eng = self.engine
            return {"status": "ok" if self._fatal is None else "failed",
                    "error": self._fatal,
                    "live": self.is_live(),
                    "active": len(eng._active),
                    "queued": len(eng._queue),
                    "queued_tokens": eng.queued_tokens(),
                    "free_pages": eng.cache.free_pages(),
                    "decode_steps": eng.decode_steps,
                    "tokens_generated": eng.tokens_generated,
                    "prefill_calls": eng.prefill_calls,
                    "preemptions": eng.preemptions,
                    "prefix_hits": eng.cache.prefix_hits,
                    "requests_finished": eng.requests_finished,
                    "requests_cancelled": eng.requests_cancelled,
                    "requests_expired": eng.requests_expired,
                    "requests_rejected": eng.requests_rejected,
                    "decode_horizon": eng.decode_horizon,
                    "horizon_trimmed_tokens": eng.horizon_trimmed_tokens,
                    "host_syncs": eng.host_syncs,
                    "pipeline_flushes": eng.pipeline_flushes}

    def submit(self, prompt, max_new_tokens, deadline_s=None):
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(f"engine died: {self._fatal}")
            q = _queue.Queue()
            rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                     deadline_s=deadline_s)
            self._queues[rid] = q
        return rid, q

    def cancel(self, rid: int) -> bool:
        """Cancel a request (HTTP disconnects and POST /cancel land here);
        a still-attached waiter gets 499.  No-op on finished rids."""
        with self._lock:
            return self.engine.cancel(rid)

    def _drive(self):
        """Engine thread: step while there is work and fan tokens out to
        each request's queue, all under the lock.  Finished requests fan
        out by status (ok -> tokens, expired -> 504, cancelled -> 499).
        A step exception fails every pending request loudly with its
        text and ends the loop (new submits then get 503)."""
        while not self._stop.is_set():
            try:
                with self._lock:
                    eng = self.engine
                    worked = eng.has_work()
                    if worked:
                        eng.step()
                        for rid, tok in eng.drain_stream():
                            q = self._queues.get(rid)
                            if q is not None:
                                q.put(("tok", tok))
                        for req in eng.finished():
                            q = self._queues.pop(req.rid, None)
                            if q is None:
                                continue
                            if req.status == "ok":
                                q.put(("done", list(req.generated)))
                            elif req.status == "expired":
                                q.put(("err", (504, "deadline exceeded")))
                            else:
                                q.put(("err", (499, "cancelled")))
            except Exception as e:                # engine wedged
                text = f"{type(e).__name__}: {e}"
                with self._lock:
                    dead, self._queues = self._queues, {}
                    self._fatal = text
                for q in dead.values():
                    q.put(("err", (500, f"generation failed: {text}")))
                return
            if not worked:
                time.sleep(self._poll_s)

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _GenHandler)
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
