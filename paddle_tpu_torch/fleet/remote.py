"""Multi-process replicas: the agent process and its fleet-side handle.

Counterpart of ``paddle_tpu/fleet/remote.py``, speaking the same frames
(:mod:`.transport`) and the same RPC ops, so a port router drives a JAX
agent and a JAX router a port agent.  The module's two ends:

* :class:`ReplicaAgent` hosts one supervisor-wrapped engine and answers the
  frame protocol over TCP.  A drive thread steps the engine; one handler
  thread a client connection serializes against it on the agent's lock.
  It runs in a thread (tests, CPU runs) or in an OS process of its own
  through :func:`spawn_agent_process`, which dies by ``SIGKILL``.  A
  replica in its own process keeps its own CUDA context: a sticky CUDA
  error (a device-side assert) ends that process, not the router's.
* :class:`RemoteReplicaHandle` sits in
  :class:`~paddle_tpu_torch.fleet.FleetRouter` beside the in-process
  :class:`~paddle_tpu_torch.fleet.router.ReplicaHandle` s: the same states,
  the same hand-off seam and the same failover.

Liveness is a lease: every successful RPC renews it; a failed round-trip
is a heartbeat miss that turns the replica DEGRADED (routing steers
around it), and a lease unrenewed past ``lease_s`` raises
:class:`~paddle_tpu_torch.fleet.transport.LeaseExpiredError` out of the
handle's step, which the router's death triage turns into failover
(requests that streamed nothing are placed again under their fleet rid
and absolute deadline; the others end with an error).

Delivery is cursor-acknowledged: the agent buffers every streamed token
and finished result under a sequence number and prunes only what the
handle acked, so a sync reply lost to a drop is served again.  Submission
is idempotent: every submit carries a key (client id and fleet rid), and
the agent's dedup table answers a retried frame with the original rid.

KV hand-offs ship as raw bytes in JAX's layout, ``[L, pages, ...]``
blocks: the port's cache exports and adopts page-major blocks, so each
block is transposed once on the way out and once on the way in.
"""

from __future__ import annotations

import builtins
import importlib
import os
import signal
import socket
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.serving_engine import (EngineDeadError, EngineSupervisor,
                                     Request, _count_params)
from ..testing import faults
from .transport import (Connection, LeaseExpiredError, ProtocolError,
                        TransportError, open_connection, pack_array,
                        recv_frame, send_frame, unpack_array)

__all__ = ["ReplicaAgent", "RemoteSpec", "RemoteReplicaHandle",
           "spawn_agent_process", "arm_fault_spec", "wire_request",
           "request_from_wire"]


# ---------------------------------------------------------------------------
# the wire form of a Request (its clocks shifted on receive)
# ---------------------------------------------------------------------------
def wire_request(req: Request, trace_id=None) -> dict:
    """The JSON form of a ``Request``.  Monotonic instants mean nothing in
    another process, so the dict carries the sender's ``now`` and the
    receiver shifts every clock by its own offset: phase durations and the
    deadline's headroom survive the hop."""
    return {"rid": int(req.rid),
            "max_new_tokens": int(req.max_new_tokens),
            "generated": [int(t) for t in req.generated],
            "stop_sequences": req.stop_sequences,
            "done": bool(req.done),
            "status": req.status, "error": req.error,
            "preempted": int(req.preempted),
            "deadline": float(req.deadline),
            "t_submit": float(req.t_submit),
            "t_admit": float(req.t_admit),
            "t_first_token": float(req.t_first_token),
            "t_finish": float(req.t_finish),
            "spec": req.spec,
            "priority": req.priority, "tenant": req.tenant,
            "degraded": bool(req.degraded),
            "phase": req.phase, "t_phase": float(req.t_phase),
            "phase_log": [[p, float(a), float(b)]
                          for p, a, b in req.phase_log],
            "trace_id": trace_id,
            "now": time.monotonic()}


def request_from_wire(d: dict, prompt) -> Request:
    """Inverse of :func:`wire_request` on this process's clock."""
    off = time.monotonic() - d["now"]

    def shift(t):
        return (t + off) if t else 0.0

    req = Request(int(d["rid"]), _as_prompt(prompt),
                  int(d["max_new_tokens"]),
                  generated=[int(t) for t in d["generated"]],
                  stop_sequences=d.get("stop_sequences"),
                  t_submit=shift(d["t_submit"]),
                  t_admit=shift(d["t_admit"]),
                  t_first_token=shift(d["t_first_token"]),
                  t_finish=shift(d["t_finish"]),
                  deadline=shift(d["deadline"]),
                  spec=d.get("spec"))
    req.done = bool(d["done"])
    req.status = d["status"]
    req.error = d["error"]
    req.preempted = int(d.get("preempted", 0))
    req.priority = d.get("priority", "normal")
    req.tenant = d.get("tenant")
    req.degraded = bool(d.get("degraded", False))
    req.phase = d["phase"]
    req.t_phase = shift(d["t_phase"])
    req.phase_log = [(p, shift(a), shift(b))
                     for p, a, b in d["phase_log"]]
    return req


def _as_prompt(p) -> np.ndarray:
    """A prompt from the wire (a CPU tensor) or from a caller -> int64."""
    if hasattr(p, "numpy"):
        p = p.numpy()
    return np.asarray(p, np.int64)


def _pack_record(prompt, blocks) -> Tuple[list, list]:
    """(metas, blobs) of a hand-off: the prompt, then each of the page-major
    ``(k, v, kscale, vscale)`` blocks in JAX's ``[L, pages, ...]`` layout."""
    metas, blobs = [], []
    for i, a in enumerate((prompt,) + tuple(blocks)):
        m, b = pack_array(a if i == 0 or a is None
                          else a.transpose(0, 1))
        metas.append(m)
        blobs.append(b)
    return metas, blobs


def _unpack_record(metas, blobs) -> tuple:
    """Inverse of :func:`_pack_record` -> ``(prompt, k, v, kscale,
    vscale)``, the blocks page-major again (the port cache's layout)."""
    out = []
    for i, (m, b) in enumerate(zip(metas, blobs)):
        a = unpack_array(m, b)
        if i and a is not None:
            a = a.transpose(0, 1).contiguous()
        out.append(a)
    return tuple(out)


class _WireHandoffRecord:
    """A hand-off record rebuilt from the wire: its blocks already fetched
    (``materialize()`` returns them), its staging pages freed on the source
    side (``discard()`` frees nothing here).  ``poisoned`` marks a record
    whose source-side fetch failed: the router's ship path degrades it to a
    colocated re-prefill, as an in-process ship fault."""

    __slots__ = ("request", "blobs", "pages", "nbytes", "poisoned")

    def __init__(self, request: Request, blobs, pages: int,
                 nbytes: int, poisoned: Optional[str] = None):
        self.request = request
        self.blobs = blobs
        self.pages = int(pages)
        self.nbytes = int(nbytes)
        self.poisoned = poisoned

    def materialize(self):
        if self.poisoned is not None:
            raise RuntimeError(
                f"handoff ship failed on the source agent: "
                f"{self.poisoned}")
        return self.blobs

    def discard(self) -> None:
        self.blobs = None


def arm_fault_spec(spec) -> None:
    """Arm a JSON-able fault schedule into this process's plane (the plane
    is per process, so a schedule armed in the router's process does
    nothing in a spawned agent).  Agents take ``fault_spec=[{"site": ...,
    "exc": "RuntimeError:boom", "every"/"nth"/"times"/"p"/"seed": ...},
    ...]`` in their config and arm it at start."""
    if not spec:
        return
    fp = faults.get()
    if fp is None:
        fp = faults.install()
    for f in spec:
        exc = None
        if f.get("exc"):
            etype, _, msg = str(f["exc"]).partition(":")
            cls = getattr(builtins, etype, None)
            if not (isinstance(cls, type)
                    and issubclass(cls, BaseException)):
                cls = RuntimeError
            exc = cls(msg or "injected")
        fp.inject(f["site"], exc, nth=f.get("nth"),
                  every=f.get("every"), times=f.get("times"),
                  p=f.get("p"), seed=f.get("seed", 0))


# ---------------------------------------------------------------------------
# the agent (server side)
# ---------------------------------------------------------------------------
class ReplicaAgent:
    """One engine replica served over TCP.

    A drive thread steps the supervisor while it has work and harvests the
    stream and finished requests into a cursor-acknowledged event buffer;
    handler threads (one a client connection) answer RPCs.  Every engine
    touch (a drive step, submit, cancel, hand-off admission) serializes on
    ``_lock``, so the engine is driven from one thread at a time, as
    ``GenerationServer`` drives it.

    ``shutdown(graceful=True)`` stops admission, lets the drive thread
    finish every stream in flight, answers syncs until the last result is
    acked and then exits.  :meth:`die` is an abrupt in-thread stand-in for
    ``SIGKILL`` (sockets torn down, the engine abandoned mid-step);
    :func:`spawn_agent_process` gives the real one."""

    # bounds the idempotency dedup table (oldest keys evicted first):
    # retries arrive within a call's bounded backoff, and a long-lived
    # agent must not grow with its request count
    _KEY_CAP = 4096

    def __init__(self, factory: Callable, *, host: str = "127.0.0.1",
                 port: int = 0, role: str = "unified",
                 lease_s: float = 2.0, poll_s: float = 0.002,
                 fault_spec=None, max_restarts: int = 3,
                 window_s: float = 60.0, backoff_s: float = 0.0):
        self._factory = factory
        self.host, self.port = host, int(port)
        self.role = role
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.fault_spec = fault_spec
        self._sup_kw = dict(max_restarts=max_restarts,
                            window_s=window_s, backoff_s=backoff_s)
        # two locks, ordered _lock > _buf_lock: the engine lock is held
        # across steps (a cold engine's first ones are slow), and a sync
        # heartbeat that waited for one could expire a healthy replica's
        # lease; so sync serves from the buffer lock alone and the drive
        # thread publishes into it after every step.  The lease answers "is
        # the process alive", not "is the engine fast"
        self._lock = threading.Lock()
        self._buf_lock = threading.Lock()
        self._sup: Optional[EngineSupervisor] = None
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._events: List[tuple] = []     # (seq, kind, payload...)
        self._next_seq = 0
        self._snap_cache: dict = {}        # the last published snapshot
        # idempotency dedup: key -> rid, bounded
        self._by_key: Dict[str, int] = {}
        self._key_order: deque = deque()
        self._trace_ids: Dict[int, object] = {}
        # the taken, unacked hand-off batch: take_handoffs drains records
        # out of the engine, so a reply lost on the wire would lose the only
        # copy of their pages; the last batch is served again until the
        # client's next call acks it (one batch)
        self._ho_seq = 0
        self._ho_last: Optional[tuple] = None
        # the mutation counter: bumped by every mutating RPC and published
        # with the snapshot, so a sync served from a snapshot older than a
        # mutation the client already had acked never reads as idle
        self._mut = 0
        self._closing = False              # graceful: refuse submits
        self._stop = False                 # hard: threads exit
        self._fatal: Optional[str] = None  # an escaped EngineDeadError

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        """Arm the local fault spec, build the engine, bind and serve ->
        the bound port."""
        arm_fault_spec(self.fault_spec)
        self._sup = EngineSupervisor(self._factory, **self._sup_kw)
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        for fn in (self._accept_loop, self._drive_loop):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"agent-{fn.__name__}")
            t.start()
            self._threads.append(t)
        return self.port

    def join(self, timeout: Optional[float] = None) -> None:
        for t in list(self._threads):
            t.join(timeout)

    def stop(self) -> None:
        """Cooperative teardown: threads stop, sockets close, the work in
        flight is abandoned (``shutdown`` over the wire is the graceful
        form)."""
        self._stop = True
        self._close_sockets()
        self.join(timeout=5.0)

    def die(self) -> None:
        """Abrupt death of an in-thread agent: sockets torn down mid-frame,
        threads told to exit, the engine left wherever it was (a spawned
        agent gets the real ``SIGKILL``)."""
        self._stop = True
        self._close_sockets()

    def _close_sockets(self) -> None:
        # shutdown() before close(): a close alone does not wake a thread
        # blocked in accept() or recv() on the socket, and join() would wait
        # out its timeout
        for sock in [self._listener] + list(self._conns):
            if sock is None:
                continue
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- drive thread -----------------------------------------------------
    def _drive_loop(self) -> None:
        while not self._stop:
            with self._lock:
                work = self._sup.has_work() and self._fatal is None
                if work:
                    try:
                        self._sup.step()
                    except Exception as e:
                        # past the restart budget, or a rebuild that failed
                        # (a sticky CUDA error refuses the factory too): the
                        # agent keeps answering, and syncs report DEAD so the
                        # fleet triages through its death path
                        self._fatal = f"{type(e).__name__}: {e}"
                new = self._harvest_locked()
                snap = self._snapshot_locked()
                still = self._sup.has_work()
            with self._buf_lock:
                self._events.extend(
                    (self._next_seq + i, *ev)
                    for i, ev in enumerate(new))
                self._next_seq += len(new)
                self._snap_cache = snap
                done = (self._closing and not self._events
                        and not still)
            if done:
                self._stop = True
                # a graceful exit closes its own listener, or the accept
                # thread blocks on it and the descriptor outlives the agent
                self._close_sockets()
                break
            if not work:
                time.sleep(self.poll_s)

    def _harvest_locked(self) -> List[tuple]:
        """The stream and finished requests as events without sequence
        numbers (the drive loop numbers them under the buffer lock); caller
        holds ``_lock``."""
        out: List[tuple] = []
        for rid, tok in self._sup.drain_stream():
            out.append(("tok", int(rid), int(tok)))
        for req in self._sup.finished():
            d = wire_request(req, self._trace_ids.pop(req.rid, None))
            out.append(("fin", d))
        return out

    # -- accept / RPC threads ---------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                     # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            # reconnect churn must not grow the thread list
            self._threads = [t for t in self._threads
                             if t.is_alive()]
            t = threading.Thread(target=self._handle_conn,
                                 args=(conn,), daemon=True,
                                 name="agent-conn")
            t.start()
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop:
                try:
                    header, blobs, _ = recv_frame(conn)
                except (ProtocolError, TransportError):
                    return   # a cut or garbage frame, or the peer left:
                    #          drop this connection, keep serving
                resp, rblobs = self._dispatch(header, blobs)
                resp["seq"] = header.get("seq")
                try:
                    send_frame(conn, resp, rblobs)
                except TransportError:
                    return   # the peer left mid-reply: the event buffer
                    #          keeps its items for the retry
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if conn in self._conns:
                self._conns.remove(conn)

    def _dispatch(self, header: dict, blobs) -> Tuple[dict, list]:
        op = header.get("op")
        try:
            if op == "sync":
                # the heartbeat never takes the engine lock (see __init__)
                with self._buf_lock:
                    resp, rblobs = self._rpc_sync_buf(header)
            else:
                with self._lock:
                    fn = getattr(self, f"_rpc_{op}", None)
                    if fn is None:
                        raise RuntimeError(f"unknown op {op!r}")
                    resp, rblobs = fn(header, blobs)
            resp.setdefault("ok", True)
            return resp, rblobs
        except Exception as e:
            return ({"ok": False, "etype": type(e).__name__,
                     "error": str(e),
                     "retry_after": getattr(e, "retry_after", None)},
                    [])

    # -- RPC ops (_dispatch holds _lock) ----------------------------------
    def _rpc_hello(self, header, blobs):
        eng = self._sup.engine
        if getattr(eng, "_n_params", None) is None:
            eng._n_params = _count_params(eng.params)
        cache = eng.cache
        return ({"role": self.role, "pid": os.getpid(),
                 "lease_s": self.lease_s,
                 "page": int(cache.page), "B": int(eng.B),
                 # the cost model's constants: the router prices a remote
                 # lane as an in-process one
                 "pages_max": int(cache.pages_max),
                 "num_pages": int(cache.num_pages),
                 "page_bytes": int(cache.page_bytes),
                 "n_params": int(eng._n_params),
                 "mixed": bool(getattr(eng, "_mixed", False)),
                 "caps": {
                     "prefill": hasattr(eng, "take_handoffs"),
                     "decode": hasattr(eng, "admit_handoff")},
                 # the engine's device type, for the chip rate the cost
                 # model assumes (a JAX agent sends none)
                 "device": str(getattr(eng.device, "type", eng.device)),
                 "now": time.monotonic()}, [])

    def _rpc_ping(self, header, blobs):
        return ({"now": time.monotonic(),
                 "state": self._sup.state}, [])

    def _rpc_submit(self, header, blobs):
        if self._closing:
            raise RuntimeError("agent shutting down: not admitting")
        key = header.get("key")
        if key is not None and key in self._by_key:
            # an idempotent resubmission (an ambiguous timeout's retry):
            # the original placement answers, never a second generation
            return ({"rid": self._by_key[key], "dedup": True,
                     "mut": self._mut}, [])
        prompt = np.frombuffer(blobs[0], np.int64).copy()
        rid = self._sup.submit(
            prompt, max_new_tokens=header["max_new_tokens"],
            stop_sequences=header.get("stop_sequences"),
            deadline_s=header.get("deadline_s"),
            spec=header.get("spec"),
            priority=header.get("priority", "normal"),
            tenant=header.get("tenant"))
        self._mut += 1
        self._remember_key_locked(key, rid)
        if header.get("trace_id") is not None:
            self._trace_ids[rid] = header["trace_id"]
        return ({"rid": rid, "mut": self._mut}, [])

    def _rpc_cancel(self, header, blobs):
        out = bool(self._sup.cancel(int(header["rid"])))
        self._mut += 1
        return ({"cancelled": out, "mut": self._mut}, [])

    def _rpc_sync_buf(self, header):
        """The heartbeat and delivery op, served from the buffer side alone
        (caller holds ``_buf_lock``, never ``_lock``).  The snapshot may be
        one step stale; the events are exact and cursor-acked."""
        ack = header.get("ack", -1)
        self._events = [e for e in self._events if e[0] > ack]
        events = [[e[0], e[1], *e[2:]] for e in self._events]
        snap = dict(self._snap_cache)
        snap["events_pending"] = bool(self._events)
        snap["closing"] = self._closing
        return ({"events": events, "snap": snap,
                 "now": time.monotonic()}, [])

    def _rpc_audit(self, header, blobs):
        out = self._sup.engine.cache.audit()
        return ({"audit": {k: int(v) if isinstance(v, (int,
                           np.integer)) else v
                           for k, v in (out or {}).items()}}, [])

    def _rpc_drain(self, header, blobs):
        self._sup.drain()
        self._mut += 1
        return ({"mut": self._mut}, [])

    def _rpc_resume(self, header, blobs):
        self._sup.resume()
        self._mut += 1
        return ({"mut": self._mut}, [])

    def _rpc_shutdown(self, header, blobs):
        if header.get("graceful", True):
            self._closing = True     # the drive loop exits once drained
        else:
            self._stop = True
        return ({}, [])

    def _rpc_take_handoffs(self, header, blobs):
        eng = self._sup.engine
        if not hasattr(eng, "take_handoffs"):
            raise RuntimeError(
                f"role {self.role!r} agent has no handoffs to take")
        if self._ho_last is not None:
            if header.get("ack", -1) >= self._ho_seq:
                self._ho_last = None   # delivered: drop the stash
            else:
                # an unacked batch (its reply was lost): serve it again,
                # these records have left the engine
                resp, rblobs = self._ho_last
                return dict(resp), list(rblobs)
        recs, degraded, out_blobs, deg_blobs = [], [], [], []
        for rec in eng.take_handoffs():
            d = wire_request(
                rec.request, self._trace_ids.pop(rec.request.rid,
                                                 None))
            try:
                k, v, ks, vs, L = rec.materialize()
            except Exception as e:
                # the ship half failed (a kv_handoff fault, a staging
                # flush error): reclaim here; the router degrades the
                # request to a colocated re-prefill, never drops it
                rec.discard()
                meta, blob = pack_array(rec.request.prompt)
                degraded.append({"req": d, "prompt_meta": meta,
                                 "error": f"{type(e).__name__}: {e}"})
                deg_blobs.append(blob)
                continue
            metas, rb = _pack_record(rec.request.prompt, (k, v, ks, vs))
            out_blobs += rb
            recs.append({"req": d, "pages": rec.pages,
                         "nbytes": rec.nbytes, "ctx_len": int(L),
                         "metas": metas})
        self._ho_seq += 1
        resp = {"records": recs, "degraded": degraded,
                "ho_seq": self._ho_seq}
        rblobs = out_blobs + deg_blobs
        if recs or degraded:
            self._ho_last = (resp, rblobs)
        return resp, rblobs

    def _rpc_admit_handoff(self, header, blobs):
        eng = self._sup.engine
        if not hasattr(eng, "admit_handoff"):
            raise RuntimeError(
                f"role {self.role!r} agent cannot adopt a KV handoff")
        key = header.get("key")
        if key is not None and key in self._by_key:
            return ({"rid": self._by_key[key], "dedup": True,
                     "mut": self._mut}, [])
        prompt, k, v, ks, vs = _unpack_record(header["metas"], blobs)
        src = request_from_wire(header["req"], prompt)
        rec = _WireHandoffRecord(src, (k, v, ks, vs,
                                       header["ctx_len"]),
                                 header["pages"], header["nbytes"])
        rid = eng.admit_handoff(rec)
        self._mut += 1
        self._remember_key_locked(key, rid)
        if header["req"].get("trace_id") is not None:
            self._trace_ids[rid] = header["req"]["trace_id"]
        return ({"rid": rid, "mut": self._mut}, [])

    def _rpc_admit_degraded(self, header, blobs):
        eng = self._sup.engine
        if not hasattr(eng, "admit_degraded"):
            raise RuntimeError(
                f"role {self.role!r} agent cannot admit a degraded "
                f"handoff")
        key = header.get("key")
        if key is not None and key in self._by_key:
            return ({"rid": self._by_key[key], "dedup": True,
                     "mut": self._mut}, [])
        prompt = unpack_array(header["prompt_meta"], blobs[0])
        src = request_from_wire(header["req"], prompt)
        rid = eng.admit_degraded(src)
        self._mut += 1
        self._remember_key_locked(key, rid)
        if header["req"].get("trace_id") is not None:
            self._trace_ids[rid] = header["req"]["trace_id"]
        return ({"rid": rid, "mut": self._mut}, [])

    def _remember_key_locked(self, key, rid) -> None:
        """Record an idempotency key, evicting the oldest past
        ``_KEY_CAP`` (caller holds ``_lock``)."""
        if key is None or key in self._by_key:
            return
        self._by_key[key] = rid
        self._key_order.append(key)
        while len(self._key_order) > self._KEY_CAP:
            self._by_key.pop(self._key_order.popleft(), None)

    def _snapshot_locked(self) -> dict:
        """The load, capacity and lifecycle snapshot the handle mirrors
        (caller holds ``_lock``)."""
        sup = self._sup
        eng = sup.engine
        snap = {"active": len(eng._active),
                "queued": len(eng._queue),
                "queued_tokens": eng.queued_tokens(),
                "max_queue_len": eng.max_queue_len,
                "max_queued_tokens": eng.max_queued_tokens,
                "overload_factor": float(getattr(
                    getattr(eng, "policy", None),
                    "overload_factor", 2.0)),
                "has_priorities": bool(getattr(
                    eng, "_has_priorities", False)),
                "retry_after_s": eng.retry_after_s(),
                "decode_steps": eng.decode_steps,
                "tokens_generated": eng.tokens_generated,
                "requests_finished": eng.requests_finished,
                "prefix_hits": int(eng.cache.prefix_hits),
                "restarts": sup.restarts,
                "state": ("DEAD" if self._fatal is not None
                          else sup.state),
                "drained": sup.drained,
                "fatal": self._fatal,
                "mut": self._mut,
                "has_work": sup.has_work()}
        if hasattr(eng, "pending_handoffs"):
            snap["pending_handoffs"] = eng.pending_handoffs()
        if hasattr(eng, "_handoff_ready"):
            snap["handoff_ready"] = len(eng._handoff_ready)
        return snap


# ---------------------------------------------------------------------------
# process spawn
# ---------------------------------------------------------------------------
def _agent_proc_main(spec: dict, q) -> None:
    """Entry point of a spawned agent process: resolve the engine factory
    by import path (a closure over device tensors cannot cross a process
    boundary), build the agent, report the bound port (or the error that
    stopped it) and serve until told to stop, or until ``SIGKILL``."""
    try:
        mod, _, fn = spec["factory"].partition(":")
        factory_fn = getattr(importlib.import_module(mod), fn)
        kwargs = spec.get("factory_kwargs") or {}
        agent = ReplicaAgent(lambda: factory_fn(**kwargs),
                             **(spec.get("agent_kwargs") or {}))
        port = agent.start()
    except Exception as e:
        q.put(("error", f"{type(e).__name__}: {e}"))
        return
    q.put(("ok", port))
    while not agent._stop:
        time.sleep(0.05)


def spawn_agent_process(spec: dict, timeout_s: float = 180.0):
    """Start a :class:`ReplicaAgent` in an OS process of its own
    (``multiprocessing``'s spawn context: a fresh interpreter, which a
    parent holding a CUDA context needs, since a forked child cannot use
    CUDA) -> ``(process, (host, port))``.  ``spec``: ``{"factory":
    "module:function", "factory_kwargs": {...}, "agent_kwargs": {...}}``,
    everything picklable.  A factory that fails (no card, a missing
    weight file) fails the spawn with its error; a child that reports
    nothing within ``timeout_s`` is terminated.  ``os.kill(proc.pid,
    signal.SIGKILL)`` is the real failure mode."""
    import multiprocessing as mp
    import queue as _queue
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_agent_proc_main, args=(spec, q),
                       daemon=True)
    proc.start()
    t_end = time.monotonic() + float(timeout_s)
    while True:
        try:
            status, payload = q.get(timeout=0.2)
            break
        except _queue.Empty:
            pass
        if not proc.is_alive():
            # died before it could report (an import error, a crash):
            # say so now rather than at the timeout
            raise RuntimeError(
                f"agent process {proc.pid} exited with code "
                f"{proc.exitcode} before reporting a port")
        if time.monotonic() >= t_end:
            proc.terminate()
            proc.join(10.0)
            raise RuntimeError(
                f"agent process {proc.pid} did not report a port within "
                f"{timeout_s:.0f}s (factory hung?)")
    if status != "ok":
        proc.join(10.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(10.0)
        raise RuntimeError(f"agent process failed to start: {payload}")
    host = (spec.get("agent_kwargs") or {}).get("host", "127.0.0.1")
    return proc, (host, int(payload))


# ---------------------------------------------------------------------------
# the fleet-side handle
# ---------------------------------------------------------------------------
@dataclass
class RemoteSpec:
    """How a :class:`~paddle_tpu_torch.fleet.FleetRouter` reaches one remote
    replica.  Exactly one of:

    * ``agent``: a zero-argument callable returning an unstarted
      :class:`ReplicaAgent` (in-thread: a real localhost socket, no
      process; ``replace()`` builds a fresh agent from it);
    * ``spawn``: a :func:`spawn_agent_process` spec (an OS process;
      ``replace()`` spawns again);
    * ``connect``: ``(host, port)`` of an agent someone else runs
      (``replace()`` dials the same address again).
    """

    agent: Optional[Callable] = None
    spawn: Optional[dict] = None
    connect: Optional[Tuple[str, int]] = None
    role: Optional[str] = None
    lease_s: float = 2.0
    rpc_timeout_s: float = 5.0
    # engine-touching ops (submit, cancel, hand-off admission, audit, the
    # lifecycle verbs) wait on the agent's engine lock, which a slow step
    # can hold: they get a longer per-attempt budget than the heartbeat.
    # None = max(rpc_timeout_s, 60)
    data_timeout_s: Optional[float] = None
    max_retries: int = 3
    backoff_s: float = 0.01
    heartbeat_s: Optional[float] = None    # default: lease_s / 3
    jitter_seed: int = 0
    is_remote_spec: bool = field(default=True, repr=False)

    def __post_init__(self):
        if sum(x is not None
               for x in (self.agent, self.spawn, self.connect)) != 1:
            raise ValueError(
                "RemoteSpec needs exactly one of agent= (in-thread), "
                "spawn= (process), connect= ((host, port))")


class _Sized:
    """``len()``-only stand-in for a remote engine's containers (the router
    only sizes them)."""

    __slots__ = ("n",)

    def __init__(self, n):
        self.n = int(n or 0)

    def __len__(self) -> int:
        return self.n


class _RemoteCache:
    def __init__(self, h: "RemoteReplicaHandle"):
        self._h = h
        self.page = h.page
        # geometry from the hello: the cost model and the row-capacity
        # guards price a remote lane as an in-process one
        self.pages_max = h.hello.get("pages_max", 1)
        self.num_pages = h.hello.get("num_pages", 2)
        self.page_bytes = h.hello.get("page_bytes", 1)

    @property
    def prefix_hits(self) -> int:
        return int(self._h.snap.get("prefix_hits", 0))

    def audit(self) -> dict:
        """The agent runs the real ``PagedKVCache.audit()`` and ships the
        result: a violated invariant raises there and surfaces here."""
        resp, _ = self._h.conn.call("audit", idempotent=True,
                                    timeout=self._h.data_timeout_s)
        return resp["audit"]


class _RemoteEngine:
    """Snapshot-backed mirror of the engine attributes the router reads (at
    most one fleet tick stale; every verdict that matters is checked again
    on the agent when the RPC lands)."""

    metrics = None                         # no in-process instruments

    def __init__(self, h: "RemoteReplicaHandle"):
        self._h = h
        self.cache = _RemoteCache(h)
        # the cost model's inputs (handoff_wins reads these), from hello
        self._n_params = h.hello.get("n_params") or None
        self._mixed = bool(h.hello.get("mixed", False))
        self.device = h.hello.get("device", "cpu")

    # -- sized containers -------------------------------------------------
    @property
    def _active(self):
        return _Sized(self._h.snap.get("active"))

    @property
    def _queue(self):
        return _Sized(self._h.snap.get("queued"))

    # -- host counters ----------------------------------------------------
    @property
    def B(self) -> int:
        return self._h.B

    @property
    def decode_steps(self) -> int:
        return int(self._h.snap.get("decode_steps", 0))

    @property
    def tokens_generated(self) -> int:
        return int(self._h.snap.get("tokens_generated", 0))

    @property
    def requests_finished(self) -> int:
        return int(self._h.snap.get("requests_finished", 0))

    def queued_tokens(self) -> int:
        return int(self._h.snap.get("queued_tokens", 0))

    def retry_after_s(self) -> float:
        return float(self._h.snap.get("retry_after_s", 1.0))

    def queue_capacity_reason(self, prompt_len: int = 0,
                              factor: float = 1.0,
                              priority: Optional[str] = None,
                              ) -> Optional[str]:
        """The engine's backpressure predicate over the mirrored counters
        (the same arithmetic, at most one tick stale; ``submit()`` checks
        again on the agent, so a stale None costs one steered retry, never
        an over-admission).  A class that is not shed probes against the
        agent's hard bound (``overload_factor`` rides the snapshot)."""
        snap = self._h.snap
        if priority is not None and priority != "low" and \
                (snap.get("has_priorities") or priority != "normal"):
            factor = max(factor,
                         float(snap.get("overload_factor", 2.0)))
        mql = snap.get("max_queue_len")
        if mql is not None and \
                snap.get("queued", 0) >= int(mql * factor):
            return (f"admission queue full: {snap.get('queued')} "
                    f"waiting >= max_queue_len {int(mql * factor)}")
        mqt = snap.get("max_queued_tokens")
        if mqt is not None:
            bound = int(mqt * factor)
            waiting = snap.get("queued_tokens", 0)
            need = max(int(prompt_len), 1)
            if waiting + need > bound:
                return (f"queued tokens {waiting} + prompt {need} "
                        f"> max_queued_tokens {bound}")
        return None


class _RemotePrefillEngine(_RemoteEngine):
    @property
    def _handoff_ready(self):
        return _Sized(self._h.snap.get("handoff_ready"))

    def take_handoffs(self) -> List[_WireHandoffRecord]:
        """Drain the agent's exported records over the wire.  The blocks
        arrive fetched (the ship half, its fault site included, ran on the
        agent); a source-side failure comes back as a poisoned record the
        router degrades to a colocated re-prefill.  Batch-acked: a reply
        lost to a drop is served again on the retry."""
        h = self._h
        resp, blobs = h.conn.call("take_handoffs",
                                  {"ack": h.ho_ack}, idempotent=True,
                                  timeout=h.data_timeout_s)
        h.ho_ack = int(resp.get("ho_seq", h.ho_ack))
        out: List[_WireHandoffRecord] = []
        i = 0
        for rec in resp["records"]:
            n = len(rec["metas"])
            prompt, k, v, ks, vs = _unpack_record(rec["metas"],
                                                  blobs[i:i + n])
            i += n
            req = request_from_wire(rec["req"], prompt)
            out.append(_WireHandoffRecord(
                req, (k, v, ks, vs, rec["ctx_len"]), rec["pages"],
                rec["nbytes"]))
        for d in resp["degraded"]:
            prompt = unpack_array(d["prompt_meta"], blobs[i])
            i += 1
            req = request_from_wire(d["req"], prompt)
            out.append(_WireHandoffRecord(req, None, 0, 0,
                                          poisoned=d["error"]))
        if out:
            h.supervisor.mark_dirty()
        return out


class _RemoteDecodeEngine(_RemoteEngine):
    def pending_handoffs(self) -> int:
        return int(self._h.snap.get("pending_handoffs", 0))

    def admit_handoff(self, rec) -> int:
        """Ship a record's blocks to the agent and adopt them there (the
        restore half of ``kv_handoff`` fires on the agent).  Idempotent:
        keyed on the source rid, a retried frame answers with the original
        decode-side rid."""
        h = self._h
        k, v, ks, vs, L = rec.materialize()
        metas, blobs = _pack_record(rec.request.prompt, (k, v, ks, vs))
        trace_id = None
        if rec.request.trace is not None:
            trace_id = rec.request.trace.trace_id
        header = {"req": wire_request(rec.request, trace_id),
                  "pages": rec.pages, "nbytes": rec.nbytes,
                  "ctx_len": int(L), "metas": metas,
                  "key": f"{h.client_id}:h{rec.request.rid}"}
        resp, _ = h.conn.call("admit_handoff", header, blobs,
                              idempotent=True,
                              timeout=h.data_timeout_s)
        rid = int(resp["rid"])
        h.prompts[rid] = _as_prompt(rec.request.prompt)
        h.note_mut(resp)
        h.supervisor.mark_dirty()
        return rid

    def admit_degraded(self, src: Request) -> int:
        h = self._h
        meta, blob = pack_array(_as_prompt(src.prompt))
        trace_id = src.trace.trace_id if src.trace is not None \
            else None
        header = {"req": wire_request(src, trace_id),
                  "prompt_meta": meta,
                  "key": f"{h.client_id}:d{src.rid}"}
        resp, _ = h.conn.call("admit_degraded", header, [blob],
                              idempotent=True,
                              timeout=h.data_timeout_s)
        rid = int(resp["rid"])
        h.prompts[rid] = _as_prompt(src.prompt)
        h.note_mut(resp)
        h.supervisor.mark_dirty()
        return rid


class _RemoteSupervisor:
    """The handle's supervisor face to the router: submits, cancels and
    the per-tick sync are RPCs, the lifecycle verbs ride the wire, and a
    liveness failure surfaces where the router looks (an exception out of
    ``step()``)."""

    def __init__(self, h: "RemoteReplicaHandle"):
        self._h = h
        self._dirty = False        # an unsynced mutation: sync soon
        self._nsub = 0

    # -- placement --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               stop_sequences=None, deadline_s=None, trace=None,
               fleet_rid=None, spec=None, priority="normal",
               tenant=None) -> int:
        h = self._h
        prompt = np.ascontiguousarray(_as_prompt(prompt))
        self._nsub += 1
        key_part = fleet_rid if fleet_rid is not None \
            else f"s{self._nsub}"
        header = {"max_new_tokens": int(max_new_tokens),
                  "stop_sequences": stop_sequences,
                  "deadline_s": deadline_s,
                  "spec": spec,
                  "priority": priority,
                  "tenant": tenant,
                  "key": f"{h.client_id}:{key_part}",
                  "trace_id": trace.trace_id
                  if trace is not None else None}
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        resp, _ = h.conn.call("submit", header, [prompt.data],
                              idempotent=True, deadline=deadline,
                              timeout=h.data_timeout_s)
        rid = int(resp["rid"])
        h.prompts[rid] = prompt
        h.pending_since_sync += 1
        h.note_mut(resp)
        self._dirty = True
        return rid

    def cancel(self, rid: int) -> bool:
        try:
            resp, _ = self._h.conn.call(
                "cancel", {"rid": int(rid)}, idempotent=True,
                timeout=self._h.data_timeout_s)
        except TransportError:
            # the router keeps its own cancelled mark: if the agent is
            # gone the death triage honours it, if merely degraded the
            # next tick's retry does
            return False
        self._h.note_mut(resp)
        self._dirty = True
        return bool(resp["cancelled"])

    def mark_dirty(self) -> None:
        self._dirty = True

    # -- the fleet tick ---------------------------------------------------
    def step(self) -> int:
        h = self._h
        if faults.active("agent_kill"):
            # chaos: SIGKILL the agent process (or tear down the in-thread
            # one) now; the sync below fails and the lease takes over
            h.hard_kill_agent("agent_kill fault")
        try:
            resp, _ = h.conn.call("sync", {"ack": h.cursor},
                                  idempotent=True)
        except TransportError as e:
            if h.conn.lease_expired():
                raise LeaseExpiredError(
                    f"replica {h.idx} lease expired "
                    f"({h.conn.lease_age():.2f}s since last "
                    f"successful round-trip > lease "
                    f"{h.conn.lease_s:.2f}s): {e}") from e
            # a missed heartbeat, not yet a death: DEGRADED steers routing
            # away while the lease has headroom
            if h.state == "READY":
                h.state = "DEGRADED"
            return int(h.snap.get("active", 0))
        h.apply_sync(resp)
        self._dirty = False
        if not resp["events"] and h.snap.get("has_work"):
            # the agent is computing and nothing new arrived: pace the poll
            time.sleep(0.002)
        if h.snap.get("fatal"):
            # the agent's engine died past its restart budget: the process
            # answers, nothing behind it serves
            raise EngineDeadError(
                f"remote engine dead: {h.snap['fatal']}")
        return int(h.snap.get("active", 0))

    def has_work(self) -> bool:
        h = self._h
        if self._dirty or h.stream_buf or h.finished_buf:
            return True
        if h.mut_sent > h.mut_seen:
            # an acked mutation the synced snapshot predates: the agent has
            # the work even if its (one iteration stale) snapshot cannot
            # show it yet
            return True
        if h.snap.get("has_work") or h.snap.get("events_pending"):
            return True
        # the heartbeat: an idle replica still needs contact, or its lease
        # goes stale without meaning
        return (time.monotonic() - h.last_sync) >= h.heartbeat_s

    def finished(self) -> List[Request]:
        h = self._h
        out, h.finished_buf = h.finished_buf, []
        return out

    def drain_stream(self) -> List:
        h = self._h
        out, h.stream_buf = h.stream_buf, []
        return out

    # -- lifecycle verbs --------------------------------------------------
    def drain(self) -> None:
        resp, _ = self._h.conn.call("drain", idempotent=True,
                                    timeout=self._h.data_timeout_s)
        self._h.note_mut(resp)

    def resume(self) -> None:
        resp, _ = self._h.conn.call("resume", idempotent=True,
                                    timeout=self._h.data_timeout_s)
        self._h.note_mut(resp)

    @property
    def drained(self) -> bool:
        h = self._h
        return (bool(h.snap.get("drained"))
                and h.mut_seen >= h.mut_sent
                and not h.snap.get("events_pending")
                and not h.stream_buf and not h.finished_buf)

    @property
    def restarts(self) -> int:
        return int(self._h.snap.get("restarts", 0))

    @property
    def engine(self):
        return self._h.engine


class RemoteReplicaHandle:
    """Sibling of :class:`~paddle_tpu_torch.fleet.router.ReplicaHandle`
    whose engine lives behind a socket, with the same surface (``state``,
    ``load()``, ``kill()``, ``replace()``, ``drain()``, ``retire()``,
    ``row()``, ``local_rids``), so every router decision applies unchanged.
    Touched only under the router's lock."""

    remote = True
    retiring = False    # scale-down mark (see ReplicaHandle.retiring)

    def __init__(self, idx: int, spec: RemoteSpec, *,
                 role: Optional[str] = None, metrics=None):
        self.idx = idx
        self.spec = spec
        self.role = spec.role or role or "unified"
        self.state = "STARTING"
        self.error: Optional[str] = None
        self.deaths = 0
        self.replaces = 0
        self.drains = 0
        self.slow_ticks = 0
        self.local_rids: Dict[int, int] = {}
        self.transport_metrics = metrics
        # the idempotency namespace: one client id a handle lifetime (a
        # replace() mints another: a rebuilt agent's dedup table is fresh,
        # and a stale key must never alias)
        self.client_id = uuid.uuid4().hex[:12]
        self.heartbeat_s = spec.heartbeat_s \
            if spec.heartbeat_s is not None else spec.lease_s / 3.0
        self.data_timeout_s = spec.data_timeout_s \
            if spec.data_timeout_s is not None \
            else max(spec.rpc_timeout_s, 60.0)
        self.snap: dict = {}
        self.cursor = -1
        self.last_sync = 0.0
        # mutation accounting: ``mut_sent`` is the highest agent mutation
        # counter an acked RPC carried, ``mut_seen`` the last synced
        # snapshot's; until they agree the replica has work by definition
        self.mut_sent = 0
        self.mut_seen = 0
        self.ho_ack = -1           # the take_handoffs batch cursor
        # placements since the last sync (the snapshot cannot see them
        # yet): load() adds them, or a wave would pile onto one replica
        self.pending_since_sync = 0
        self.stream_buf: List = []
        self.finished_buf: List[Request] = []
        self.prompts: Dict[int, np.ndarray] = {}
        self._agent: Optional[ReplicaAgent] = None   # in-thread mode
        self._proc = None                            # process mode
        self.conn: Optional[Connection] = None
        self.hello: dict = {}
        self.page = 0
        self.B = 1
        self.caps: dict = {}
        self._clock_off = 0.0
        self.supervisor = _RemoteSupervisor(self)
        self.engine: _RemoteEngine = _RemoteEngine(self)
        self._spawn_and_connect()
        self.state = "READY"

    # -- connect / spawn --------------------------------------------------
    def _halt_backend(self) -> None:
        """Put down the agent this handle started and forget it (a
        ``connect=`` peer is not ours to stop).  A process is joined: a
        killed agent's device memory comes back only when it is reaped,
        and its replacement may need it."""
        if self._agent is not None:
            self._agent.die()
            self._agent = None
        if self._proc is not None:
            if self._proc.is_alive():
                self._proc.terminate()
            self._proc.join(30.0)
            self._proc = None

    def _spawn_and_connect(self) -> None:
        spec = self.spec
        if spec.agent is not None:
            self._agent = spec.agent()
            port = self._agent.start()
            addr = (self._agent.host, port)
        elif spec.spawn is not None:
            self._proc, addr = spawn_agent_process(spec.spawn)
        else:
            addr = spec.connect
        try:
            conn = open_connection(
                addr, timeout_s=spec.rpc_timeout_s,
                lease_s=spec.lease_s,
                max_retries=spec.max_retries,
                backoff_s=spec.backoff_s,
                jitter_seed=spec.jitter_seed,
                metrics=self.transport_metrics)
            try:
                resp, _ = conn.call("hello", idempotent=True,
                                    timeout=self.data_timeout_s)
            except BaseException:
                conn.close()
                raise
        except BaseException:
            # a failed dial or handshake must not leak the agent it started
            self._halt_backend()
            raise
        self.conn = conn
        self.hello = resp
        self.page = int(resp["page"])
        self.B = int(resp["B"])
        self.caps = resp.get("caps", {})
        self._clock_off = time.monotonic() - resp["now"]
        agent_role = resp.get("role", "unified")
        if agent_role != self.role:
            self.role = agent_role if spec.role is None else self.role
        if self.caps.get("prefill"):
            self.engine = _RemotePrefillEngine(self)
        elif self.caps.get("decode"):
            self.engine = _RemoteDecodeEngine(self)
        else:
            self.engine = _RemoteEngine(self)
        self.snap = {}
        self.cursor = -1
        self.mut_sent = 0
        self.mut_seen = 0
        self.ho_ack = -1
        self.last_sync = time.monotonic()

    def note_mut(self, resp: dict) -> None:
        """Record the agent mutation counter an RPC reply carried."""
        self.mut_sent = max(self.mut_sent, int(resp.get("mut") or 0))

    def set_transport_metrics(self, metrics) -> None:
        self.transport_metrics = metrics
        if self.conn is not None:
            self.conn.metrics = metrics

    # -- sync bookkeeping -------------------------------------------------
    def apply_sync(self, resp: dict) -> None:
        off = time.monotonic() - resp["now"]
        for ev in resp["events"]:
            seq = ev[0]
            if seq <= self.cursor:
                continue               # served again after a lost reply
            self.cursor = seq
            if ev[1] == "tok":
                self.stream_buf.append((int(ev[2]), int(ev[3])))
            else:
                d = ev[2]
                prompt = self.prompts.pop(int(d["rid"]), None)
                if prompt is None:
                    prompt = np.zeros(0, np.int64)
                self.finished_buf.append(request_from_wire(d, prompt))
        self.snap = resp["snap"]
        self.mut_seen = int(self.snap.get("mut") or 0)
        self.last_sync = time.monotonic()
        self.pending_since_sync = 0
        self._clock_off = off
        if self.state == "DEGRADED":
            self.state = "READY"

    # -- router-facing surface -------------------------------------------
    def load(self):
        return (int(self.snap.get("active", 0))
                + int(self.snap.get("queued", 0))
                + self.pending_since_sync,
                int(self.snap.get("queued_tokens", 0)))

    @property
    def admitting(self) -> bool:
        return self.state in ("READY", "DEGRADED")

    def hard_kill_agent(self, why: str) -> None:
        """``SIGKILL`` (process mode) or abrupt teardown (in-thread mode)
        of the agent: no drain, no handshake beyond the kernel's.  The lease
        finds the death; the handle's own state is left alone."""
        if self._proc is not None and self._proc.is_alive():
            try:
                os.kill(self._proc.pid, signal.SIGKILL)
            except OSError:
                pass
        if self._agent is not None:
            self._agent.die()

    def kill(self, error: str) -> None:
        """DEAD after a lease expiry or an escaped failure: the connection
        closes, the agent is put down hard (a half-dead peer must not keep
        generating for clients that failed over) and the rid map clears.
        The router triages the orphans before calling this."""
        self.state = "DEAD"
        self.error = error
        self.deaths += 1
        orphan_rids = list(self.local_rids)
        if self.conn is not None:
            if self.conn.lease_expired():
                self.conn.lease_expire()
            else:
                self.conn.close()
        self.hard_kill_agent(error)
        if (self._agent is None and self._proc is None
                and self.spec.connect is not None and orphan_rids):
            # a peer someone else runs is not ours to kill: cancel its
            # orphans over one short dial instead, so a merely partitioned
            # peer stops generating for clients that failed over
            self._cancel_remote_orphans(orphan_rids)
        self.local_rids.clear()
        self.stream_buf = []
        self.finished_buf = []
        self.prompts.clear()
        self.snap = {}
        self.pending_since_sync = 0
        self.mut_sent = 0
        self.mut_seen = 0
        self.ho_ack = -1

    def _cancel_remote_orphans(self, rids) -> None:
        """Best-effort cancel of an unreachable external agent's orphans:
        one quick dial, one cancel a rid, every failure swallowed."""
        try:
            conn = open_connection(
                self.spec.connect,
                timeout_s=min(1.0, self.spec.rpc_timeout_s),
                max_retries=0)
        except Exception:
            return
        try:
            for rid in rids:
                conn.call("cancel", {"rid": int(rid)},
                          idempotent=True)
        except Exception:
            pass
        finally:
            conn.close()

    def replace(self) -> None:
        """Rebuild: tear down what is left and spawn (or dial) a fresh
        agent.  A failed respawn leaves the handle DEAD with the error
        recorded; ``auto_replace`` retries next tick."""
        self.state = "STARTING"
        self.local_rids.clear()
        self.stream_buf = []
        self.finished_buf = []
        self.prompts.clear()
        self.pending_since_sync = 0
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self._halt_backend()
        if self.spec.connect is None:
            # a rebuilt agent's dedup table is fresh, so the namespace is
            # minted again; a connect-mode replace dials the same agent and
            # keeps the id, so a fleet rid placed again still dedups
            self.client_id = uuid.uuid4().hex[:12]
        try:
            self._spawn_and_connect()
        except Exception as e:
            self.error = (f"replace failed: "
                          f"{type(e).__name__}: {e}")
            self.state = "DEAD"
            return
        self.replaces += 1
        self.error = None
        self.state = "READY"

    def drain(self) -> None:
        try:
            self.supervisor.drain()
        except TransportError:
            pass          # degraded or dead: the tick decides
        self.state = "DRAINING"
        self.drains += 1

    @property
    def drained(self) -> bool:
        return self.state == "DRAINING" and self.supervisor.drained

    def retire(self) -> None:
        """Terminal scale-down: shut the drained agent down, close the
        connection, park in RETIRED (best effort: a retiring replica that
        died first has nothing left to shut)."""
        self.state = "RETIRED"
        self.retiring = False
        try:
            self.shutdown_agent(graceful=True)
        except Exception:
            pass
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None
        self._halt_backend()
        self.local_rids.clear()

    def shutdown_agent(self, graceful: bool = True) -> None:
        """Ask the agent to exit: gracefully (finish the streams in flight,
        wait for the last ack) or at once."""
        self.conn.call("shutdown", {"graceful": graceful},
                       idempotent=True, timeout=self.data_timeout_s)

    def row(self) -> dict:
        """This replica's row of the fleet snapshot (JAX's keys, from the
        last synced snapshot) with its ``transport`` block."""
        eng = self.engine
        active = len(eng._active)
        return {
            "idx": self.idx, "state": self.state, "role": self.role,
            "active": active,
            "queued": len(eng._queue),
            "queued_tokens": eng.queued_tokens(),
            "occupancy": round(active / eng.B, 4),
            "decode_steps": eng.decode_steps,
            "tokens_generated": eng.tokens_generated,
            "requests_finished": eng.requests_finished,
            "prefix_hit_pages": eng.cache.prefix_hits,
            "retry_after_s": round(eng.retry_after_s(), 3),
            "restarts": self.supervisor.restarts,
            "deaths": self.deaths, "replaces": self.replaces,
            "drains": self.drains, "slow_ticks": self.slow_ticks,
            "retiring": self.retiring,
            "error": self.error,
            "transport": self.transport_snapshot()}

    def transport_snapshot(self) -> dict:
        """Per-replica transport health for ``/fleet``."""
        c = self.conn
        out = {"mode": ("thread" if self._agent is not None else
                        "process" if self._proc is not None
                        else "connect"),
               "lease_s": self.spec.lease_s}
        if self._proc is not None:
            out["agent_pid"] = self._proc.pid
        if c is not None:
            out.update(addr=list(c.addr),
                       reconnects=c.reconnects, retries=c.retries,
                       heartbeat_misses=c.heartbeat_misses,
                       frames=c.frames,
                       bytes_sent=c.bytes_sent,
                       bytes_recv=c.bytes_recv,
                       lease_age_s=round(c.lease_age(), 3))
        return out
