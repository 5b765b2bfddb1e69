"""TCP transport for multi-process fleets: framing, RPC, leases.

Counterpart of ``paddle_tpu/fleet/transport.py``, with its wire format byte
for byte, so a port router drives a JAX agent and the reverse.  Frame
format (little-endian, one frame per RPC message)::

    magic   4s   b"PTF1"
    hlen    u32  JSON header length in bytes
    nblobs  u32  number of binary payloads
    blen[]  u64 * nblobs
    header  hlen bytes of UTF-8 JSON (the control header)
    blobs   concatenated raw payloads

The header is the control side (op, seq, rids, trace id, error envelope);
blobs are the data side: KV pages and int8 scale planes ship as their raw
C-contiguous bytes through :func:`pack_array` / :func:`unpack_array`, so a
hand-off round-trips the wire bit for bit.  Arrays are numpy arrays or CPU
tensors; the meta is JAX's ``{"dtype": a.dtype.str, "shape": [...]}``, and
a bfloat16 tensor travels as ``'<V2'`` (what numpy names JAX's
``ml_dtypes.bfloat16``), read back as ``torch.bfloat16``.

:class:`Connection` is the client half (the router side): per-attempt
socket timeouts under an optional absolute deadline; retries with
exponential backoff and seeded jitter for ``idempotent=True`` ops only
(sync and ping carry a cursor, submit an idempotency key); at most
``max_retries`` re-dials a call; a lease clock (``last_ok``) that only a
successful round-trip advances, so a silent peer expires
(:meth:`Connection.lease_expired`).  The fault sites ``conn_drop`` (a
reset mid-RPC), ``frame_truncate`` (a cut frame reaches the peer) and
``net_delay`` (a stalled link trips the timeout) are consulted once a frame
(``paddle_tpu_torch/testing/faults.py``).

Thread safety: ``call()`` and ``close()`` serialize on ``_lock``.
Everything here is stdlib, numpy and torch's CPU tensors.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.serving_engine import QueueFullError
from ..testing import faults

__all__ = ["MAGIC", "TransportError", "ProtocolError", "RpcTimeout",
           "LeaseExpiredError", "RemoteCallError", "send_frame",
           "recv_frame", "pack_array", "unpack_array", "raise_remote",
           "Connection", "open_connection"]

MAGIC = b"PTF1"
_PRE = struct.Struct("<4sII")          # magic, header len, nblobs
_BLEN = struct.Struct("<Q")

# how long an armed ``net_delay`` stalls one frame: above the tight RPC
# timeouts chaos tests use, below anything that slows a suite
NET_DELAY_S = 0.05

# blobs above this many bytes go out as separate buffers (no copy);
# smaller ones coalesce into one send
_COALESCE_MAX = 1 << 16

# numpy's name for a 2-byte bfloat16 (ml_dtypes) array: JAX's frames carry it
BF16_WIRE = "<V2"


class TransportError(RuntimeError):
    """Connection-level failure (reset, refused, injected drop): the op may
    or may not have reached the peer, so it is ambiguous unless the op is
    idempotent."""


class ProtocolError(TransportError):
    """The peer sent bytes that are not a valid frame (bad magic, a
    truncated payload, an oversized header): drop the connection."""


class RpcTimeout(TransportError):
    """The peer did not answer within the deadline (ambiguous, like any
    transport failure)."""


class LeaseExpiredError(TransportError):
    """No successful round-trip for longer than the lease: the peer is dead
    to the fleet (raised by the replica handle, triaged by the router's
    death path)."""


class RemoteCallError(RuntimeError):
    """The peer ran the op and reported an error of a type other than the
    canonical ones (``QueueFullError``, ``ValueError``, ``RuntimeError``
    raise as themselves)."""


def pack_array(a) -> Tuple[dict, object]:
    """``(meta, buffer)`` for one optional numpy array or CPU tensor: its
    raw C-contiguous bytes and the dtype and shape that rebuild it bit for
    bit.  ``None`` (an fp pool's absent scale plane) packs as an empty
    buffer with ``{"none": true}``."""
    if a is None:
        return {"none": True}, b""
    if torch.is_tensor(a):
        t = a.detach().contiguous()
        if t.device.type != "cpu":
            raise ValueError(
                f"pack_array takes host arrays; got a tensor on {t.device}")
        if t.dtype == torch.bfloat16:
            return ({"dtype": BF16_WIRE, "shape": list(t.shape)},
                    t.view(torch.int16).numpy().data)
        a = t.numpy()
    a = np.ascontiguousarray(a)
    meta = {"dtype": a.dtype.str, "shape": list(a.shape)}
    if a.dtype.str == BF16_WIRE:
        # an ml_dtypes bfloat16 array: numpy's buffer protocol refuses
        # to export it (JAX's pack_array raises here), its bytes do not
        return meta, a.tobytes()
    return meta, a.data


def unpack_array(meta: dict, buf) -> Optional[torch.Tensor]:
    """Inverse of :func:`pack_array` -> a CPU tensor; ``'<V2'`` reads as
    ``torch.bfloat16``.  A writable buffer (a blob :func:`recv_frame`
    received into a fresh buffer of its own) is viewed, not copied; a
    read-only one is copied."""
    if meta.get("none"):
        return None
    shape = [int(n) for n in meta["shape"]]
    bf16 = meta["dtype"] == BF16_WIRE
    a = np.frombuffer(buf, dtype=np.int16 if bf16
                      else np.dtype(meta["dtype"])).reshape(shape)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def send_frame(sock: socket.socket, header: dict,
               blobs: Sequence = ()) -> int:
    """Serialize and send one frame -> bytes written.  Raises
    :class:`TransportError` on a failed send."""
    hbytes = json.dumps(header).encode()
    # byte views: a typed memoryview (an int64 array's .data) answers
    # len() in elements, which would corrupt the frame
    blobs = [memoryview(b).cast("B") if not isinstance(b, bytes)
             else b for b in blobs]
    pre = _PRE.pack(MAGIC, len(hbytes), len(blobs))
    lens = b"".join(_BLEN.pack(len(b)) for b in blobs)
    head = pre + lens + hbytes
    total = len(head) + sum(len(b) for b in blobs)
    try:
        # small blobs coalesce with the head into one send; big ones flush
        # what is pending and go out on their own without a join
        pend = [head]
        for b in blobs:
            if len(b) > _COALESCE_MAX:
                if pend:
                    sock.sendall(b"".join(pend))
                    pend = []
                sock.sendall(b)
            elif len(b):
                pend.append(bytes(b))
        if pend:
            sock.sendall(b"".join(pend))
    except OSError as e:
        raise TransportError(f"send failed: {e}") from e
    return total


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError as e:
            raise TransportError(f"recv failed: {e}") from e
        if k == 0:
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        got += k
    return view


def recv_frame(sock: socket.socket,
               max_header: int = 1 << 24) -> Tuple[dict, list, int]:
    """Receive one frame -> ``(header, blobs, bytes_read)``.  Bad magic or
    truncation raise :class:`ProtocolError`: the caller drops the
    connection (no guess at a resync point)."""
    pre = _recv_exact(sock, _PRE.size)
    magic, hlen, nblobs = _PRE.unpack(pre)
    if magic != MAGIC:
        raise ProtocolError(
            f"bad frame magic {bytes(magic)!r} (wire-protocol "
            f"mismatch or stream corruption)")
    if hlen > max_header or nblobs > 4096:
        raise ProtocolError(
            f"unreasonable frame: header {hlen} bytes, "
            f"{nblobs} blobs")
    lens = [_BLEN.unpack(_recv_exact(sock, _BLEN.size))[0]
            for _ in range(nblobs)]
    total = _PRE.size + _BLEN.size * nblobs + hlen + sum(lens)
    try:
        header = json.loads(bytes(_recv_exact(sock, hlen)))
    except ValueError as e:
        raise ProtocolError(f"undecodable frame header: {e}") from e
    blobs = [_recv_exact(sock, n) for n in lens]
    return header, blobs, total


# application errors the agent maps to canonical types, so the router's
# routing and backpressure decisions survive the wire
_ETYPES = {"QueueFullError": None,     # rebuilt with retry_after below
           "ValueError": ValueError,
           "RuntimeError": RuntimeError}


def raise_remote(header: dict) -> None:
    """Raise the error envelope of a response header (no-op when ok)."""
    if header.get("ok", True):
        return
    etype = header.get("etype", "")
    msg = header.get("error", "remote error")
    if etype == "QueueFullError":
        raise QueueFullError(msg,
                             retry_after=header.get("retry_after", 1.0))
    exc = _ETYPES.get(etype)
    if exc is not None:
        raise exc(msg)
    raise RemoteCallError(f"{etype}: {msg}")


class Connection:
    """One client connection to a
    :class:`~paddle_tpu_torch.fleet.remote.ReplicaAgent`, with retries,
    reconnects and lease accounting.  Built through
    :func:`open_connection`; whoever opens one closes it (:meth:`close`)
    or hands it to an owner that will, exception paths included."""

    def __init__(self, addr: Tuple[str, int], *,
                 timeout_s: float = 5.0, lease_s: float = 2.0,
                 max_retries: int = 3, backoff_s: float = 0.01,
                 jitter_seed: int = 0, metrics=None):
        self.addr = tuple(addr)
        self.timeout_s = float(timeout_s)
        self.lease_s = float(lease_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._closed = False
        self._dialed = False           # the first dial is not a reconnect
        # the lease clock: the monotonic instant of the last successful
        # round-trip (a send that got no answer never advances it)
        self.last_ok = time.monotonic()
        self.reconnects = 0
        self.retries = 0
        self.heartbeat_misses = 0
        self.frames = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        # a private seeded jitter stream: a chaos schedule replays the same
        # backoff sequence run to run
        self._rng = random.Random(jitter_seed)

    # -- lease ------------------------------------------------------------
    def lease_age(self) -> float:
        return time.monotonic() - self.last_ok

    def lease_expired(self) -> bool:
        """True once no RPC has succeeded for a whole lease term.  Read it
        after a failed attempt only: an idle, healthy peer is unpolled, not
        expired (the replica handle heartbeats on the fleet tick)."""
        return self.lease_age() > self.lease_s

    def lease_expire(self) -> None:
        """The expired lease's release: drop the socket and close (the
        abnormal counterpart of :meth:`close`)."""
        with self._lock:
            self._drop_locked()
            self._closed = True

    # -- rpc --------------------------------------------------------------
    def call(self, op: str, header: Optional[dict] = None,
             blobs: Sequence = (), *, idempotent: bool = False,
             timeout: Optional[float] = None,
             deadline: Optional[float] = None) -> Tuple[dict, list]:
        """One request / response RPC.  ``idempotent=True`` ops retry
        through reconnects with exponential backoff and seeded jitter;
        others raise at the first transport failure (the outcome is
        ambiguous and only the caller knows whether a replay is safe).
        ``deadline`` (absolute monotonic) caps the whole call, backoff
        sleeps included."""
        req = dict(header or ())
        attempts = (self.max_retries + 1) if idempotent else 1
        last: Optional[Exception] = None
        with self._lock:
            if self._closed:
                raise TransportError(
                    f"connection to {self.addr} closed")
            req["op"] = op
            self._seq += 1
            req["seq"] = self._seq
            for attempt in range(attempts):
                if attempt:
                    self.retries += 1
                    if self.metrics is not None:
                        self.metrics.retries.inc()
                    pause = (self.backoff_s * (2 ** (attempt - 1))
                             * (1.0 + self._rng.random()))
                    if deadline is not None and \
                            time.monotonic() + pause >= deadline:
                        break
                    time.sleep(pause)
                try:
                    return self._call_once_locked(req, blobs, timeout,
                                                  deadline)
                except (TransportError, OSError,
                        socket.timeout) as e:
                    last = e
                    self.heartbeat_misses += 1
                    if self.metrics is not None:
                        self.metrics.heartbeat_misses.inc()
                    self._drop_locked()
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        break
        if isinstance(last, socket.timeout):
            raise RpcTimeout(
                f"{op} to {self.addr} timed out after "
                f"{attempts} attempt(s)") from last
        raise TransportError(
            f"{op} to {self.addr} failed after {attempts} "
            f"attempt(s): {type(last).__name__}: {last}") from last

    # -- locked internals (caller holds _lock) ----------------------------
    def _call_once_locked(self, req: dict, blobs,
                          timeout: Optional[float],
                          deadline: Optional[float]) -> Tuple[dict, list]:
        sock = self._ensure_locked()
        per = self.timeout_s if timeout is None else float(timeout)
        if deadline is not None:
            per = min(per, max(deadline - time.monotonic(), 1e-3))
        sock.settimeout(per)
        t0 = time.perf_counter()
        if faults.active("net_delay"):
            # a stalled link: the stall takes the attempt's timeout budget,
            # so a timeout tighter than NET_DELAY_S trips every time (a
            # generous one just runs late)
            time.sleep(min(NET_DELAY_S, per))
            if per <= NET_DELAY_S:
                raise socket.timeout(
                    f"injected net_delay: link stalled past the "
                    f"{per:.3f}s attempt timeout")
        try:
            faults.fire("conn_drop")
        except Exception as e:
            self._drop_locked()
            raise TransportError(f"injected conn_drop: {e}") from e
        if faults.active("frame_truncate"):
            # a cut frame, so the peer runs its ProtocolError path; then
            # our side drops
            self._send_truncated_locked(sock, req, blobs)
            raise TransportError("injected frame_truncate")
        n = send_frame(sock, req, blobs)
        self.bytes_sent += n
        resp, rblobs, m = recv_frame(sock)
        self.bytes_recv += m
        self.frames += 1
        if resp.get("seq") != req["seq"]:
            raise ProtocolError(
                f"response seq {resp.get('seq')} != request seq "
                f"{req['seq']} (desynchronized stream)")
        self.last_ok = time.monotonic()
        if self.metrics is not None:
            self.metrics.frames.inc()
            self.metrics.bytes.inc(n + m)
            self.metrics.rtt_seconds.observe(time.perf_counter() - t0)
        raise_remote(resp)
        return resp, rblobs

    def _send_truncated_locked(self, sock, req: dict, blobs) -> None:
        hbytes = json.dumps(req).encode()
        pre = _PRE.pack(MAGIC, len(hbytes), len(blobs))
        lens = b"".join(_BLEN.pack(len(b)) for b in blobs)
        frame = pre + lens + hbytes
        try:
            sock.sendall(frame[:max(len(frame) // 2, 1)])
        except OSError:
            pass
        self._drop_locked()

    def _ensure_locked(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    self.addr, timeout=self.timeout_s)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
            except OSError as e:
                raise TransportError(
                    f"connect to {self.addr} failed: {e}") from e
            if self._dialed:
                self.reconnects += 1
                if self.metrics is not None:
                    self.metrics.reconnects.inc()
            self._dialed = True
        return self._sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_locked()
            self._closed = True


def open_connection(addr: Tuple[str, int], **kw) -> Connection:
    """A client connection; the caller owns it until :meth:`Connection.
    close` or :meth:`Connection.lease_expire`, exception paths included."""
    return Connection(addr, **kw)
