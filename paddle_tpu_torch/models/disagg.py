"""Disaggregated prefill / decode serving: the compute-bound and the
memory-bound phase on separate engines, with a pipelined KV hand-off.

Counterpart of ``paddle_tpu/models/disagg.py``.  On a unified engine every
admission wave, a compute-bound packed prefill over the waiting prompts,
runs on the device the decode loop runs on, so each wave stalls the decode
steps and inflates TPOT p99 when load is highest.  Disaggregation splits
the two:

* :class:`PrefillEngine`: a
  :class:`~paddle_tpu_torch.models.serving_engine.ContinuousBatchingEngine`
  whose "decode" is an export.  Its admission waves run as on a unified
  engine (the packed varlen lane by default, one dispatch a wave, the
  chunked and batched lanes and prefix caching included) and sample each
  context's first token; then every row the wave filled is staged through
  the host tier (``PagedKVCache.export_row``: the gather on the compute
  stream, the device -> host copy on the host tier's side stream) and
  leaves as a :class:`HandoffRecord` instead of decoding.
* :class:`DecodeEngine`: an engine that admits hand-offs through
  ``_admit_swapped`` only.  A record adopts into its cache's host tier
  (``PagedKVCache.adopt_swap``) and its admission is one batched restore
  with zero prefill tokens, the path a preemption's swap-in resume takes.
  Hand-off traffic never runs a prefill dispatch here; colocated requests
  (short prompts, degraded hand-offs) prefill as on any engine.
* :class:`DisaggCoordinator`: the in-process 1P+1D pipeline, driven like an
  engine (``submit`` / ``step`` / ``finished`` / ``drain_stream`` /
  ``cancel``).  It ships wave *k*'s records one tick after their export,
  after wave *k + 1*'s prefill and a decode step have been dispatched over
  the staged copies, bounds the hand-offs in flight (a full pipeline
  stalls prefill admission) and routes each request by the bytes-against-
  FLOPs cost model :func:`handoff_wins`: a prompt whose prefill stall
  costs less than moving its pages stays colocated on the decode engine.
  The fleet form, N prefill and M decode replicas, is
  :class:`~paddle_tpu_torch.fleet.FleetRouter` with ``roles=``.

Degradation: a ``kv_handoff`` fault at the ship half (the record's
materialisation) or the restore half (the decode-side adopt), or a
receiving host tier without room, degrades the request to a colocated
re-prefill on the decode engine that keeps the first token already
sampled; a dead prefill engine's untaken records give their staging pages
back through ``release_extra_claims``; an ``EngineSupervisor`` rebuild of a
decode engine re-adopts the hand-offs it held through ``transplant_extra``.

Both engines run on one device in the in-process form: the hand-off moves
the pages through the host tier's pinned buffers (device -> host on the
prefill cache's side stream, host -> device in the decode cache's batched
restore).  No kernel of its own: the engines' paths run the paged decode
and varlen prefill kernels.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability import (DisaggMetrics, MetricsRegistry, advance_phase,
                             finalize_request_trace, phase_clocks)
from ..testing import faults
from .paged_decode import PagedKVCache
from .serving_engine import (ContinuousBatchingEngine, QueueFullError,
                             Request, _chip_flops_default, _count_params,
                             _drive_to_completion, _finalize_trace)

__all__ = ["DisaggCoordinator", "DecodeEngine", "HandoffRecord",
           "PrefillEngine", "handoff_flip_gbps", "handoff_wins"]


@dataclass
class HandoffRecord:
    """One finished prefill context in flight to a decode engine: the
    request (its sampled first token in ``generated``), the source cache
    whose host tier holds the staged pages, and the export state.
    :meth:`materialize` is the ship half of the ``kv_handoff`` fault site;
    the restore half fires in :meth:`DecodeEngine.admit_handoff`."""

    request: Request
    cache: PagedKVCache               # the source cache (its staging tier)
    export: dict
    pages: int
    nbytes: int
    blobs: Optional[tuple] = None     # (k, v, ks, vs, L) once fetched

    def materialize(self) -> tuple:
        """The shipped pages as host blocks (CPU tensors, page-major).
        Idempotent: a retry after decode-side backpressure reuses the
        fetched blocks (the staging pages were freed at the first
        fetch)."""
        if self.blobs is None:
            faults.fire("kv_handoff")          # the ship half
            self.blobs = self.cache.export_fetch(self.export)
        return self.blobs

    def discard(self) -> None:
        """Reclaim the record without shipping it (cancel, expiry, degrade,
        death): its staging pages free.  Idempotent."""
        if self.blobs is None:
            self.cache.export_discard(self.export)
        self.blobs = None


def handoff_wins(prompt_len: int, decode_engine, gbps: float,
                 chip_flops: Optional[float] = None) -> bool:
    """The bytes-against-FLOPs cost model applied to admission:
    disaggregate when the prefill stall the decode device would pay (one
    forward over the context, 2 * N_params FLOPs a token at the chip's
    rate) exceeds the hand-off's copies (ship and restore, twice the
    context's page bytes at ``gbps``).  The chip rate and parameter count
    come from the helpers the preemption cost model uses
    (``serving_engine._chip_flops_default`` of the decode engine's device,
    ``_count_params``).  A decode engine built with ``mixed=True`` pays no
    admission stall, so every request stays colocated."""
    return gbps > handoff_flip_gbps(prompt_len, decode_engine, chip_flops)


def handoff_flip_gbps(prompt_len: int, decode_engine,
                      chip_flops: Optional[float] = None) -> float:
    """The link speed at which :func:`handoff_wins` flips for this prompt
    length: strictly above it, disaggregation wins.  ``inf`` for an empty
    prompt and for a mixed-lane decode engine (no stall to delete)."""
    if prompt_len <= 0:
        return float("inf")
    if getattr(decode_engine, "_mixed", False):
        return float("inf")
    cache = decode_engine.cache
    npg = (int(prompt_len) + cache.page - 1) // cache.page
    if decode_engine._n_params is None:
        decode_engine._n_params = _count_params(decode_engine.params)
    chip = chip_flops if chip_flops is not None \
        else _chip_flops_default(decode_engine.device)
    # solve prefill_s > handoff_s for gbps:
    #   2 * N * L / chip  >  2 * npg * page_bytes / (gbps * 1e9)
    return (npg * cache.page_bytes * chip
            / (decode_engine._n_params * prompt_len * 1e9))


class PrefillEngine(ContinuousBatchingEngine):
    """The compute-bound half of a disaggregated pair: admission waves run
    as on a unified engine, but instead of decoding, every row a wave
    filled exports (its pages staged to the host tier) and its request
    (first token sampled) waits in a :class:`HandoffRecord` for
    :meth:`take_handoffs`.  ``decode_steps`` stays 0.

    ``max_inflight_handoffs`` bounds the records waiting to be taken plus
    whatever the owning coordinator reports in flight (``handoff_backlog``,
    a seam the coordinator points at its pipeline-wide count): a full
    pipeline stalls admission (queued requests wait, ``submit()``'s bounded
    queue pushes back), it never drops work.

    ``overlap=True``, ``mixed=True`` and ``decode_horizon > 1`` are
    refused: there is no decode loop to overlap, no decode row to
    piggyback on and no decode cadence to fuse."""

    def __init__(self, *args, max_inflight_handoffs: int = 8, **kw):
        if kw.get("overlap"):
            raise ValueError(
                "PrefillEngine has no decode loop to overlap "
                "(overlap=True applies to the DecodeEngine of a "
                "disaggregated pair)")
        if kw.get("mixed"):
            raise ValueError(
                "PrefillEngine has no decode rows to piggyback on "
                "(mixed=True deletes the stall a COLOCATED engine pays; a "
                "disaggregated prefill engine has no stall to delete — see "
                "handoff_wins)")
        if int(kw.get("decode_horizon", 1) or 1) > 1:
            raise ValueError(
                "PrefillEngine has no decode cadence to fuse "
                "(decode_horizon amortizes per-token decode dispatches; "
                "set it on the DecodeEngine of a disaggregated pair, or on "
                "a colocated engine)")
        super().__init__(*args, **kw)
        self.max_inflight_handoffs = int(max_inflight_handoffs)
        self._handoff_ready: List[HandoffRecord] = []
        # the coordinator re-points this at its pipeline-wide in-flight
        # count, so the bound covers shipped, not yet admitted records
        # too; consulted only under the coordinator's or router's lock
        self.handoff_backlog: Callable[[], int] = \
            lambda: len(self._handoff_ready)
        self.handoffs_exported = 0
        self.admission_stalls = 0         # waves deferred by the bound

    def _collect_admissions(self):
        backlog = self.handoff_backlog()
        room = self.max_inflight_handoffs - backlog
        if room <= 0:
            self.admission_stalls += 1
            return [], []
        admits, swap_ins = super()._collect_admissions()
        # trim the wave to the pipeline's room: the excess goes back to
        # the front of the queue in FIFO order
        while len(admits) + len(swap_ins) > room and admits:
            req, _ = admits.pop()
            self._queue.appendleft(req)
        return admits, swap_ins

    def _decode_once(self) -> None:
        """Export every row the wave filled, in admission order."""
        for slot in sorted(list(self._active),
                           key=lambda s: self._active[s].admit_seq):
            req = self._active.pop(slot)
            state = self.cache.export_row(slot)
            self._release_aux(slot)
            self._free_slots.append(slot)
            self._remaining[slot] = 0
            self._active_mask[slot] = 0
            req.slot = None
            rec = HandoffRecord(
                request=req, cache=self.cache, export=state,
                pages=state["pages"],
                nbytes=state["pages"] * self.cache.page_bytes)
            # the request leaves this engine: its clocks and its trace ride
            # the record to the decode side (one trace across both)
            advance_phase(req, "handoff_inflight")
            if req.trace is not None:
                req.trace.event("handoff_export", rid=req.rid,
                                pages=rec.pages)
            self._handoff_ready.append(rec)
            self.handoffs_exported += 1
            if self.metrics is not None:
                self.metrics.ring.emit(
                    "kv_handoff_export", rid=req.rid, pages=rec.pages,
                    ctx_len=state["lens"])

    def has_work(self) -> bool:
        # exported, untaken records are work: the coordinator keeps
        # ticking (and a draining supervisor does not report drained) until
        # they are taken
        return bool(self._handoff_ready) or super().has_work()

    def take_handoffs(self) -> List[HandoffRecord]:
        """Drain the exported records; the caller owns them from here
        (ship, degrade or discard)."""
        out, self._handoff_ready = self._handoff_ready, []
        return out

    def release_extra_claims(self) -> None:
        """Give back every untaken record's staging pages (called through
        ``_release_engine_claims`` when this engine dies or is rebuilt).
        The list survives for :meth:`transplant_extra` to fail the
        requests loudly."""
        for rec in self._handoff_ready:
            try:
                rec.discard()
            except Exception:
                pass

    def transplant_extra(self, old) -> None:
        """Supervisor-rebuild hook: requests the dead engine exported but
        nobody took end with an error (their pages died with the claims
        release), never dropped silently."""
        if not isinstance(old, PrefillEngine):
            return
        for rec in old._handoff_ready:
            req = rec.request
            if req.done:
                continue
            req.done, req.status = True, "error"
            req.error = old.last_fault or \
                "prefill engine restarted mid-handoff"
            req.t_finish = time.monotonic()
            self._count_abnormal(req, "error")
            _finalize_trace(req)
            self._finished.append(req)
        old._handoff_ready = []


class DecodeEngine(ContinuousBatchingEngine):
    """The memory-bound half of a disaggregated pair: hand-off records
    adopt into the cache's host tier and admit through ``_admit_swapped``
    (one batched restore, zero prefill tokens, never a prefill dispatch for
    hand-off traffic).  Colocated requests (short prompts the cost model
    keeps here, degraded hand-offs) ``submit()`` and prefill as on any
    engine.

    Needs a host tier (``PagedKVCache(host_pages=N)``): adopted records
    park there until their restore.  ``mixed=True`` is refused."""

    def __init__(self, *args, **kw):
        if kw.get("mixed"):
            raise ValueError(
                "mixed=True on a DecodeEngine is unsupported: its admission "
                "overrides (_handoff_first single-emission, adopted-blob "
                "bookkeeping) do not compose with the mixed lane's "
                "in-program first-token sampling.  Run the UNIFIED engine "
                "with mixed=True instead — the cost model (handoff_wins) "
                "then keeps traffic colocated, which is the point")
        super().__init__(*args, **kw)
        if self.cache.host is None:
            raise ValueError(
                "DecodeEngine needs a host page tier "
                "(PagedKVCache(host_pages=N)): handoff records adopt there "
                "until their batched restore")
        # adopted, not yet admitted hand-offs: rid -> host blocks, kept
        # until admission so a supervisor rebuild can re-adopt them
        self._handoff_blobs: Dict[int, tuple] = {}
        # rids whose first token (sampled on the prefill side) streams at
        # this engine's admission: a client sees token 1 exactly once,
        # whichever path admits
        self._handoff_first: set = set()
        self.handoff_admits = 0
        self.colocated_fallbacks = 0      # restores degraded to prefill

    def _import_request(self, src: Request) -> Request:
        """A decode-side Request mirroring the prefill side's: a fresh
        local rid, the lifecycle timestamps carried over (TTFT and the
        queue wait were observed on the prefill side), the absolute
        deadline, class, tenant and speculative toggle kept.  Validated
        against this cache's row capacity (hand-offs bypass ``submit()``,
        and a request this pool can never hold would wedge the queue's
        head)."""
        row_cap = min(self.cache.pages_max,
                      self.cache.num_pages - 1) * self.cache.page
        worst = len(src.prompt) + src.max_new_tokens
        if worst > row_cap:
            raise ValueError(
                f"handoff request needs up to {worst} cache slots (prompt "
                f"{len(src.prompt)} + max_new_tokens {src.max_new_tokens}) "
                f"> decode-side row capacity {row_cap} — source and "
                f"destination cache geometries disagree")
        req = Request(self._next_rid, src.prompt, src.max_new_tokens,
                      generated=list(src.generated),
                      stop_sequences=src.stop_sequences,
                      t_submit=src.t_submit or time.monotonic(),
                      t_admit=src.t_admit,
                      t_first_token=src.t_first_token,
                      deadline=src.deadline, spec=src.spec,
                      priority=src.priority, tenant=src.tenant,
                      degraded=src.degraded)
        # the decode-side request continues the trace and phase clocks of
        # the prefill side: /trace/<rid> shows one tree
        req.trace = src.trace
        req.phase = src.phase
        req.t_phase = src.t_phase or req.t_submit
        req.phase_log = list(src.phase_log)
        self._next_rid += 1
        if req.deadline:
            self._has_deadlines = True
        if req.priority != "normal":
            self._has_priorities = True
        return req

    def admit_handoff(self, rec: HandoffRecord) -> int:
        """The restore half of a hand-off: adopt the record into the host
        tier and queue its request for ``_admit_swapped`` (zero prefill
        tokens) -> the decode-local rid.  Raises :class:`QueueFullError`
        when the bounded queue refuses (the caller retries next tick, the
        blocks kept) and ``RuntimeError`` when the host tier cannot hold
        the pages or the ``kv_handoff`` fault fires (the caller degrades
        through :meth:`admit_degraded`)."""
        src = rec.request
        why = self.queue_capacity_reason(len(src.prompt))
        if why is not None:
            # not _reject(): a retry is a routing event, not a 429 a client
            # saw
            raise QueueFullError(why, retry_after=self.retry_after_s())
        # validate and import before claiming the host tier: a refused
        # import must not orphan an adopted record
        req = self._import_request(src)
        blobs = rec.materialize()
        faults.fire("kv_handoff")              # the restore half
        handle = self.cache.adopt_swap(*blobs)
        self._swap_handles[req.rid] = handle
        self._handoff_blobs[req.rid] = blobs
        self._handoff_first.add(req.rid)
        self._queue.append(req)
        self.handoff_admits += 1
        if self.metrics is not None:
            self.metrics.ring.emit("kv_handoff_adopt", rid=req.rid,
                                   pages=rec.pages)
        return req.rid

    def admit_degraded(self, src: Request) -> int:
        """The colocated fallback of a failed hand-off: queue the request
        for an ordinary re-prefill here.  The first token the prefill side
        sampled stays in ``generated``: admission resumes at it without
        sampling again and streams it once; a request that never reached a
        first token prefills fresh."""
        why = self.queue_capacity_reason(len(src.prompt))
        if why is not None:
            raise QueueFullError(why, retry_after=self.retry_after_s())
        req = self._import_request(src)
        if req.generated:
            self._handoff_first.add(req.rid)
        self._queue.append(req)
        self.colocated_fallbacks += 1
        if self.metrics is not None:
            self.metrics.ring.emit("kv_handoff_degraded", rid=req.rid)
        return req.rid

    def pending_handoffs(self) -> int:
        """Adopted, not yet admitted hand-offs (counted in flight)."""
        return len(self._handoff_blobs)

    def _finish_admit(self, req: Request, slot: int, tok: int) -> None:
        if req.rid in self._handoff_first:
            # the hand-off window closes here: the prefill side's first
            # token streams once the decode side owns the request
            self._handoff_first.discard(req.rid)
            self._handoff_blobs.pop(req.rid, None)
            self._stream.append((req.rid, tok))
        super()._finish_admit(req, slot, tok)

    def _admit_swapped(self, req: Request) -> bool:
        ok = super()._admit_swapped(req)
        if not ok and req.rid in self._handoff_blobs:
            # the device pool could not take the restore: the request is
            # requeued for a recompute admission, a colocated re-prefill
            self._handoff_blobs.pop(req.rid, None)
            self.colocated_fallbacks += 1
        return ok

    def _finish_queued_abnormal(self, req: Request, status: str,
                                error: Optional[str] = None) -> None:
        self._handoff_blobs.pop(req.rid, None)
        self._handoff_first.discard(req.rid)
        super()._finish_queued_abnormal(req, status, error)

    def transplant_extra(self, old) -> None:
        """Supervisor-rebuild hook: re-adopt every hand-off the dead engine
        held for a transplanted, still queued request into the rebuilt
        cache (else it would re-prefill instead of restoring).  A record
        the new host tier cannot hold degrades to a recompute admission."""
        if not isinstance(old, DecodeEngine):
            return
        queued = {r.rid for r in self._queue}
        for rid, blobs in old._handoff_blobs.items():
            if rid not in queued:
                continue
            try:
                handle = self.cache.adopt_swap(*blobs)
            except RuntimeError:
                self.colocated_fallbacks += 1
                continue
            self._swap_handles[rid] = handle
            self._handoff_blobs[rid] = blobs
        self._handoff_first |= (old._handoff_first & queued)
        old._handoff_blobs = {}
        old._handoff_first = set()


@dataclass
class _DisaggRequest:
    """The coordinator's record of one accepted request: which engine (or
    the hand-off queue) owns it now."""
    rid: int                          # coordinator rid (the client's)
    prompt: np.ndarray
    max_new_tokens: int
    stop_sequences: Optional[list]
    deadline: float                   # absolute monotonic; 0.0 = none
    t_submit: float
    where: str = "decode"             # "prefill" | "handoff" | "decode"
    local: int = -1                   # engine-local rid (when owned)
    cancelled: bool = False
    trace: Optional[object] = None    # the coordinator's TraceContext


class DisaggCoordinator:
    """In-process 1P+1D disaggregated serving, driven like an engine
    (``submit`` / ``step`` / ``finished`` / ``drain_stream`` / ``cancel``),
    so ``GenerationServer`` serves it unchanged.

    One :meth:`step` is one pipeline tick::

        1. SHIP wave k        (records taken last tick: the staging flush
                               commits copies that rode under the
                               dispatches since; the decode engine adopts)
        2. PREFILL wave k+1   (one packed dispatch; its exports stage)
        3. TAKE wave k+1      (records queue for next tick's ship)
        4. DECODE             (restores wave k, one batched restore a row,
                               then one decode round)

    The hand-offs in flight (exported + awaiting ship + adopted, not yet
    admitted) are bounded by the prefill engine's
    ``max_inflight_handoffs``: a full pipeline stalls prefill admission.

    Routing: :func:`handoff_wins` (``handoff_gbps``,
    ``handoff_chip_flops``) decides each request;
    ``force_route="prefill" | "colocated"`` pins it.  Decisions, hand-offs
    and fallbacks are counters (``routed``, ``handoffs_shipped``,
    ``colocated_fallbacks``), also in :class:`DisaggMetrics`.

    Every public method takes ``_lock``; the engines are touched only under
    it."""

    def __init__(self, prefill_engine: PrefillEngine,
                 decode_engine: DecodeEngine, *,
                 handoff_gbps: float = 10.0,
                 handoff_chip_flops: Optional[float] = None,
                 force_route: Optional[str] = None,
                 metrics_registry=None, metrics_ring=None,
                 tracer=None):
        if not hasattr(prefill_engine, "take_handoffs"):
            raise ValueError(
                "prefill_engine must be a PrefillEngine (it exports "
                "handoff records instead of decoding)")
        if not hasattr(decode_engine, "admit_handoff"):
            raise ValueError(
                "decode_engine must be a DecodeEngine (it adopts handoff "
                "records through the _admit_swapped path)")
        if force_route not in (None, "prefill", "colocated"):
            raise ValueError(
                "force_route must be None, 'prefill' or 'colocated', "
                f"got {force_route!r}")
        self._lock = threading.Lock()
        # the coordinator begins one managed trace per accepted request
        # (id = coordinator rid) and hands it to whichever engine owns the
        # request; GenerationServer attaches its tracer here
        self.tracer = tracer
        self.prefill = prefill_engine
        self.decode = decode_engine
        # the bound covers the whole pipeline, not only untaken records
        self.prefill.handoff_backlog = self._inflight_locked
        self.handoff_gbps = float(handoff_gbps)
        self.handoff_chip_flops = handoff_chip_flops
        self.force_route = force_route
        self._requests: Dict[int, _DisaggRequest] = {}
        self._prefill_rids: Dict[int, int] = {}   # local -> rid
        self._decode_rids: Dict[int, int] = {}
        self._handoffs: deque = deque()   # (rec, freq) awaiting ship
        self._degraded: deque = deque()   # (src, freq) awaiting room
        self._stream: List = []
        self._finished: List[Request] = []
        self._next_rid = 0
        self._now = time.monotonic        # seam: tests pin the clock
        self.routed = {"prefill": 0, "colocated": 0}
        self.handoffs_shipped = 0
        self.handoff_pages = 0
        self.handoff_bytes = 0
        self.handoff_wall_s = 0.0
        self.colocated_fallbacks = 0
        # the decode engine's step wall on the last tick (0.0 when it did
        # not step): the decode-step latency during admission waves
        self.last_decode_step_s = 0.0
        if metrics_registry is False:
            self.metrics = None
        else:
            if metrics_registry is None:
                # the engines' registry: one aggregated /metrics
                for eng in (self.decode, self.prefill):
                    m = eng.metrics
                    if m is not None:
                        metrics_registry = m.registry
                        if metrics_ring is None:
                            metrics_ring = m.ring
                        break
            self.metrics = DisaggMetrics(
                metrics_registry if metrics_registry is not None
                else MetricsRegistry(), ring=metrics_ring)
        self._update_gauges_locked()

    # -- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               stop_sequences=None,
               deadline_s: Optional[float] = None,
               priority: str = "normal",
               tenant: Optional[str] = None) -> int:
        """Route and queue a request -> the coordinator rid.  The cost model
        picks the lane (long prompts to the prefill engine, short ones
        colocated on the decode engine); a full prefill queue falls back to
        colocated admission.  ``ValueError`` and ``QueueFullError`` come
        from the target engine; ``priority`` and ``tenant`` ride to it."""
        with self._lock:
            return self._submit_locked(prompt, max_new_tokens,
                                       stop_sequences, deadline_s,
                                       priority, tenant)

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it lives: on either engine (retired at
        its next step) or in the hand-off queue (its record reclaimed now).
        False for an unknown or finished rid."""
        with self._lock:
            freq = self._requests.get(rid)
            if freq is None:
                return False
            freq.cancelled = True
            if freq.where == "prefill":
                # it may have been exported this tick (record not yet
                # taken): the mark catches it at the ship
                return self.prefill.cancel(freq.local) or True
            if freq.where == "decode":
                return self.decode.cancel(freq.local) or True
            src = None
            for i, (rec, f) in enumerate(self._handoffs):
                if f is freq:
                    del self._handoffs[i]
                    rec.discard()
                    src = rec.request
                    break
            for r, f in self._degraded:
                if f is freq:
                    src = r
            self._degraded = deque(
                (r, f) for r, f in self._degraded if f is not freq)
            self._finish_synth_locked(freq, "cancelled", None, src=src)
            return True

    def finished(self) -> List[Request]:
        with self._lock:
            out, self._finished = self._finished, []
            return out

    def drain_stream(self) -> List:
        with self._lock:
            out, self._stream = self._stream, []
            return out

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.prefill.has_work() or self.decode.has_work()
                        or self._handoffs or self._degraded
                        or self._finished)

    def step(self) -> int:
        """One pipeline tick -> the active decode slots."""
        with self._lock:
            return self._step_locked()

    def run_to_completion(self, max_steps: int = 10_000):
        return _drive_to_completion(self, max_steps)

    # -- what a serving front reads ---------------------------------------
    def queue_capacity_reason(
            self, prompt_len: int = 0, factor: float = 1.0,
            priority: Optional[str] = None) -> Optional[str]:
        """Readiness in the routing decision's terms: a prompt routed to
        the prefill lane is accepted while either lane has room (a full
        prefill queue falls back to colocated admission); a colocated one
        answers for the decode engine alone."""
        with self._lock:
            if self._route_prefill_locked(prompt_len):
                if self.prefill.queue_capacity_reason(
                        prompt_len, factor=factor,
                        priority=priority) is None:
                    return None
            return self.decode.queue_capacity_reason(
                prompt_len, factor=factor, priority=priority)

    def queued_tokens(self) -> int:
        return self.prefill.queued_tokens() + self.decode.queued_tokens()

    def retry_after_s(self) -> float:
        return min(self.prefill.retry_after_s(),
                   self.decode.retry_after_s())

    @property
    def cache(self):
        """The decode engine's cache (the pool whose free pages a front's
        ``/health`` watches; the prefill pool recycles within a wave)."""
        return self.decode.cache

    @property
    def _active(self):
        return self.decode._active

    @property
    def _queue(self):
        return list(self.prefill._queue) + list(self.decode._queue)

    def _sum(self, attr: str) -> int:
        return getattr(self.prefill, attr) + getattr(self.decode, attr)

    requests_cancelled = property(lambda s: s._sum("requests_cancelled"))
    requests_expired = property(lambda s: s._sum("requests_expired"))
    requests_rejected = property(lambda s: s._sum("requests_rejected"))
    requests_faulted = property(lambda s: s._sum("requests_faulted"))
    requests_finished = property(lambda s: s._sum("requests_finished"))
    step_faults = property(lambda s: s._sum("step_faults"))
    tokens_generated = property(lambda s: s._sum("tokens_generated"))
    prefill_calls = property(lambda s: s._sum("prefill_calls"))
    preemptions = property(lambda s: s._sum("preemptions"))
    prefill_tokens_avoided = property(
        lambda s: s._sum("prefill_tokens_avoided"))
    host_syncs = property(lambda s: s._sum("host_syncs"))
    pipeline_flushes = property(lambda s: s._sum("pipeline_flushes"))

    @property
    def decode_steps(self):
        return self.decode.decode_steps

    # -- locked internals (caller holds _lock) ----------------------------
    def _inflight_locked(self) -> int:
        """Hand-offs anywhere in the pipeline: exported and untaken,
        awaiting ship or fallback, adopted and not yet admitted.  Also the
        prefill engine's backlog seam (it steps under this lock)."""
        return (len(self.prefill._handoff_ready)
                + len(self._handoffs) + len(self._degraded)
                + self.decode.pending_handoffs())

    def _route_prefill_locked(self, prompt_len: int) -> bool:
        """The cost model's verdict (pure: a decision is counted only once
        a placement lands)."""
        if self.force_route is not None:
            return self.force_route == "prefill"
        return handoff_wins(prompt_len, self.decode, self.handoff_gbps,
                            self.handoff_chip_flops)

    def _count_placement_locked(self, disagg: bool) -> None:
        self.routed["prefill" if disagg else "colocated"] += 1
        if self.metrics is not None:
            (self.metrics.routed_prefill if disagg
             else self.metrics.routed_colocated).inc()

    def _submit_locked(self, prompt, max_new_tokens, stop_sequences,
                       deadline_s, priority="normal", tenant=None) -> int:
        prompt = np.asarray(prompt, np.int64)
        disagg = self._route_prefill_locked(len(prompt))
        if disagg:
            dc = self.decode.cache
            row_cap = min(dc.pages_max, dc.num_pages - 1) * dc.page
            if len(prompt) + int(max_new_tokens) > row_cap:
                # the decode pool can never hold the whole generation:
                # colocated, so submit()'s ValueError refuses it up front
                disagg = False
        target = self.prefill if disagg else self.decode
        # nothing fallible may run between the engine accepting the request
        # and the rid tables mapping it: the clock read and the trace come
        # first, the decision counter after the commit
        now = self._now()
        ctx = None
        if self.tracer is not None:
            ctx = self.tracer.begin_trace(
                str(self._next_rid), managed=True, prompt_len=len(prompt),
                lane="prefill" if disagg else "colocated")
            ctx.default_attrs["engine"] = "prefill" if disagg else "decode"
        kw = dict(max_new_tokens=max_new_tokens,
                  stop_sequences=stop_sequences, deadline_s=deadline_s,
                  trace=ctx, priority=priority, tenant=tenant)
        try:
            try:
                local = target.submit(prompt, **kw)
            except QueueFullError:
                if not disagg:
                    raise
                # the prefill lane's queue is full: colocation beats
                # shedding while the decode engine has room
                disagg = False
                target = self.decode
                if ctx is not None:
                    ctx.default_attrs["engine"] = "decode"
                    ctx.event("prefill_lane_full_fallback")
                    ctx.tracer.annotate(ctx.trace_id, lane="colocated")
                local = target.submit(prompt, **kw)
        except BaseException:
            if ctx is not None:
                ctx.close(status="rejected",
                          error="submit refused (validation or "
                                "backpressure)")
            raise
        freq = _DisaggRequest(
            self._next_rid, prompt, int(max_new_tokens), stop_sequences,
            0.0 if deadline_s is None else now + float(deadline_s), now,
            where="prefill" if disagg else "decode", local=local,
            trace=ctx)
        self._next_rid += 1
        self._requests[freq.rid] = freq
        if disagg:
            self._prefill_rids[local] = freq.rid
        else:
            self._decode_rids[local] = freq.rid
        self._count_placement_locked(disagg)
        return freq.rid

    def _step_locked(self) -> int:
        now = self._now()
        self.last_decode_step_s = 0.0
        # 1. ship wave k (and retry degraded fallbacks waiting for room)
        self._ship_locked(now)
        # 2. prefill wave k+1 (its exports stage under the dispatch)
        if self.prefill.has_work():
            self.prefill.step()
        # 3. take the new records; they ship next tick, after their staged
        # copies have ridden under the decode step below and the next wave
        for rec in self.prefill.take_handoffs():
            rid = self._prefill_rids.pop(rec.request.rid, None)
            if rid is None:               # already triaged away
                rec.discard()
                continue
            freq = self._requests[rid]
            freq.where, freq.local = "handoff", -1
            self._handoffs.append((rec, freq))
        # only requests that finished on the prefill engine keep a rid
        # mapping there (eos at the first token, cancels, errors); a taken
        # record's first token streams at the decode side's admission
        for local, tok in self.prefill.drain_stream():
            rid = self._prefill_rids.get(local)
            if rid is not None:
                self._stream.append((rid, tok))
        for req in self.prefill.finished():
            rid = self._prefill_rids.pop(req.rid, None)
            if rid is None:
                continue
            freq = self._requests.pop(rid, None)
            req.rid = rid
            self._close_trace_locked(freq, req)
            self._finished.append(req)
        # 4. decode: restore wave k (zero prefill tokens), one decode round
        active = 0
        if self.decode.has_work():
            t0 = time.perf_counter()
            self.decode.step()
            self.last_decode_step_s = time.perf_counter() - t0
            active = len(self.decode._active)
        for local, tok in self.decode.drain_stream():
            rid = self._decode_rids.get(local)
            if rid is not None:
                self._stream.append((rid, tok))
        for req in self.decode.finished():
            rid = self._decode_rids.pop(req.rid, None)
            if rid is None:
                continue
            freq = self._requests.pop(rid, None)
            req.rid = rid
            self._close_trace_locked(freq, req)
            self._finished.append(req)
        self._update_gauges_locked()
        return active

    def _close_trace_locked(self, freq: Optional[_DisaggRequest],
                            req: Request) -> None:
        """Seal the coordinator's trace once the request surfaces with its
        final status (the engine reported its phase spans at
        retirement)."""
        if freq is None or freq.trace is None:
            return
        try:
            freq.trace.close(status=req.status, error=req.error,
                             tokens=len(req.generated),
                             clocks=phase_clocks(req))
        except Exception:
            pass

    def _ship_locked(self, now: float) -> None:
        # degraded fallbacks first: they are the oldest, and only room in
        # the decode queue gates them
        retry: deque = deque()
        while self._degraded:
            src, freq = self._degraded.popleft()
            if freq.cancelled:
                self._finish_synth_locked(freq, "cancelled", None, src=src)
                continue
            if freq.deadline and now >= freq.deadline:
                self._finish_synth_locked(freq, "expired", None, src=src)
                continue
            try:
                local = self.decode.admit_degraded(src)
            except QueueFullError:
                retry.append((src, freq))
                continue
            except ValueError as e:
                # the decode cache can never hold it: an honest error
                # rather than a wedged queue head
                self._finish_synth_locked(freq, "error", str(e))
                continue
            self._commit_decode_locked(freq, local)
        self._degraded = retry
        keep: deque = deque()
        while self._handoffs:
            rec, freq = self._handoffs.popleft()
            if freq.cancelled:
                rec.discard()
                self._finish_synth_locked(freq, "cancelled", None,
                                          src=rec.request)
                continue
            if freq.deadline and now >= freq.deadline:
                rec.discard()
                self._finish_synth_locked(freq, "expired", None,
                                          src=rec.request)
                continue
            t0 = time.perf_counter()
            try:
                rec.materialize()                       # the ship half
                local = self.decode.admit_handoff(rec)  # the restore half
            except QueueFullError:
                keep.append((rec, freq))   # backpressure: retry next tick
                continue
            except Exception:
                # a ship or restore fault, or a full receiving host tier:
                # a colocated re-prefill that keeps the first token
                self._degrade_locked(rec, freq)
                continue
            dt = time.perf_counter() - t0
            # the commit first: the placement reaches the rid table before
            # anything fallible (span reporting included) runs
            self._commit_decode_locked(freq, local)
            self.handoffs_shipped += 1
            self.handoff_pages += rec.pages
            self.handoff_bytes += rec.nbytes
            self.handoff_wall_s += dt
            if freq.trace is not None:
                t1 = time.monotonic()
                freq.trace.span("handoff_ship", t1 - dt, t1,
                                pages=rec.pages, bytes=rec.nbytes)
                freq.trace.default_attrs["engine"] = "decode"
            if self.metrics is not None:
                m = self.metrics
                m.handoff_pages.inc(rec.pages)
                m.handoff_bytes.inc(rec.nbytes)
                m.handoff_seconds.observe(dt)
        self._handoffs = keep

    def _commit_decode_locked(self, freq: _DisaggRequest,
                              local: int) -> None:
        freq.where, freq.local = "decode", local
        self._decode_rids[local] = freq.rid

    def _degrade_locked(self, rec: HandoffRecord,
                        freq: _DisaggRequest) -> None:
        rec.discard()
        self.colocated_fallbacks += 1
        if freq.trace is not None:
            freq.trace.event("handoff_degraded")
            freq.trace.default_attrs["engine"] = "decode"
        if self.metrics is not None:
            self.metrics.colocated_fallback.inc()
            self.metrics.ring.emit("kv_handoff_fallback", rid=freq.rid)
        try:
            local = self.decode.admit_degraded(rec.request)
        except QueueFullError:
            self._degraded.append((rec.request, freq))
            return
        except ValueError as e:
            self._finish_synth_locked(freq, "error", str(e))
            return
        self._commit_decode_locked(freq, local)

    def _finish_synth_locked(self, freq: _DisaggRequest, status: str,
                             error: Optional[str],
                             src: Optional[Request] = None) -> None:
        """The terminal message of a request neither engine owns any more
        (cancelled or expired in the hand-off queue): the client always
        gets a status.  ``src``, the engine-side request a record carried,
        reports its phase intervals into the trace before the close."""
        self._requests.pop(freq.rid, None)
        req = Request(freq.rid, freq.prompt, freq.max_new_tokens,
                      stop_sequences=freq.stop_sequences,
                      t_submit=freq.t_submit)
        req.done = True
        req.status = status
        req.error = error
        req.t_finish = self._now()
        if freq.trace is not None:
            if src is not None:
                finalize_request_trace(freq.trace, src, status=status,
                                       error=error)
            else:
                try:
                    freq.trace.close(status=status, error=error)
                except Exception:
                    pass
        self._finished.append(req)

    def _update_gauges_locked(self) -> None:
        if self.metrics is not None:
            self.metrics.handoff_inflight.set(self._inflight_locked())
